"""The port's native bulk decoder (``torchpiv_tpu_torch/native``): its
``read_batch_gray`` against the JAX package's and against the port's
Python decoder, bit for bit, on every format it takes (8-bit palette BMP,
TIFF at 8 and 16 bits in both byte orders and several strips, PGM P5 at 8
and 16 bits), at 1 and 4 threads, into a new array and into a caller's;
corrupt, truncated and foreign-shaped files; ``write_table`` against
``np.savetxt``; ``PIVDataset.read_batch`` against the JAX dataset's skip
semantics; ``PairPrefetcher`` with and without the native decoder; where
the library is built.  All on the CPU; the pinned staging of a CUDA target
is held on the card by ``chip_smoke.py``."""
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from torchpiv_tpu.io.dataset import PIVDataset as JaxDataset
from torchpiv_tpu.native import loader as jax_native
from torchpiv_tpu_torch.io.dataset import PIVDataset
from torchpiv_tpu_torch.io.decode import encode_bmp_gray8, imread_gray, imwrite_gray
from torchpiv_tpu_torch.io.prefetch import PairPrefetcher
from torchpiv_tpu_torch.native import loader as native

H, W = 24, 40


def _tiff(img: np.ndarray, big_endian: bool, rows_per_strip: int) -> bytes:
    """An uncompressed grayscale TIFF of ``img`` (uint8 or uint16), its
    strips of ``rows_per_strip`` rows stored after the header, the IFD and
    the strip tables after them."""
    e = ">" if big_endian else "<"
    h, w = img.shape
    bps = img.dtype.itemsize * 8
    data = img.astype(e + ("u2" if bps == 16 else "u1")).tobytes()
    n_strips = -(-h // rows_per_strip)
    row_bytes = w * img.dtype.itemsize
    offs = [8 + i * rows_per_strip * row_bytes for i in range(n_strips)]
    counts = [min(rows_per_strip, h - i * rows_per_strip) * row_bytes
              for i in range(n_strips)]
    n_entries = 9
    ifd = 8 + len(data)
    tables = ifd + 2 + 12 * n_entries + 4

    def entry(tag, typ, count, value):
        return struct.pack(e + "HHI", tag, typ, count) + value

    def short(v):
        return struct.pack(e + "HH", v, 0)

    def table(i):  # strip offsets (i = 0) or counts (i = 1)
        if n_strips == 1:
            return struct.pack(e + "I", (offs, counts)[i][0])
        return struct.pack(e + "I", tables + 4 * n_strips * i)

    entries = [entry(256, 3, 1, short(w)), entry(257, 3, 1, short(h)),
               entry(258, 3, 1, short(bps)), entry(259, 3, 1, short(1)),
               entry(262, 3, 1, short(1)), entry(273, 4, n_strips, table(0)),
               entry(277, 3, 1, short(1)), entry(278, 3, 1, short(rows_per_strip)),
               entry(279, 4, n_strips, table(1))]
    out = (b"MM\x00\x2a" if big_endian else b"II\x2a\x00") + struct.pack(e + "I", ifd)
    out += data + struct.pack(e + "H", n_entries) + b"".join(entries)
    out += struct.pack(e + "I", 0)
    if n_strips > 1:
        out += b"".join(struct.pack(e + "I", o) for o in offs)
        out += b"".join(struct.pack(e + "I", c) for c in counts)
    return out


def _pgm(img: np.ndarray) -> bytes:
    maxval = 65535 if img.dtype == np.uint16 else 255
    head = f"P5\n# a comment\n{img.shape[1]} {img.shape[0]}\n{maxval}\n".encode()
    return head + img.astype(">u2" if maxval > 255 else "u1").tobytes()


def _palette_bmp(img: np.ndarray, ramp: np.ndarray) -> bytes:
    """An 8-bit BMP of ``img`` whose grey palette is ``ramp`` (not the
    identity): the decoders apply the ramp."""
    raw = bytearray(encode_bmp_gray8(img))
    pal = np.repeat(ramp.astype(np.uint8), 4).reshape(256, 4)
    pal[:, 3] = 0
    raw[54:54 + 1024] = pal.tobytes()
    return bytes(raw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``{name: (path, expected uint8 frame)}`` of every format."""
    d = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(7)
    out = {}

    def put(name, data, want):
        p = d / name
        p.write_bytes(data)
        out[name] = (str(p), want)

    img8 = rng.integers(0, 256, (H, W), dtype=np.uint8)
    img16 = rng.integers(0, 65536, (H, W), dtype=np.uint16)
    hi = (img16 >> 8).astype(np.uint8)
    put("identity.bmp", encode_bmp_gray8(img8), img8)
    ramp = (255 - np.arange(256)).astype(np.uint8)
    put("ramp.bmp", _palette_bmp(img8, ramp), ramp[img8])
    for endian in ("le", "be"):
        for rows in (H, 5):
            big = endian == "be"
            put(f"t8_{endian}_{rows}.tif", _tiff(img8, big, rows), img8)
            put(f"t16_{endian}_{rows}.tif", _tiff(img16, big, rows), hi)
    put("g8.pgm", _pgm(img8), img8)
    put("g16.pgm", _pgm(img16), hi)
    return out


def test_the_library_is_built_into_the_ports_build_directory():
    assert native.available()
    path = native.library_path()
    root = Path(native.__file__).resolve().parents[1] / "_build"
    assert path.parent == root and path.name.startswith("libfastio-")
    assert not (Path(native.__file__).parent / "libfastio.so").exists()


def test_probe_gray_reads_every_format(files):
    for name, (path, want) in files.items():
        assert native.probe_gray(path) == want.shape, name
        assert native.probe_gray(path) == jax_native.probe_gray(path), name


@pytest.mark.parametrize("into", [False, True], ids=["new", "out"])
@pytest.mark.parametrize("threads", [1, 4])
def test_read_batch_gray_matches_jax_and_python(files, threads, into):
    names = sorted(files)
    paths = [files[n][0] for n in names]
    out = np.full((len(paths), H, W), 77, np.uint8) if into else None
    got, status = native.read_batch_gray(paths, (H, W), threads=threads, out=out)
    want, jstatus = jax_native.read_batch_gray(paths, (H, W), threads=threads)
    assert (status == 0).all() and (jstatus == 0).all()
    if into:
        assert got is out
    assert got.dtype == np.uint8 and got.shape == (len(paths), H, W)
    np.testing.assert_array_equal(got, want)
    for i, name in enumerate(names):
        np.testing.assert_array_equal(got[i], files[name][1], err_msg=name)
        np.testing.assert_array_equal(got[i], imread_gray(paths[i]), err_msg=name)


def test_read_batch_gray_refuses_a_wrong_buffer(files):
    paths = [files["identity.bmp"][0]] * 2
    for bad in (np.zeros((2, H, W), np.int16), np.zeros((3, H, W), np.uint8),
                np.zeros((2, W, H), np.uint8).transpose(0, 2, 1)):
        with pytest.raises(ValueError, match="out must be"):
            native.read_batch_gray(paths, (H, W), out=bad)


def _corrupt_files(d: Path, files) -> list:
    good = Path(files["identity.bmp"][0]).read_bytes()
    tif = Path(files["t8_le_5.tif"][0]).read_bytes()
    bad = {"truncated.bmp": good[: len(good) // 2],
           "truncated.tif": tif[: len(tif) // 3],
           "junk.bmp": b"BM" + b"\x01" * 40,
           "empty.pgm": b"",
           "short.pgm": _pgm(np.zeros((H, W), np.uint8))[:-7]}
    hacked = bytearray(good)
    hacked[14:18] = (2 ** 31 - 1).to_bytes(4, "little")  # palette out of bounds
    bad["dib.bmp"] = bytes(hacked)
    paths = []
    for name, data in bad.items():
        (d / name).write_bytes(data)
        paths.append(str(d / name))
    paths.append(str(d / "missing.bmp"))
    other = d / "other_shape.bmp"
    imwrite_gray(str(other), np.zeros((H + 2, W), np.uint8))
    paths.append(str(other))
    return paths


def test_unreadable_files_fail_by_status(files, tmp_path):
    bad = _corrupt_files(tmp_path, files)
    paths = [files["identity.bmp"][0]] + bad
    _, status = native.read_batch_gray(paths, (H, W), threads=3)
    _, jstatus = jax_native.read_batch_gray(paths, (H, W), threads=3)
    assert status[0] == 0 and (status[1:] != 0).all()
    np.testing.assert_array_equal(status, jstatus)


def _pair_folder(d: Path, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    frames = []
    d.mkdir()
    for i in range(n):
        for tag in "ab":
            img = rng.integers(0, 256, (H, W), dtype=np.uint8)
            imwrite_gray(str(d / f"p{i}_{tag}.bmp"), img)
            frames.append(img)
    return frames


@pytest.mark.parametrize("threads", [1, 4])
def test_dataset_read_batch_matches_jax(tmp_path, threads):
    d = tmp_path / "pairs"
    frames = _pair_folder(d, 5, seed=3)
    ours, theirs = PIVDataset(str(d), ".bmp"), JaxDataset(str(d), ".bmp")
    assert ours.native_shape == (H, W) == theirs._native_shape
    for idx in ([0, 1, 2, 3], [4], [1, 3]):
        ids, a, b = ours.read_batch(idx, threads=threads)
        jids, ja, jb = theirs.read_batch(idx, threads=threads)
        assert ids == jids == idx
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(a, np.stack([frames[2 * i] for i in idx]))
        np.testing.assert_array_equal(b, np.stack([frames[2 * i + 1] for i in idx]))
    out = np.zeros((8, H, W), np.uint8)
    ids, a, b = ours.read_batch([0, 1, 2, 3], threads=threads, out=out)
    assert a.base is out or np.shares_memory(a, out)
    np.testing.assert_array_equal(out[:4], a)
    np.testing.assert_array_equal(out[4:], b)


def test_dataset_drops_unreadable_pairs_as_jax_does(tmp_path):
    d = tmp_path / "pairs"
    _pair_folder(d, 5, seed=4)
    (d / "p1_b.bmp").write_bytes((d / "p1_b.bmp").read_bytes()[:500])  # truncated
    (d / "p3_a.bmp").write_bytes(b"BM" + b"\x00" * 60)  # corrupt
    imwrite_gray(str(d / "p4_b.bmp"), np.zeros((H, W + 4), np.uint8))  # another shape
    ours, theirs = PIVDataset(str(d), ".bmp"), JaxDataset(str(d), ".bmp")
    for idx in ([0, 1, 2, 3, 4], [1, 3], [1], [2, 4]):
        got, want = ours.read_batch(idx), theirs.read_batch(idx)
        assert got[0] == want[0], idx
        if want[0]:
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        else:
            assert got[1] is None and got[2] is None
    assert ours.read_batch([0, 1, 2, 3, 4])[0] == [0, 2]
    with pytest.raises(ValueError, match="native"):
        python = PIVDataset(str(d), ".bmp")
        python.native_shape = None
        python.read_batch([0], out=np.zeros((2, H, W), np.uint8))


def test_write_table_is_byte_identical_to_savetxt(tmp_path):
    rng = np.random.default_rng(0)
    arr = np.concatenate([
        rng.normal(0, 100, (500, 4)), rng.normal(0, 1e-6, (50, 4)),
        np.array([[0.0, -0.0, 1e-7, -1e-7],
                  [np.inf, -np.inf, np.nan, 123456789.123456789],
                  [0.0000005, -0.0000005, 2.5e-7, 1.5]])])
    hdr = "x[mm], y[mm], Vx[m/s], Vy[m/s]"
    ours, theirs = tmp_path / "native.txt", tmp_path / "numpy.txt"
    native.write_table(str(ours), hdr, arr)
    np.savetxt(str(theirs), arr, delimiter=", ", header=hdr, comments="", fmt="%.6f")
    assert ours.read_bytes() == theirs.read_bytes()
    with pytest.raises(OSError):
        native.write_table(str(tmp_path / "no_dir" / "x.txt"), hdr, arr)
    with pytest.raises(ValueError):
        native.write_table(str(ours), hdr, arr.ravel())


@pytest.mark.parametrize("threads", [1, 3])
def test_prefetcher_yields_the_same_batches_with_either_decoder(tmp_path, threads):
    d = tmp_path / "pairs"
    _pair_folder(d, 7, seed=5)
    (d / "p2_a.bmp").write_bytes(b"BM" + b"\x00" * 60)  # pair 2 is dropped
    fast = PIVDataset(str(d), ".bmp")
    slow = PIVDataset(str(d), ".bmp")
    slow.native_shape = None
    runs = []
    for ds in (fast, slow):
        pf = PairPrefetcher(ds, 3, torch.device("cpu"), num_threads=threads,
                            first_batch_size=2, spans=True)
        runs.append([(ids, a.clone(), b.clone(), span["pin_s"])
                     for a, b, ids, span in pf.batches()])
    assert [r[0] for r in runs[0]] == [r[0] for r in runs[1]] == [[0, 1], [3, 4], [5, 6]]
    for (_, a, b, pin), (_, sa, sb, _) in zip(*runs):
        assert a.dtype == torch.uint8 and pin == 0.0
        assert torch.equal(a, sa) and torch.equal(b, sb)
