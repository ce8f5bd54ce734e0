"""The port's copies of the JAX package's host modules, each equal to its
original on the same inputs: ``utils/config.py`` (``PIVParams``),
``utils/persistence.py`` (every writer byte for byte, the readers and the
filename helpers), ``stats/smoothing.py``, ``io/watch.py``,
``io/video.py`` and ``client.py``."""
import dataclasses
import json
import types

import numpy as np
import pytest

from torchpiv_tpu import client as jax_client
from torchpiv_tpu.io import video as jax_video
from torchpiv_tpu.io import watch as jax_watch
from torchpiv_tpu.stats import smoothing as jax_smoothing
from torchpiv_tpu.utils import config as jax_config
from torchpiv_tpu.utils import persistence as jax_persistence
from torchpiv_tpu_torch import client
from torchpiv_tpu_torch.io import video, watch
from torchpiv_tpu_torch.stats import smoothing
from torchpiv_tpu_torch.utils import config, persistence
from torchpiv_tpu_torch.utils.synthetic import particle_pair


def _field(seed, shape=(12, 15)):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:shape[0], :shape[1]]
    u = np.sin(x / 4.0) + 0.3 * np.cos(y / 3.0) + 0.05 * rng.standard_normal(shape)
    u[rng.random(shape) < 0.05] = np.nan  # missing vectors
    u[3, 4] += 6.0  # an outlier the robust fit must resist
    return u


def test_piv_params_equal_but_the_device():
    port, jax = config.PIVParams(), jax_config.PIVParams()
    assert port.device == "auto" and jax.device == "tpu"
    assert dataclasses.asdict(dataclasses.replace(port, device="tpu")) == \
        dataclasses.asdict(jax)


def test_persistence_helpers_equal(tmp_path):
    names = ["img10_a.bmp", "img2_b.bmp", "img2_a.bmp", "x", "run_pair (3).npy",
             "run_pair.npy", "run_pair (10).npy", "a1b22c3"]
    for key in ("natural_keys", "saved_series_key"):
        assert sorted(names, key=getattr(persistence, key)) == \
            sorted(names, key=getattr(jax_persistence, key))
    (tmp_path / "f.txt").write_text("")
    (tmp_path / "f (1).txt").write_text("")
    assert persistence.uniquify(str(tmp_path / "f.txt")) == \
        jax_persistence.uniquify(str(tmp_path / "f.txt"))
    for horizontal in (True, False):
        assert persistence.make_name("/a/run/", "Vx[m/s]", horizontal) == \
            jax_persistence.make_name("/a/run/", "Vx[m/s]", horizontal)
    col = np.tile(np.arange(7.0), 5)
    assert persistence.find_grid(col) == jax_persistence.find_grid(col) == 7
    data = {"a": np.arange(21.0), "b": -np.arange(21.0)}
    for k, v in persistence.reshape_data(data, 7).items():
        np.testing.assert_array_equal(v, jax_persistence.reshape_data(data, 7)[k])


def _writers():
    """(name, call) of every field writer, each taking its module."""
    rng = np.random.default_rng(4)
    x, y = np.meshgrid(np.arange(5.0) * 0.4, np.arange(4.0) * 0.4)
    u, v = rng.standard_normal((2, 4, 5))
    u[1, 2] = np.nan
    table = {"x[mm]": x, "y[mm]": y, "Vx[m/s]": u, "Vy[m/s]": v}
    tracks = [types.SimpleNamespace(frames=[0, 1, 2], x=[1.0, 2.5, 4.0],
                                    y=[3.0, 3.5, 4.0]),
              types.SimpleNamespace(frames=[1, 2], x=[7.0, 7.5], y=[1.0, 0.0])]
    return [
        ("table.txt", lambda m, d: m.save_table("table.txt", d, table)),
        ("stack.npy", lambda m, d: m.save_binary("stack.npy", d, table)),
        ("field.vtk", lambda m, d: m.save_vtk("field.vtk", d, x, y, u, v,
                                              scalars={"w [1/s]": u * v})),
        ("tracks.vtk", lambda m, d: m.save_vtk_tracks("tracks.vtk", d, tracks,
                                                      scale=0.5, frame_height=64)),
        ("field.mat", lambda m, d: m.save_mat("field.mat", d, x, y, u, v,
                                              scalars={"1w": u})),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _writers()])
def test_persistence_writers_write_the_same_bytes(tmp_path, name):
    call = dict(_writers())[name]
    got = call(persistence, str(tmp_path / "port"))
    want = call(jax_persistence, str(tmp_path / "jax"))
    with open(got, "rb") as f, open(want, "rb") as g:
        a, b = f.read(), g.read()
    if name.endswith(".mat"):  # the header carries the time of writing
        a, b = a[128:], b[128:]
    assert a == b
    if name == "table.txt":
        for k, col in persistence.load_table(got).items():
            np.testing.assert_array_equal(col, jax_persistence.load_table(want)[k])


def test_hdf5_writer_writes_the_same_fields(tmp_path):
    import h5py

    x, y = np.meshgrid(np.arange(5.0), np.arange(4.0))
    u, v = x * 0.5, -y
    paths = [m.save_hdf5("f.h5", str(tmp_path / n), x, y, u, v,
                         scalars={"w": u + v}, attrs={"dt": 2.0})
             for n, m in (("port", persistence), ("jax", jax_persistence))]
    with h5py.File(paths[0]) as f, h5py.File(paths[1]) as g:
        for key in ("x", "y", "u", "v", "derived/w"):
            np.testing.assert_array_equal(f[key][()], g[key][()])
        assert dict(f.attrs) == dict(g.attrs)


@pytest.mark.parametrize("kw", [dict(), dict(s=3.0), dict(robust=True),
                                dict(s=0.5, robust=True, mask="edge")])
def test_smooth_field_equal(kw):
    kw = dict(kw)
    y = _field(1)
    if kw.get("mask") == "edge":
        kw["mask"] = np.zeros(y.shape, bool)
        kw["mask"][:, 0] = True
    z, s = smoothing.smooth_field(y, **kw)
    zj, sj = jax_smoothing.smooth_field(y, **kw)
    np.testing.assert_array_equal(z, zj)
    assert s == sj


@pytest.mark.parametrize("s", [None, 2.0])
def test_smooth_vector_field_equal(s):
    u, v = _field(2), _field(3).T[:12, :15]
    for a, b in zip(smoothing.smooth_vector_field(u, v, s=s),
                    jax_smoothing.smooth_vector_field(u, v, s=s)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("names", [
    ["p1_a.bmp", "p1_b.bmp", "p2_a.bmp", "p2_b.bmp"],
    ["p1_a.bmp", "p1_b.bmp", "p2_a.bmp"],
    ["p0_b.bmp", "p1_a.bmp", "p1_b.bmp", "p2_a.bmp"],
    ["p0_b.bmp", "p1_a.bmp", "p1_b.bmp"],
    ["q.bmp", "r.bmp"],
    [],
])
def test_watchman_pairs_like_the_original(tmp_path, names):
    port, jax = (m.WatchMan(str(tmp_path), ".bmp") for m in (watch, jax_watch))
    files = [str(tmp_path / n) for n in names]
    port.set_image_pairs(list(files))
    jax.set_image_pairs(list(files))
    assert port.img_pairs == jax.img_pairs


def test_streaming_source_polls_like_the_original(tmp_path):
    """The same listings, poll by poll: out-of-order frames, an unsuffixed
    file, a late mate."""
    port, jax = (m.StreamingPairSource(str(tmp_path), ".bmp", poll_interval=0.01)
                 for m in (watch, jax_watch))
    for step in (["c2_b.bmp", "c1_a.bmp"], ["c1_b.bmp", "junk.bmp", "c2_a.bmp"],
                 ["c3_a.bmp"], ["c3_b.bmp", "c4_a.bmp", "c4_b.bmp"]):
        for n in step:
            (tmp_path / n).write_bytes(b"")
        assert port.ready() == jax.ready()
        assert port._pending == jax._pending


@pytest.fixture(scope="module")
def avi(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("video") / "v.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48), False)
    for i in range(5):
        wr.write(particle_pair((48, 64), (1.0, 0.0), seed=i)[0])
    wr.release()
    return path


@pytest.mark.parametrize("mode,max_pairs", [("pairs", None), ("sequential", None),
                                            ("sequential", 3)])
def test_video_source_reads_like_the_original(avi, mode, max_pairs):
    port = video.VideoPairSource(avi, mode, max_pairs)
    jax = jax_video.VideoPairSource(avi, mode, max_pairs)
    assert port.frame_shape == jax.frame_shape == (48, 64)
    assert len(port) == len(jax)
    pairs, jax_pairs = list(port), list(jax)
    assert len(pairs) == len(jax_pairs) == len(port)
    for (a, b), (c, d) in zip(pairs, jax_pairs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_video_source_errors_like_the_original(tmp_path):
    for m in (video, jax_video):
        with pytest.raises(OSError):
            m.VideoPairSource(str(tmp_path / "missing.avi"))
        with pytest.raises(ValueError, match="folder_mode"):
            m.VideoPairSource(str(tmp_path / "missing.avi"), "triples")


def test_client_wire_helpers_equal():
    arrays = dict(a=np.arange(6, dtype=np.uint8).reshape(2, 3), b=np.ones((2, 3)))
    assert client._npz_bytes(**arrays) == jax_client._npz_bytes(**arrays)
    body = client._npz_bytes(u=np.arange(4.0), invalid=np.zeros(4, bool))
    got = client.PIVClient._decode_response(200, body)
    want = jax_client.PIVClient._decode_response(200, body)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert client.PIVClient._decode_response(422, b"{}") is None
    assert jax_client.PIVClient._decode_response(422, b"{}") is None
    for status, data in ((400, json.dumps({"error": "bad"}).encode()),
                         (500, b"not json")):
        messages = []
        for cls, err in ((client.PIVClient, client.PIVServerError),
                         (jax_client.PIVClient, jax_client.PIVServerError)):
            with pytest.raises(err) as ei:
                cls._decode_response(status, data)
            messages.append((str(ei.value), ei.value.status))
        assert messages[0] == messages[1]
    c, j = client.PIVClient("http://h:1/", 5.0), jax_client.PIVClient("http://h:1/", 5.0)
    assert (c.base_url, c.timeout) == (j.base_url, j.timeout)
    with pytest.raises(ValueError, match="stacked"):
        c.analyze_burst(arrays["a"], arrays["a"])
