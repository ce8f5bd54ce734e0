"""The port on an NVIDIA card: each CUDA kernel (bilinear and bicubic window
shift, window deformation, fused peak fit) against its plain PyTorch
version, the CUDA engine against the CPU engine, and the kernels' launches
on the OfflinePIV path.  Every test skips without a CUDA
device.  The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: integer shifts are tile copies and must match bit for bit;
fractional bilinear shifts and deformations 1e-4 of a grey level, bicubic
ones 1e-3 (the kernels round every product and sum in the plain version's
order, so equality is expected); peak fit ``u, v`` 1e-5 px with equal masks
(the kernel adds EPS after subtracting the minimum, the plain version
``EPS - min`` in one step); engines within the port's parity budget (< 2%
mask mismatch, RMS < 0.01 px)."""
import numpy as np
import pytest
import torch

from torchpiv_tpu_torch import MultipassPIV, OfflinePIV, PIVConfig
from torchpiv_tpu_torch.io.decode import imwrite_gray
from torchpiv_tpu_torch.kernels.deform import def_windows
from torchpiv_tpu_torch.kernels.peakfit import peakfit
from torchpiv_tpu_torch.kernels.shift import shift_windows, shift_windows_bicubic
from torchpiv_tpu_torch.ops.correlate import correlate_fft
from torchpiv_tpu_torch.ops.deform import def_windows_reference
from torchpiv_tpu_torch.ops.peakfit import correlation_to_displacement
from torchpiv_tpu_torch.ops.shifts import shift_windows_reference
from torchpiv_tpu_torch.ops.windows import extract_windows
from torchpiv_tpu_torch.utils.synthetic import particle_pair, shear_flow

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("shape,w,o", [((256, 320), 32, 16), ((200, 260), 64, 32),
                                       ((300, 300), 128, 64)])
def test_kernel_matches_plain_version(card, shape, w, o, kind):
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(w)
    frames = (torch.rand(3, H, W, generator=g) * 255).to(card)
    vx = torch.rand(3, n, generator=g) * 3 * w - 1.5 * w  # past +-S = w/2
    vy = torch.rand(3, n, generator=g) * 3 * w - 1.5 * w
    if kind == "integer":
        vx, vy = vx.round(), vy.round()
    elif kind == "mixed":
        vx = vx.round()
    vx, vy = vx.to(card), vy.to(card)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    before = shift_windows.launches
    got = shift_windows(frames, vx, vy, **kw)
    want = shift_windows_reference(frames, vx, vy, **kw)
    torch.cuda.synchronize()
    assert shift_windows.launches == before + 1
    if kind == "fractional":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("shape,w,o", [((256, 320), 32, 16), ((200, 260), 64, 32),
                                       ((300, 300), 125, 60)])
def test_bicubic_kernel_matches_plain_version(card, shape, w, o, kind):
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(w + 1)
    frames = (torch.rand(3, H, W, generator=g) * 255).to(card)
    vx = torch.rand(3, n, generator=g) * 3 * w - 1.5 * w  # past +-S = w/2
    vy = torch.rand(3, n, generator=g) * 3 * w - 1.5 * w
    if kind == "integer":
        vx, vy = vx.round(), vy.round()
    elif kind == "mixed":
        vx = vx.round()
    vx, vy = vx.to(card), vy.to(card)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    before = shift_windows_bicubic.launches, shift_windows.launches
    got = shift_windows_bicubic(frames, vx, vy, **kw)
    want = shift_windows_reference(frames, vx, vy, interp="bicubic", **kw)
    torch.cuda.synchronize()
    assert (shift_windows_bicubic.launches, shift_windows.launches) == \
        (before[0] + 1, before[1])
    if kind == "integer":  # weights (0, 1, 0, 0): the integer copy
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["general", "saturating", "integer"])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape,w,o,margin", [
    ((256, 320), 32, 16, 2), ((200, 260), 64, 32, 4), ((300, 300), 120, 60, 2),
    ((256, 256), 33, 16, 1)])  # odd w: integer in-window offsets
def test_def_kernel_matches_plain_version(card, shape, w, o, margin, interp, kind):
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(w + margin)
    frames = (torch.rand(2, H, W, generator=g) * 255).to(card)
    vx = torch.rand(2, n, generator=g) * 3 * w - 1.5 * w  # past +-S = w/2
    vy = torch.rand(2, n, generator=g) * 3 * w - 1.5 * w
    slope = {"general": 0.05, "saturating": 0.6, "integer": 0.0}[kind]
    grads = [((torch.rand(2, n, generator=g) * 2 - 1) * slope).to(card)
             for _ in range(4)]
    if kind == "integer":
        vx, vy = vx.round(), vy.round()
    vx, vy = vx.to(card), vy.to(card)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, margin=margin, interp=interp)
    before = def_windows.launches
    got = def_windows(frames, vx, vy, *grads, **kw)
    want = def_windows_reference(frames, vx, vy, *grads, **kw)
    torch.cuda.synchronize()
    assert def_windows.launches == before + 1
    if kind == "integer":
        assert torch.equal(got, want)
        if interp == "bilinear":  # the shift kernel's integer copy, away from +S
            copy = shift_windows(frames, vx, vy, frame_shape=shape, wind_size=w,
                                 overlap=o)
            inside = (vx < w // 2) & (vy < w // 2)
            assert torch.equal(got[inside], copy[inside])
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 if interp == "bilinear" else 1e-3)


def _correlation_maps(card, w):
    """Real correlation maps of a sheared pair, then constant, edge-peak and
    tied maps."""
    fa, fb = particle_pair((256, 256), shear_flow(1.0, 0.02), seed=w)
    aa = extract_windows(torch.from_numpy(fa)[None].float().to(card), w, w // 2)
    bb = extract_windows(torch.from_numpy(fb)[None].float().to(card), w, w // 2)
    maps = [correlate_fft(aa, bb, dc_normalize=True).reshape(-1, w, w)]
    g = torch.Generator().manual_seed(w)
    extra = torch.rand(12, w, w, generator=g) * 50.0 - 10.0
    extra[0] = 0.25
    extra[1] = 0.0
    for i, (r, c) in enumerate([(0, 0), (0, w - 1), (w - 1, 0), (w - 1, w - 1),
                                (0, 5), (w - 1, 7), (6, 0), (9, w - 1)], start=2):
        extra[i, r, c] = 100.0
    extra[10, 3, 4] = extra[10, 10, 12] = 90.0  # a tie: the first index wins
    maps.append(extra.to(card))
    return torch.cat(maps).contiguous()


@pytest.mark.parametrize("w", [16, 32, 64, 128])
@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("min_subtract", [False, True])
def test_peakfit_kernel_matches_plain_version(card, w, validate, min_subtract):
    maps = _correlation_maps(card, w)
    if not min_subtract:
        maps = maps - maps.amin(dim=(1, 2), keepdim=True)
    before = peakfit.launches
    ku, kv, ki = peakfit(maps, validate, 1.2, 3, min_subtract=min_subtract)
    pu, pv, pi = correlation_to_displacement(maps, validate, 1.2, 3,
                                             min_subtract=min_subtract)
    torch.cuda.synchronize()
    assert peakfit.launches == before + 1
    torch.testing.assert_close(ku, pu, rtol=0, atol=1e-5)
    torch.testing.assert_close(kv, pv, rtol=0, atol=1e-5)
    if validate:
        assert ki.dtype == torch.bool and torch.equal(ki, pi)
        assert ki.any() and not ki.all()
    else:
        assert ki is None and pi is None


@pytest.mark.parametrize("window", [1, 3, 5])
def test_peakfit_kernel_exclusion_window(card, window):
    maps = _correlation_maps(card, 32)
    _, _, ki = peakfit(maps, True, 1.1, window, min_subtract=True)
    _, _, pi = correlation_to_displacement(maps, True, 1.1, window, min_subtract=True)
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("kw", [
    dict(multipass_mode="CWS"), dict(multipass_mode="DWS"),
    dict(multipass_mode="DEF"), dict(multipass_mode="DEF", cws_interp="bicubic"),
    dict(multipass_mode="CWS", cws_interp="bicubic"),
    dict(multipass_mode="DEF", peakfit="pallas"),
], ids=lambda kw: "-".join(kw.values()))
def test_cuda_engine_matches_cpu_engine(card, kw):
    flow = shear_flow(1.0, 0.01) if kw["multipass_mode"] == "DEF" else (3.3, -2.1)
    fa, fb = particle_pair((512, 512), flow, seed=9)
    cfg = PIVConfig(frame_shape=(512, 512), wind_size=64, overlap=32,
                    multipass=2, **kw)
    fa, fb = torch.from_numpy(fa), torch.from_numpy(fb)
    cu, cv, ci = (t.cpu().numpy() for t in MultipassPIV(cfg, device=card)(fa, fb))
    pu, pv, pi = (t.numpy() for t in MultipassPIV(cfg, device="cpu")(fa, fb))
    assert np.mean(ci != pi) < 0.02
    both = ~(ci | pi)
    assert np.sqrt(np.mean((cu - pu)[both] ** 2)) < 0.01
    assert np.sqrt(np.mean((cv - pv)[both] ** 2)) < 0.01


def test_offline_piv_launches_the_kernel_twice_per_batch(card, tmp_path):
    for i in range(3):
        fa, fb = particle_pair((256, 256), (3.3, -2.1), seed=i)
        imwrite_gray(str(tmp_path / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(tmp_path / f"p{i}_b.bmp"), fb)
    piv = OfflinePIV(str(tmp_path), multipass=2, batch_size=2)
    before = shift_windows.launches
    fields = list(piv())
    assert len(fields) == 3
    assert shift_windows.launches == before + 4  # 2 batches x 2 frames


def test_offline_piv_def_path_launches_its_kernels(card, tmp_path):
    for i in range(3):
        fa, fb = particle_pair((256, 256), shear_flow(1.0, 0.01), seed=i)
        imwrite_gray(str(tmp_path / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(tmp_path / f"p{i}_b.bmp"), fb)
    piv = OfflinePIV(str(tmp_path), multipass=2, multipass_mode="DEF",
                     batch_size=2, engine_options={"peakfit": "pallas"})
    before = def_windows.launches, peakfit.launches, shift_windows.launches
    fields = list(piv())
    assert len(fields) == 3
    # 2 batches x (2 frames; 2 passes)
    assert (def_windows.launches, peakfit.launches, shift_windows.launches) == \
        (before[0] + 4, before[1] + 4, before[2])


def test_tf32_on_is_refused(card, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    eng = MultipassPIV(PIVConfig(frame_shape=(128, 128), wind_size=32, overlap=16),
                       device=card)
    with pytest.raises(RuntimeError, match="TF32"):
        eng(torch.zeros(128, 128), torch.zeros(128, 128))
