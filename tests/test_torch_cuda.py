"""The port on an NVIDIA card: the CUDA window-shift kernel against its
plain PyTorch version, the CUDA engine against the CPU engine, and the
kernel's launches on the OfflinePIV path.  Every test skips without a CUDA
device.  The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: integer shifts are tile copies and must match bit for bit;
fractional shifts 1e-4 of a grey level (the kernel rounds every product
and sum in the plain version's order, so equality is expected); engines
within the port's parity budget (< 2% mask mismatch, RMS < 0.01 px)."""
import numpy as np
import pytest
import torch

from torchpiv_tpu_torch import MultipassPIV, OfflinePIV, PIVConfig
from torchpiv_tpu_torch.io.decode import imwrite_gray
from torchpiv_tpu_torch.kernels.shift import shift_windows
from torchpiv_tpu_torch.ops.shifts import shift_windows_reference
from torchpiv_tpu_torch.utils.synthetic import particle_pair

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


@pytest.mark.parametrize("mode", ["CWS", "DWS"])
def test_cuda_engine_matches_cpu_engine(card, mode):
    fa, fb = particle_pair((512, 512), (3.3, -2.1), seed=9)
    cfg = PIVConfig(frame_shape=(512, 512), wind_size=64, overlap=32,
                    multipass=2, multipass_mode=mode)
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


def test_tf32_on_is_refused(card, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    eng = MultipassPIV(PIVConfig(frame_shape=(128, 128), wind_size=32, overlap=16),
                       device=card)
    with pytest.raises(RuntimeError, match="TF32"):
        eng(torch.zeros(128, 128), torch.zeros(128, 128))
