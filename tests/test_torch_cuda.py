"""The port on an NVIDIA card: each CUDA kernel (bilinear and bicubic window
shift, the four bilinear shift variants, window deformation, fused peak fit,
correlate-and-fit, whole pass) against its plain PyTorch version, the CUDA
engine against the CPU engine (shift variants and robust knobs too), the
kernels' launches on the OfflinePIV paths, the pipeline's stages and
background on the card, the exact modes of the two anatomy tools, the
``dtype`` knob on the kernel paths, and OnlinePIV, VideoPIV, the HTTP
service and PIVRunner on the card against the same entry points on the
CPU, and EnsemblePIV, MultiDtPIV, FolkiPIV, PTV, the quality maps, the SAD
matchers, the particle detector and the blur on the card against the CPU
(the tolerances of their CPU tests against the JAX package; the fused peak
fit launched once an ensemble field, the shift kernel twice a multi-frame
snapshot), the command line: ``tpiv-torch run`` on the card against
``--device cpu`` (the parity budget) and ``tpiv-torch doctor --cache``, and
the JAX engine's XLA resampling paths: the three shifts and the dense DEF
path on the card against the CPU (within 1e-4 of a grey level), the
engine with ``use_pallas="off"`` against the CPU engine (the parity
budget) and the kernels' launches beyond and at their limits.  Every test
skips without a CUDA device.  The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the bilinear and bicubic shifts, the shift variants and the
deformation (both interpolations) must match bit for bit, fractional shifts
included (the kernels round every product and sum in the plain version's
order); peak fit ``u, v`` 1e-5 px with equal masks
(the kernel adds EPS after subtracting the minimum, the plain version
``EPS - min`` in one step); the correlate-and-fit and whole-pass kernels
run their own FFT and sum in another order than ``torch.fft``: masks differ
on at most 0.1% of the windows (one window where there are fewer than
1000), the integer peak is the same on at least 99.9%, and on jointly valid
windows ``u, v`` agree within RMS 1e-4 px and 1e-3 px at most; engines
within the port's parity budget (< 2% mask mismatch, RMS < 0.01 px)."""
import importlib.util
import pathlib
import shutil
import threading

import numpy as np
import pytest
import torch

from torchpiv_tpu_torch import MultipassPIV, OfflinePIV, PIVConfig
from torchpiv_tpu_torch.io.decode import imwrite_gray
from torchpiv_tpu_torch.kernels.corrfit import correlate_peakfit, describe
from torchpiv_tpu_torch.kernels.deform import MAX_DEF_TILE, def_tile
from torchpiv_tpu_torch.kernels.shift import MAX_BICUBIC_WIND, MAX_SHIFT_WIND
from torchpiv_tpu_torch.kernels.deform import def_windows
from torchpiv_tpu_torch.kernels.deform import describe as def_describe
from torchpiv_tpu_torch.kernels.fused_pass import fused_piv_pass
from torchpiv_tpu_torch.kernels.peakfit import describe as peakfit_describe
from torchpiv_tpu_torch.kernels.peakfit import peakfit
from torchpiv_tpu_torch.kernels.shift import (VARIANT_WRAPPERS, shift_windows,
                                              shift_windows_bicubic)
from torchpiv_tpu_torch.kernels.shift import describe as shift_describe
from torchpiv_tpu_torch.ops.corrfit import (correlate_peakfit_reference,
                                            fused_pass_reference)
from torchpiv_tpu_torch.ops.correlate import correlate_fft
from torchpiv_tpu_torch.ops.deform import (BLOCK_WINDOWS, STAGES, block_geometry,
                                           def_windows_reference)
from torchpiv_tpu_torch.ops.packing import pack_windows
from torchpiv_tpu_torch.ops.peakfit import (correlation_to_displacement,
                                            warp_fit_plan)
from torchpiv_tpu_torch.ops.shifts import (blend_reference_variant, shift_operands,
                                           shift_windows_reference, warp_lanes)
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


# every width the bilinear kernel serves differently: several windows a
# warp (w <= 16), one with idle lanes (12, 24), one to four columns a lane
WIDTHS = (4, 8, 12, 16, 24, 32, 48, 64, 128)


def _ragged_shape(w, o, per_block, n_rows=3):
    """A frame whose window grid has ``n_rows`` rows and a column count
    that leaves the last block of a row part empty."""
    step = w - o
    n_cols = per_block + 3
    return w + step * (n_rows - 1) + step - 1, w + step * (n_cols - 1) + step - 1


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("w", WIDTHS)
def test_kernel_matches_plain_version(card, w, kind, batch):
    """Bit for bit, fractional shifts too: the blend rounds every product
    and sum in the plain version's order."""
    o = w // 2
    per_block = 8 * (32 // min(32, 1 << (w - 1).bit_length()))
    shape = _ragged_shape(w, o, per_block)
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(w)
    frames = (torch.rand(batch, H, W, generator=g) * 255).to(card)
    vx = torch.rand(batch, n, generator=g) * 3 * w - 1.5 * w  # past +-S = w/2
    vy = torch.rand(batch, n, generator=g) * 3 * w - 1.5 * w
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
    assert torch.equal(got, want)


@pytest.mark.parametrize("values", ["uint8", "float"])
@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("shape,w,o,options", [
    ((256, 320), 32, 16, {}), ((200, 261), 64, 32, {}), ((300, 300), 128, 64, {}),
    ((131, 157), 16, 8, {}), ((67, 90), 8, 4, {}), ((40, 52), 4, 2, {}),
    ((256, 320), 32, 16, dict(max_shift=5)),
    ((256, 317), 32, 24, dict(flat_wrap=False)), ((200, 200), 25, 10, {})])
@pytest.mark.parametrize("variant", sorted(VARIANT_WRAPPERS))
def test_variant_kernel_matches_plain_version_and_rolls(card, variant, shape, w, o,
                                                        options, kind, values):
    """A variant's kernel equals its plain version bit for bit (fractional
    shifts too: the blend rounds every product and sum in the plain
    version's order) and, on 8-bit grey levels, the ``rolls`` kernel."""
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(w + len(variant))
    frames = torch.rand(3, H, W, generator=g) * 255
    if values == "uint8":
        frames = frames.round()
    frames = frames.to(card)
    vx = torch.rand(3, n, generator=g) * 3 * w - 1.5 * w  # past +-S = w/2
    vy = torch.rand(3, n, generator=g) * 3 * w - 1.5 * w
    if kind == "integer":
        vx, vy = vx.round(), vy.round()
    elif kind == "mixed":
        vx = vx.round()
    vx, vy = vx.to(card), vy.to(card)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, **options)
    wrapper = VARIANT_WRAPPERS[variant]
    before = wrapper.launches, shift_windows.launches
    got = shift_windows(frames, vx, vy, variant=variant, **kw)
    want = shift_windows_reference(frames, vx, vy, variant=variant, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, shift_windows.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, want)
    rolls = shift_windows(frames, vx, vy, **kw)
    if values == "uint8" or variant == "lanephases":
        assert torch.equal(got, rolls)
    else:  # the frame was rounded to bfloat16
        assert not torch.equal(got, rolls)
    assert torch.equal(wrapper(frames[0], vx[0], vy[0], **kw), got[0])


def _smooth_maps(n_rows, n_cols, batch, w, g):
    """Shifts like a CWS pass 2: one offset plus a slow gradient, so that
    neighbouring windows share their integer part."""
    r = torch.arange(n_rows, dtype=torch.float32)[:, None]
    c = torch.arange(n_cols, dtype=torch.float32)[None, :]
    base = torch.rand(batch, 2, generator=g) * w - w / 2
    vx = base[:, :1] + (0.02 * (r + c)).reshape(1, -1)
    vy = base[:, 1:] + (0.02 * (r - c)).reshape(1, -1)
    return vx, vy


@pytest.mark.parametrize("values", ["uint8", "float", "ties"])
@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed", "smooth"])
@pytest.mark.parametrize("w", [4, 16, 32, 33, 64, 128])
def test_bf16_kernel_rounds_as_it_loads(card, w, kind, values):
    """The ``"bf16"`` kernel reads the padded float32 frame itself and
    rounds each sample to bfloat16 as it loads it: bit for bit its plain
    version (which rounds the frame first) on random, integer, mixed and
    smooth maps, on 8-bit, float-valued and tie-laden frames, and the
    ``rolls`` kernel on 8-bit frames."""
    o = w // 2
    per_block = 8 * (32 // min(32, 1 << (w - 1).bit_length()))
    shape = _ragged_shape(w, o, per_block)
    H, W = shape
    n_rows, n_cols = (H - w) // (w - o) + 1, (W - w) // (w - o) + 1
    g = torch.Generator().manual_seed(w + 7)
    frames = torch.rand(3, H, W, generator=g) * 255
    if values == "uint8":
        frames = frames.round()
    elif values == "ties":  # exact half-way points between bfloat16 numbers
        frames = frames.round() + torch.where(torch.rand(3, H, W, generator=g) < 0.5,
                                              0.5, -0.0)
    frames = frames.to(card)
    if kind == "smooth":
        vx, vy = _smooth_maps(n_rows, n_cols, 3, w, g)
    else:
        vx = torch.rand(3, n_rows * n_cols, generator=g) * 3 * w - 1.5 * w
        vy = torch.rand(3, n_rows * n_cols, generator=g) * 3 * w - 1.5 * w
        if kind == "integer":
            vx, vy = vx.round(), vy.round()
        elif kind == "mixed":
            vx = vx.round()
    vx, vy = vx.to(card), vy.to(card)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    wrapper = VARIANT_WRAPPERS["bf16"]
    before = wrapper.launches
    got = wrapper(frames, vx, vy, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ops = shift_operands(frames, vx, vy, **kw)
    want = blend_reference_variant(ops, w, "bf16")
    assert torch.equal(got, want)
    rolls = shift_windows(frames, vx, vy, **kw)
    if values == "uint8":
        assert torch.equal(got, rolls)
    else:
        assert not torch.equal(got, rolls)


# every lane map and plan of the TMA ring: 32 / G windows an item (1-16),
# one to four columns a lane, a column past a lane's last slot (33, 65,
# 97), fewer warps a block (64) and fewer stages (128)
LANEPHASES_WIDTHS = (1, 2, 3, 4, 5, 7, 8, 12, 16, 17, 24, 31, 32, 33, 40, 48,
                     63, 64, 65, 96, 97, 127, 128)


@pytest.mark.parametrize("odd", [False, True], ids=["Wp4", "Wp_odd"])
@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed", "smooth"])
@pytest.mark.parametrize("w", LANEPHASES_WIDTHS)
def test_lanephases_kernel_every_instance(card, w, kind, odd):
    """The TMA ring at every instance: bit for bit its plain version and
    the ``rolls`` kernel, on a padded width that is a multiple of 4 (the
    frame itself is the tensor map's) and on an odd one (a copy pitched to
    the next multiple of 4), with windows clamped against every edge."""
    o = w // 2
    step = w - o
    W = w + step * 2 * (32 // warp_lanes(w)[0] + 1)  # a ragged last item a row
    Wp = W + 2 * max(w // 2, 1)  # the flat-wrap pad
    W += (1 - Wp % 2) if odd else -Wp % 4
    shape = (w + 2 * step + step - 1, W)
    H = shape[0]
    n_rows, n_cols = (H - w) // step + 1, (W - w) // step + 1
    g = torch.Generator().manual_seed(1000 + w)
    frames = (torch.rand(3, H, W, generator=g) * 255).to(card)
    if kind == "smooth":
        vx, vy = _smooth_maps(n_rows, n_cols, 3, w, g)
    else:
        vx = torch.rand(3, n_rows * n_cols, generator=g) * 3 * w - 1.5 * w
        vy = torch.rand(3, n_rows * n_cols, generator=g) * 3 * w - 1.5 * w
        if kind == "integer":
            vx, vy = vx.round(), vy.round()
        elif kind == "mixed":
            vx = vx.round()
    vx, vy = vx.to(card), vy.to(card)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    ops = shift_operands(frames, vx, vy, **kw)
    assert (ops.frame.shape[-1] % 4 == 0) != odd
    wrapper = VARIANT_WRAPPERS["lanephases"]
    before = wrapper.launches
    got = wrapper(frames, vx, vy, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, blend_reference_variant(ops, w, "lanephases"))
    assert torch.equal(got, shift_windows(frames, vx, vy, **kw))


def test_lanephases_reads_the_padded_frame_itself(card):
    """The kernel reads the padded frame as it is, whatever its width: the
    wrapper makes no copy of it (no pitch pad)."""
    from torchpiv_tpu_torch.kernels.shift import variant_frame

    for W in (256, 255):
        frames = torch.rand(2, 256, W, device=card) * 255
        n = 15 * ((W - 32) // 16 + 1)
        z = torch.zeros(2, n, device=card)
        ops = shift_operands(frames, z, z, frame_shape=(256, W), wind_size=32,
                             overlap=16)
        got = variant_frame(ops, "lanephases")
        assert got.data_ptr() == ops.frame.data_ptr() and got.shape == ops.frame.shape


@pytest.fixture(scope="module")
def ring_tool():
    """``tools/lanephases_ring_cuda.py`` and a built copy of the package's
    sources whose ``shift_windows_lanephases.cu`` is the ring of
    ``tools/lanephases_ring.cu`` (the design the kernel was measured
    against)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = pathlib.Path(__file__).resolve().parents[1] / "tools"
    spec = importlib.util.spec_from_file_location("lanephases_ring_cuda",
                                                  root / "lanephases_ring_cuda.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    copy, _ = tool.build({"ring": tool.edited_copy(tool.ring_source(), "ring")})["ring"]
    yield tool, copy
    shutil.rmtree(copy)


@pytest.mark.parametrize("kind", ["fractional", "mixed"])
@pytest.mark.parametrize("w", [4, 16, 31, 32, 33, 64, 128])
def test_lanephases_ring_tool_equals_plain_version(card, ring_tool, w, kind):
    """The ring fed by the copy engine, bit for bit its plain version on an
    odd padded width (pitched to a multiple of 4), with the plan its CPU
    model (``tma_ring_steps``) replays."""
    from torchpiv_tpu_torch.kernels.shift import launch_variant

    tool, copy = ring_tool
    o = w // 2
    step = w - o
    W = w + step * 2 * (32 // warp_lanes(w)[0] + 1)
    W += 1 - (W + 2 * max(w // 2, 1)) % 2
    shape = (w + 3 * step - 1, W)
    H = shape[0]
    n = ((H - w) // step + 1) * ((W - w) // step + 1)
    g = torch.Generator().manual_seed(w)
    frames = (torch.rand(3, H, W, generator=g) * 255).to(card)
    vx = torch.rand(3, n, generator=g) * 3 * w - 1.5 * w
    vy = torch.rand(3, n, generator=g) * 3 * w - 1.5 * w
    if kind == "mixed":
        vx = vx.round()
    ops = shift_operands(frames, vx.to(card), vy.to(card), frame_shape=shape,
                         wind_size=w, overlap=o)
    pitched = torch.nn.functional.pad(ops.frame, (0, -ops.frame.shape[-1] % 4))
    with tool.base.pointed_at(copy):
        got = launch_variant(ops, w, "lanephases", frame=pitched.contiguous())
        torch.cuda.synchronize()
        plan = tool.card_plan(w)
    assert torch.equal(got, blend_reference_variant(ops, w, "lanephases"))
    want = tool.ring_plan(w)
    assert {k: plan[k] for k in want if k in plan} == \
        {k: want[k] for k in want if k in plan}
    assert plan["blocks_per_sm"] >= 1


# every width the bicubic kernel serves differently: several windows a warp
# (4, 16), a group one lane short (31), one to four columns a lane, with
# and without the extra slot (32, 33, 64, 125)
BICUBIC_WIDTHS = (4, 16, 31, 32, 33, 64, 125)


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("w", BICUBIC_WIDTHS)
def test_bicubic_kernel_matches_plain_version(card, w, kind, batch):
    """Bit for bit, fractional shifts too: the kernel forms the plain
    version's horizontal sums once per tile row and its vertical sums from
    them, every product and sum rounded in the plain version's order."""
    o = w // 2
    per_block = 8 * (32 // max(4, min(32, 1 << (w - 1).bit_length())))
    shape = _ragged_shape(w, o, per_block)
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(w + 1)
    frames = (torch.rand(batch, H, W, generator=g) * 255).to(card)
    vx = torch.rand(batch, n, generator=g) * 3 * w - 1.5 * w  # past +-S = w/2
    vy = torch.rand(batch, n, generator=g) * 3 * w - 1.5 * w
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
    assert torch.equal(got, want)
    if kind == "integer":  # weights (0, 1, 0, 0): the integer copy, away from +S
        copy = shift_windows(frames, vx, vy, **kw)
        inside = (vx < w // 2) & (vy < w // 2)
        assert torch.equal(got[inside], copy[inside])


@pytest.mark.parametrize("kw", [dict(max_shift=5), dict(flat_wrap=False)])
def test_bicubic_kernel_options_match_plain_version(card, kw):
    shape, w, o = (256, 317), 32, 24
    n = ((256 - w) // (w - o) + 1) * ((317 - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(7)
    frames = (torch.rand(3, *shape, generator=g) * 255).to(card)
    vx, vy = ((torch.rand(3, n, generator=g) * 3 * w - 1.5 * w).to(card)
              for _ in range(2))
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, **kw)
    got = shift_windows_bicubic(frames, vx, vy, **kw)
    want = shift_windows_reference(frames, vx, vy, interp="bicubic", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (w, margin): every width of WIDTHS that a DEF tile admits, an odd one
# (integer in-window offsets), margins 1-4 and tiles up to 129
DEF_CASES = ((4, 1), (8, 2), (12, 3), (16, 4), (24, 2), (32, 2), (33, 1), (48, 3),
             (64, 4), (120, 2))


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("kind", ["general", "saturating", "integer"])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("w,margin", DEF_CASES)
def test_def_kernel_matches_plain_version(card, w, margin, interp, kind, batch):
    """Bit for bit: the residual, weights and sums are rounded in the plain
    version's order."""
    if w == 120 and interp == "bilinear":
        margin = 4  # the largest tile: 120 + 8 + 1 = 129
    o = w // 2
    shape = _ragged_shape(w, o, per_block=BLOCK_WINDOWS)
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(w + margin)
    frames = (torch.rand(batch, H, W, generator=g) * 255).to(card)
    vx = torch.rand(batch, n, generator=g) * 3 * w - 1.5 * w  # past +-S = w/2
    vy = torch.rand(batch, n, generator=g) * 3 * w - 1.5 * w
    slope = {"general": 0.05, "saturating": 0.6, "integer": 0.0}[kind]
    grads = [((torch.rand(batch, n, generator=g) * 2 - 1) * slope).to(card)
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
    assert torch.equal(got, want)
    if kind == "integer" and interp == "bilinear":
        # the shift kernel's integer copy, away from +S
        copy = shift_windows(frames, vx, vy, frame_shape=shape, wind_size=w, overlap=o)
        inside = (vx < w // 2) & (vy < w // 2)
        assert torch.equal(got[inside], copy[inside])


@pytest.mark.parametrize("w", WIDTHS)
def test_shift_kernel_does_not_spill(card, w):
    info = shift_describe(w)
    assert info["local_bytes"] == 0  # no spill, no stack frame
    # four blocks of 256 threads an SM, two for three or four columns a lane
    assert 0 < info["registers"] <= (64 if w <= 64 else 128)
    assert info["shared_bytes"] == 0
    assert info["threads"] == 256
    assert info["windows"] == 8 * (32 // min(32, 1 << (w - 1).bit_length()))


@pytest.mark.parametrize("w", [1, 3, 4, 16, 31, 32, 33, 64, 96, 125, 128])
@pytest.mark.parametrize("name", ["shift_windows_bicubic", "shift_windows_phases",
                                  "shift_windows_bf16", "shift_windows_lanephases"])
def test_warp_shift_kernels_do_not_spill(card, name, w):
    """Every instance of the kernels on warp_lanes.cuh's map: no spill, no
    shared memory, and the windows a block of the lane map."""
    limit = MAX_BICUBIC_WIND if name == "shift_windows_bicubic" else MAX_SHIFT_WIND
    if w > limit:
        with pytest.raises(ValueError, match="wind_size"):
            shift_describe(w, name)
        return
    info = shift_describe(w, name)
    assert info["local_bytes"] == 0  # no spill, no stack frame
    # four blocks of 256 threads an SM, two for three or four columns a lane
    assert 0 < info["registers"] <= (64 if w <= 64 else 128)
    assert info["shared_bytes"] == 0
    assert info["threads"] == 256
    reach = 3 if name == "shift_windows_bicubic" else 1
    assert info["windows"] == 8 * (32 // warp_lanes(w, reach)[0])


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("w,margin", DEF_CASES)
def test_def_kernel_does_not_spill(card, w, margin, interp):
    if def_tile(w, margin, interp) > MAX_DEF_TILE:
        margin = 1
    info = def_describe(w, margin, interp)
    assert info["local_bytes"] == 0
    assert 0 < info["registers"] <= 85  # six blocks of 128 threads an SM
    T = def_tile(w, margin, interp)
    assert info["shared_bytes"] == STAGES * T * (T | 1) * 4  # rows at an odd pitch
    assert info["shared_bytes"] <= 232448  # 227 KB a block on this card
    assert info["threads"] == block_geometry(w)[2]
    assert info["windows"] == BLOCK_WINDOWS


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


def _fit_cases(d, vw, seed=0):
    """Maps for the peak fit at every size: random ones, peaks on every edge
    and corner, within vw rows of an edge, second peaks at the edge of the
    exclusion set, a tie, constant maps and maps that hold a NaN."""
    g = torch.Generator().manual_seed(seed * 1000 + d * 10 + vw)
    near = min(vw, d - 1)
    maps = [torch.rand(4, d, d, generator=g)]
    for r, c in sorted({(0, 0), (0, d - 1), (d - 1, 0), (d - 1, d - 1), (near, near),
                        (d - 1 - near, d - 1 - near), (near, d - 1), (d // 2, d // 2)}):
        m = torch.rand(1, d, d, generator=g) * 0.3
        m[0, r, c] = 1.0
        maps.append(m)
    for off in (vw, vw + 1):
        m = torch.rand(1, d, d, generator=g) * 0.1
        m[0, d // 2, d // 2] = 1.0
        m[0, min(d // 2 + off, d - 1), d // 2] = 0.95
        maps.append(m)
    tie = torch.rand(1, d * d, generator=g) * 0.5
    tie[0, [min(d + 1, d * d - 2), d * d - 2]] = 1.0
    maps += [tie.reshape(1, d, d), torch.full((1, d, d), 0.25), torch.zeros(1, d, d)]
    for where in (0, d * d // 2, d * d - 1):
        m = torch.rand(1, d * d, generator=g)
        m[0, where] = float("nan")
        maps.append(m.reshape(1, d, d))
    return torch.cat(maps)


def _pedestal(maps):
    """Raw maps with an offset and one pedestal pixel below all others, half
    the map from the peak: no sample that the fit reads lies within 2 of the
    minimum (see the module docstring)."""
    flat = maps.reshape(len(maps), -1).clone()
    kd = flat.shape[1]
    peak = torch.nan_to_num(flat, nan=-1.0).argmax(dim=1)
    low = torch.nan_to_num(flat, nan=2.0).amin(dim=1)
    flat[torch.arange(len(flat)), (peak + kd // 2) % kd] = low - 1.0
    return flat.reshape(maps.shape) * 40.0 - 7.0


@pytest.mark.parametrize("min_subtract", [False, True])
@pytest.mark.parametrize("vw", [0, 3, 5])
@pytest.mark.parametrize("d", [4, 5, 12, 16, 23, 32, 33, 48, 64, 100, 128])
def test_peakfit_kernel_every_instance(card, d, vw, min_subtract):
    """Every instance of the warp kernel (the map in registers up to 32 px,
    in chunks up to 128; ragged sizes too): ``u, v`` within 1e-5 px of the
    plain version, NaN maps at exactly 0, masks equal."""
    maps = _fit_cases(d, vw)
    if min_subtract:
        maps = _pedestal(maps)
    maps = maps.to(card).contiguous()
    before = peakfit.launches
    ku, kv, ki = peakfit(maps, True, 1.2, vw, min_subtract=min_subtract)
    pu, pv, pi = correlation_to_displacement(maps, True, 1.2, vw,
                                             min_subtract=min_subtract)
    torch.cuda.synchronize()
    assert peakfit.launches == before + 1
    torch.testing.assert_close(ku, pu, rtol=0, atol=1e-5)
    torch.testing.assert_close(kv, pv, rtol=0, atol=1e-5)
    assert torch.equal(ki, pi)
    nan = torch.isnan(maps).flatten(1).any(dim=1)
    assert nan.any() and not bool(ku[nan].any() or kv[nan].any())


@pytest.mark.parametrize("d", [1, 4, 5, 8, 11, 12, 16, 22, 23, 32, 33, 64, 65, 128,
                               129, 200, 238])
def test_peakfit_kernel_does_not_spill(card, d):
    """Every instance: no spill, the register budget of its launch bounds,
    four maps a block of 128 threads up to 128 px, a block a map above."""
    info = peakfit_describe(d)
    assert info["local_bytes"] == 0 and info["threads"] == 128
    if d > 128:
        assert info["windows"] == 1 and 0 < info["registers"] <= 32
        assert info["shared_bytes"] >= d * d * 4
        return
    ch, maxc = warp_fit_plan(d)
    assert info["windows"] == 4 and info["shared_bytes"] == 0
    # min_blocks of csrc/peakfit.cu: 8, 6 or 4 blocks of 128 threads an SM
    budget = 64 if maxc == 1 and ch < 32 else 80 if maxc <= 16 else 128
    assert 0 < info["registers"] <= budget


def _assert_fit_agrees(got, want):
    """The stated tolerance of the correlate-and-fit kernels."""
    (ku, kv, ki), (pu, pv, pi) = got, want
    n = ku.numel()
    if ki is None:
        assert pi is None
        both = torch.ones_like(ku, dtype=torch.bool)
    else:
        assert ki.dtype == torch.bool and ki.shape == ku.shape
        assert (ki != pi).sum().item() <= max(1, n // 1000)
        both = ~(ki | pi)
    du, dv = (ku - pu)[both], (kv - pv)[both]
    same_cell = (du.abs() < 0.5) & (dv.abs() < 0.5)
    assert (~same_cell).sum().item() <= max(1, n // 1000)
    du, dv = du[same_cell], dv[same_cell]
    assert du.square().mean().sqrt().item() < 1e-4
    assert dv.square().mean().sqrt().item() < 1e-4
    assert max(du.abs().max().item(), dv.abs().max().item()) < 1e-3


def _window_pairs(card, w, shape=(320, 288)):
    """``[N, w, w]`` window pairs of a particle pair at 50% overlap."""
    fa, fb = particle_pair(shape, (1.3, -0.7), seed=w)
    aa = extract_windows(torch.from_numpy(fa)[None].float().to(card), w, w // 2)[0]
    bb = extract_windows(torch.from_numpy(fb)[None].float().to(card), w, w // 2)[0]
    return aa.contiguous(), bb.contiguous()


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("dc_normalize", [False, True])
def test_corrfit_kernel_matches_plain_version(card, w, validate, dc_normalize):
    aa, bb = _window_pairs(card, w)
    if dc_normalize:  # no blank window: sum(a) * sum(b) > 0
        aa, bb = aa + 1.0, bb + 1.0
    before = correlate_peakfit.launches
    got = correlate_peakfit(aa, bb, validate, 1.2, 3, dc_normalize)
    want = correlate_peakfit_reference(aa, bb, validate, 1.2, 3, dc_normalize)
    torch.cuda.synchronize()
    assert correlate_peakfit.launches == before + 1
    assert got[0].shape == (aa.shape[0],)
    _assert_fit_agrees(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("w", [4, 16, 32, 64])
def test_corrfit_kernel_ragged_last_block(card, w, n):
    """Windows up to 32 share a block by fours: a count that leaves the last
    block part empty gives the same fields, window for window."""
    aa, bb = _window_pairs(card, w, shape=(4 * w, 5 * w))
    full = correlate_peakfit(aa, bb)
    part = correlate_peakfit(aa[:n].contiguous(), bb[:n].contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(p, f[:n]) for p, f in zip(part, full))


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("name", ["corrfit", "fused_pass"])
def test_no_instance_spills_or_outgrows_the_shared_memory(card, name, w):
    info = describe(name, w)
    assert info["local_bytes"] == 0  # no spill, no stack frame
    assert 0 < info["registers"] <= 255
    assert info["shared_bytes"] <= 232448  # 227 KB a block on this card
    assert info["threads"] == 32 * info["windows"] or info["windows"] == 1
    assert info["windows"] == (4 if w <= 32 else 1)


@pytest.mark.parametrize("bad", [
    lambda a, b: (a[:, :, :-1], b[:, :, :-1]), lambda a, b: (a, b[:-1]),
    lambda a, b: (a.double(), b.double()), lambda a, b: (a, b.cpu()),
    lambda a, b: (a[:, :24, :24], b[:, :24, :24]),  # not a power of two
])
def test_corrfit_wrapper_rejects_what_the_kernel_does_not_take(card, bad):
    aa, bb = _window_pairs(card, 32, shape=(96, 96))
    with pytest.raises(ValueError):
        correlate_peakfit(*bad(aa, bb))


def _pass_case(card, shape, w, o, kind, batch=2):
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    pairs = [particle_pair(shape, (1.3, -0.7), seed=w + i) for i in range(batch)]
    fa = torch.from_numpy(np.stack([p[0] for p in pairs])).to(card)
    fb = torch.from_numpy(np.stack([p[1] for p in pairs])).to(card)
    g = torch.Generator().manual_seed(w)
    reach = 0.75 * w  # past the +-S = w/2 clamp
    maps = [torch.rand(batch, n, generator=g) * 2 * reach - reach for _ in range(4)]
    if kind == "integer":
        maps = [m.round() for m in maps]
    elif kind == "zero":
        maps = [torch.zeros(batch, n) for _ in range(4)]
    return fa, fb, [m.to(card) for m in maps]


@pytest.mark.parametrize("kind", ["fractional", "integer", "zero"])
@pytest.mark.parametrize("shape,w,o", [((256, 320), 32, 16), ((200, 264), 64, 32),
                                       ((300, 300), 128, 64), ((96, 120), 16, 8)])
def test_fused_pass_kernel_matches_plain_version(card, shape, w, o, kind):
    fa, fb, maps = _pass_case(card, shape, w, o, kind)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o,
              dc_normalize=kind == "zero")
    before = fused_piv_pass.launches, shift_windows.launches
    got = fused_piv_pass(fa, fb, *maps, **kw)
    want = fused_pass_reference(fa.float(), fb.float(), *maps, **kw)
    torch.cuda.synchronize()
    assert (fused_piv_pass.launches, shift_windows.launches) == \
        (before[0] + 1, before[1])
    assert got[0].shape == maps[0].shape
    _assert_fit_agrees(got, want)


@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("dc_normalize", [False, True])
@pytest.mark.parametrize("w", [4, 8, 16, 32, 64, 128])
def test_fused_pass_kernel_every_window(card, w, validate, dc_normalize):
    """Every instance, with shifts that reach the clamp and the pad, a batch
    of three and a window count that leaves a block part empty."""
    shape = (3 * w + w // 2 + 3, 4 * w + 5)
    fa, fb, maps = _pass_case(card, shape, w, w // 2, "fractional", batch=3)
    if dc_normalize:  # no blank window: sum(a) * sum(b) > 0
        fa, fb = fa.float() + 1, fb.float() + 1
    kw = dict(frame_shape=shape, wind_size=w, overlap=w // 2, validate=validate,
              dc_normalize=dc_normalize, val_ratio=1.3, validation_window=2)
    got = fused_piv_pass(fa, fb, *maps, **kw)
    want = fused_pass_reference(fa.float(), fb.float(), *maps, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == maps[0].shape and (got[2] is None) == (not validate)
    _assert_fit_agrees(got, want)


@pytest.mark.parametrize("kind", ["fractional", "integer", "zero"])
@pytest.mark.parametrize("shape,w,o", [((256, 320), 32, 16), ((40, 52), 4, 2),
                                       ((67, 90), 8, 4), ((96, 120), 16, 8),
                                       ((200, 264), 64, 32), ((300, 300), 128, 64)])
def test_fused_pass_correlates_the_windows_of_shift_windows(card, shape, w, o, kind):
    """The whole-pass kernel shares its device code with the shift and the
    correlate-and-fit kernels: its fields equal theirs bit for bit."""
    fa, fb, maps = _pass_case(card, shape, w, o, kind)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    if kind == "zero":
        fa, fb = fa.float() + 1, fb.float() + 1
    dc = dict(dc_normalize=kind == "zero")
    fu, fv, fi = fused_piv_pass(fa, fb, *maps, **dc, **kw)
    aa = shift_windows(fa, maps[0], maps[1], **kw)
    bb = shift_windows(fb, maps[2], maps[3], **kw)
    su, sv, si = correlate_peakfit(aa.reshape(-1, w, w), bb.reshape(-1, w, w), **dc)
    assert torch.equal(fu.reshape(-1), su) and torch.equal(fv.reshape(-1), sv)
    assert torch.equal(fi.reshape(-1), si)
    one = fused_piv_pass(fa[0], fb[0], *(m[0] for m in maps), validate=False,
                         **dc, **kw)
    assert one[2] is None and torch.equal(one[0], fu[0])


@pytest.mark.parametrize("kind", ["integer", "fractional"])
@pytest.mark.parametrize("shape,w,o", [((128, 112), 32, 16), ((200, 264), 64, 32),
                                       ((64, 72), 8, 4), ((300, 300), 128, 64)])
def test_packed_shift_equals_pack_of_the_standard_output(card, shape, w, o, kind):
    H, W = shape
    n_rows, n_cols = (H - w) // (w - o) + 1, (W - w) // (w - o) + 1
    g = torch.Generator().manual_seed(w)
    frames = (torch.rand(2, H, W, generator=g) * 255).to(card)
    vx = torch.rand(2, n_rows * n_cols, generator=g) * 3 * w - 1.5 * w
    vy = torch.rand(2, n_rows * n_cols, generator=g) * 3 * w - 1.5 * w
    if kind == "integer":
        vx, vy = vx.round(), vy.round()
    vx, vy = vx.to(card), vy.to(card)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    got = shift_windows(frames, vx, vy, packed=True, **kw)
    want = pack_windows(shift_windows(frames, vx, vy, **kw), n_rows, n_cols, w)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(shift_windows(frames[0], vx[0], vy[0], packed=True, **kw), got[0])


@pytest.mark.parametrize("kw", [
    dict(multipass_mode="CWS"), dict(multipass_mode="DWS"),
    dict(multipass_mode="DEF"), dict(multipass_mode="DEF", cws_interp="bicubic"),
    dict(multipass_mode="CWS", cws_interp="bicubic"),
    dict(multipass_mode="DEF", peakfit="pallas"),
    dict(multipass_mode="CWS", fused="split"), dict(multipass_mode="DWS", fused="split"),
    dict(multipass_mode="DEF", fused="split"),
    dict(multipass_mode="CWS", fused="split", cws_interp="bicubic"),
    dict(multipass_mode="CWS", fused="on"), dict(multipass_mode="DWS", fused="on"),
    dict(multipass_mode="CWS", shift_variant="bf16"),
    dict(multipass_mode="DWS", shift_variant="lanephases"),
    dict(multipass_mode="CWS", shift_variant="mxu", fused="split"),
    dict(multipass_mode="CWS", shift_variant="phases"),
    dict(multipass_mode="CWS", correlation="rpc", window_weight="gaussian"),
    dict(multipass_mode="CWS", subpixel="gauss2d", infill="fused"),
    dict(multipass_mode="CWS", median_filter="normmedian", infill="none"),
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


@pytest.mark.parametrize("fused,mode,want", [
    # 2 batches; per batch: one launch a pass, or one shift launch a frame
    ("split", "CWS", dict(correlate_peakfit=4, shift_windows=4)),
    ("split", "DEF", dict(correlate_peakfit=4, def_windows=4)),
    ("on", "CWS", dict(fused_piv_pass=4)),
    ("on", "DWS", dict(fused_piv_pass=4)),
    ("on", "DEF", dict(fused_piv_pass=2, def_windows=4)),  # only pass 1 fuses
])
def test_offline_piv_fused_paths_launch_their_kernels(card, tmp_path, fused, mode, want):
    from torchpiv_tpu_torch.kernels import KERNELS

    for i in range(3):
        fa, fb = particle_pair((256, 256), (3.3, -2.1), seed=i)
        imwrite_gray(str(tmp_path / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(tmp_path / f"p{i}_b.bmp"), fb)
    piv = OfflinePIV(str(tmp_path), multipass=2, multipass_mode=mode, batch_size=2,
                     engine_options={"fused": fused})
    before = {k.__name__: k.launches for k in KERNELS}
    fields = list(piv())
    assert len(fields) == 3
    got = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    assert got == {**dict.fromkeys(got, 0), **want}
    for _, _, u, v in fields:
        assert abs(np.median(u) / 1000 - 3.3) < 0.1
        assert abs(-np.median(v) / 1000 + 2.1) < 0.1


@pytest.mark.parametrize("options,mode,want", [
    # 2 batches; per batch one shift launch a frame
    ({"shift_variant": "bf16"}, "CWS", dict(shift_windows_bf16=4)),
    ({"shift_variant": "lanephases"}, "DWS", dict(shift_windows_lanephases=4)),
    ({"shift_variant": "mxu", "fused": "split"}, "CWS",
     dict(shift_windows_mxu=4, correlate_peakfit=4)),
    ({"shift_variant": "phases", "median_filter": "normmedian",
      "second_peak_fallback": True, "global_std": 5.0, "u_limits": (-8.0, 8.0)},
     "CWS", dict(shift_windows_phases=4)),
    ({"shift_variant": "phases", "fused": "on"}, "CWS", dict(fused_piv_pass=4)),
    ({"shift_variant": "bf16"}, "DEF", dict(def_windows=4)),
    ({"shift_variant": "no_such_variant"}, "CWS", dict(shift_windows=4)),
], ids=lambda x: "-".join(map(str, x.values())) if isinstance(x, dict) else str(x))
def test_offline_piv_variant_paths_launch_their_kernels(card, tmp_path, options, mode,
                                                        want):
    """A variant's kernel runs where the knob is read, with a mask on, and
    the 8-bit frames give the ``rolls`` fields bit for bit."""
    from torchpiv_tpu_torch.kernels import KERNELS

    for i in range(3):
        fa, fb = particle_pair((256, 256), (3.3, -2.1), seed=i)
        imwrite_gray(str(tmp_path / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(tmp_path / f"p{i}_b.bmp"), fb)
    mask = np.zeros((256, 256), bool)
    mask[:, :48] = True
    kw = dict(multipass=2, multipass_mode=mode, batch_size=2)
    piv = OfflinePIV(str(tmp_path), engine_options={**options, "frame_mask": mask}, **kw)
    before = {k.__name__: k.launches for k in KERNELS}
    fields = list(piv())
    assert len(fields) == 3
    got = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    assert got == {**dict.fromkeys(got, 0), **want}
    rolls = list(OfflinePIV(str(tmp_path), engine_options={
        **options, "shift_variant": "rolls", "frame_mask": mask}, **kw)())
    masked = np.flip(piv.engine.window_masked[-1].cpu().numpy(), axis=0)
    for (_, _, u, v), (_, _, ru, rv) in zip(fields, rolls):
        assert np.array_equal(u, ru) and np.array_equal(v, rv)
        assert (u[masked] == 0).all() and (v[masked] == 0).all()
        assert abs(np.median(u[~masked]) / 1000 - 3.3) < 0.1


def _write_pairs(folder, n, glare=None):
    for i in range(n):
        fa, fb = particle_pair((256, 256), (3.3, -2.1), seed=60 + i)
        if glare is not None:
            fa = np.clip(fa + glare, 0, 255).astype(np.uint8)
            fb = np.clip(fb + glare, 0, 255).astype(np.uint8)
        imwrite_gray(str(folder / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(folder / f"p{i}_b.bmp"), fb)


def test_offline_piv_pipeline_on_the_card(card, tmp_path):
    """The three stages on the card: pinned results (a short last batch
    included) equal to a serial loop's on the default stream, the CUDA
    spans measured, the transfer log complete, no thread left behind."""
    from torchpiv_tpu_torch.io.prefetch import PairPrefetcher
    from torchpiv_tpu_torch.pipeline import finalize_fields, packed_forward

    _write_pairs(tmp_path, 5)
    piv = OfflinePIV(str(tmp_path), multipass=2, batch_size=2)
    piv.span_log, piv.transfer_log = [], []
    fields = list(piv())
    x, y = piv.engine.final_coordinates
    serial = []
    for a, b, ids in PairPrefetcher(piv._dataset, 2, card):
        packed = packed_forward(piv.engine, a, b).cpu().numpy()
        serial += [finalize_fields(packed[i, 0], packed[i, 1], packed[i, 2] > 0.5,
                                   x, y, 1.0, 1) for i in range(len(ids))]
    assert len(fields) == len(serial) == 5
    for got, want in zip(fields, serial):
        assert all(np.array_equal(p, q) for p, q in zip(got, want))
    assert [s["pairs"] for s in piv.span_log] == [2, 2, 1]
    for s in piv.span_log:
        assert s["pin_s"] > 0 and s["h2d_ms"] > 0 and s["device_ms"] > 0 and s["d2h_ms"] > 0
    assert sum(nb for _, _, nb in piv.transfer_log) == 5 * 2 * 256 * 256
    assert not [t for t in threading.enumerate() if t.name.startswith("piv-")]


def test_offline_piv_background_on_the_card(card, tmp_path):
    """``background="auto"`` on the device: the fields of frames whose
    background was subtracted on the host, bit for bit."""
    from torchpiv_tpu_torch.io.dataset import PIVDataset, compute_background

    glare = np.zeros((256, 256), np.int32)
    glare[96:128] = 90
    (tmp_path / "raw").mkdir()
    (tmp_path / "clean").mkdir()
    _write_pairs(tmp_path / "raw", 3, glare)
    raw = PIVDataset(str(tmp_path / "raw"), ".bmp")
    bg = compute_background(raw)
    for i in range(len(raw)):
        for f, tag in zip(raw[i], "ab"):
            imwrite_gray(str(tmp_path / "clean" / f"p{i}_{tag}.bmp"),
                         np.where(f > bg, f - bg, 0).astype(np.uint8))
    got = list(OfflinePIV(str(tmp_path / "raw"), multipass=2, batch_size=2,
                          background="auto")())
    want = list(OfflinePIV(str(tmp_path / "clean"), multipass=2, batch_size=2)())
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert all(np.array_equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("mode", ["full", "noshuffle", "rowbyrow"])
def test_anatomy_tool_exact_modes_equal_the_plain_version(card, mode):
    """``tools/shift_anatomy_cuda.py``: the committed kernel, its right
    neighbours loaded instead of shuffled and its rows loaded one ahead,
    built from edited copies of the sources, give ``blend_reference``'s
    windows bit for bit."""
    from torchpiv_tpu_torch.kernels import _build
    from torchpiv_tpu_torch.kernels.shift import launch
    from torchpiv_tpu_torch.ops.shifts import blend_reference, shift_operands

    spec = importlib.util.spec_from_file_location(
        "shift_anatomy_cuda",
        pathlib.Path(__file__).resolve().parents[1] / "tools" / "shift_anatomy_cuda.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    shape, w, o = (256, 320), tool.W, tool.O
    n = ((shape[0] - w) // (w - o) + 1) * ((shape[1] - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(3)
    frames = (torch.rand(2, *shape, generator=g) * 255).round().to(card)
    vx, vy = ((torch.rand(2, n, generator=g) * 48 - 24).to(card) for _ in range(2))
    ops = shift_operands(frames, vx, vy, frame_shape=shape, wind_size=w, overlap=o)
    csrc = _build.CSRC
    ((copy, ptxas),) = tool.build([mode]).values()
    try:
        with tool.pointed_at(copy):
            got = launch(ops, w)
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(copy)
    assert _build.CSRC == csrc
    assert ptxas["registers"] > 0 and ptxas["spill_stores"] == 0
    assert torch.equal(got, blend_reference(ops, w))


@pytest.mark.parametrize("mode", ["full", "stages1"])
def test_def_anatomy_tool_exact_modes_equal_the_plain_version(card, mode):
    """``tools/def_anatomy_cuda.py``: the committed deformation kernel and
    its one-buffer staging, built from edited copies of the sources, give
    ``def_reference``'s windows bit for bit in both interpolations."""
    from torchpiv_tpu_torch.kernels import _build
    from torchpiv_tpu_torch.kernels.deform import launch
    from torchpiv_tpu_torch.ops.deform import def_operands, def_reference

    spec = importlib.util.spec_from_file_location(
        "def_anatomy_cuda",
        pathlib.Path(__file__).resolve().parents[1] / "tools" / "def_anatomy_cuda.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    shape, w, o = (160, 288), 32, 16
    n = ((shape[0] - w) // (w - o) + 1) * ((shape[1] - w) // (w - o) + 1)
    g = torch.Generator().manual_seed(4)
    frames = (torch.rand(2, *shape, generator=g) * 255).to(card)
    maps = [((torch.rand(2, n, generator=g) * 2 - 1) * s).to(card)
            for s in (24, 24, 0.05, 0.05, 0.05, 0.05)]
    csrc = _build.CSRC
    ((copy, ptxas),) = tool.build([mode]).values()
    try:
        with tool.base.pointed_at(copy):
            for interp in ("bilinear", "bicubic"):
                ops = def_operands(frames, *maps, frame_shape=shape, wind_size=w,
                                   overlap=o, interp=interp)
                got = launch(ops, w)
                torch.cuda.synchronize()
                assert torch.equal(got, def_reference(ops, w))
    finally:
        shutil.rmtree(copy)
    assert _build.CSRC == csrc
    assert all(p["registers"] > 0 and p["spill_stores"] == 0 for p in ptxas)


def test_tf32_on_is_refused(card, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    eng = MultipassPIV(PIVConfig(frame_shape=(128, 128), wind_size=32, overlap=16),
                       device=card)
    with pytest.raises(RuntimeError, match="TF32"):
        eng(torch.zeros(128, 128), torch.zeros(128, 128))


ROW_BLOCK_KERNELS = ["rolls", "bicubic", "def", "def-bicubic", "bf16", "lanephases",
                     "mxu", "phases"]


@pytest.mark.parametrize("flat_wrap", [True, False])
@pytest.mark.parametrize("kind", ROW_BLOCK_KERNELS)
@pytest.mark.parametrize("shape,w,o", [((256, 320), 32, 16), ((200, 264), 64, 32),
                                       ((96, 120), 8, 4)])
def test_row_blocks_equal_the_rows_of_the_full_launch(card, shape, w, o, kind,
                                                      flat_wrap):
    """Every resampling kernel on blocks of window rows (``row_start``/
    ``n_rows_local``, the clamped blocks of ``ShardedPIV``): bit-equal to the
    same rows of the full launch and to the plain version on the block."""
    from torchpiv_tpu_torch.parallel.sharded import _block_layout

    g = torch.Generator().manual_seed(w)
    R = (shape[0] - w) // (w - o) + 1
    C = (shape[1] - w) // (w - o) + 1
    frame = (torch.rand(2, *shape, generator=g) * 255).round().to(card)
    maps = [(torch.rand(2, R * C, generator=g) * 2 * w - w).to(card) for _ in range(2)]
    maps += [((torch.rand(2, R * C, generator=g) * 2 - 1) * 0.05).to(card)
             for _ in range(4)]
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, flat_wrap=flat_wrap)
    if kind.startswith("def"):
        kw.update(margin=2, interp="bicubic" if kind == "def-bicubic" else "bilinear")

        def run(device, rows, n):
            sel = [m[:, rows * C:(rows + n) * C].to(device) for m in maps]
            return def_windows(frame.to(device), *sel, row_start=rows,
                               n_rows_local=n, **kw)
    else:
        if kind == "bicubic":
            kw.update(interp="bicubic")
        elif kind != "rolls":
            kw.update(variant=kind)

        def run(device, rows, n):
            sel = [m[:, rows * C:(rows + n) * C].to(device) for m in maps[:2]]
            return shift_windows(frame.to(device), *sel, row_start=rows,
                                 n_rows_local=n, **kw)
    full = run(card, 0, R)
    for n_blocks in (2, 3, 4):
        rloc, origins, _ = _block_layout(R, n_blocks)
        for r0 in origins.tolist():
            got = run(card, r0, rloc)
            assert torch.equal(got, full[:, r0 * C:(r0 + rloc) * C])
            assert torch.equal(got.cpu(), run("cpu", r0, rloc))


@pytest.mark.parametrize("axes,n_dev", [({"pairs": 1}, 1), ({"pairs": 2}, 2),
                                        ({"pairs": 1, "windows": 2}, 2),
                                        ({"pairs": 2, "windows": 2}, 4)])
def test_mesh_on_one_card(card, tmp_path, axes, n_dev):
    """``OfflinePIV(mesh=)`` over the one card named ``n_dev`` times: a pair
    split bit-equal to the unsharded run, a window split within the parity
    budget, each shard launching its shift kernel on its rows."""
    from torchpiv_tpu_torch.kernels.shift import shift_windows as counted
    from torchpiv_tpu_torch.parallel import make_mesh

    for i in range(5):
        fa, fb = particle_pair((256, 256), (3.3, -2.1), seed=60 + i)
        imwrite_gray(str(tmp_path / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(tmp_path / f"p{i}_b.bmp"), fb)
    kw = dict(wind_size=64, overlap=32, multipass=2, batch_size=2)
    want = list(OfflinePIV(str(tmp_path), **kw)())
    dev = torch.device("cuda", torch.cuda.current_device())
    piv = OfflinePIV(str(tmp_path), mesh=make_mesh(axes, [dev] * n_dev), **kw)
    counted.launches = 0
    got = list(piv())
    assert len(got) == len(want) == 5
    batch = piv._batch
    n_batches = -(-5 // batch)
    assert counted.launches == 2 * axes["pairs"] * axes.get("windows", 1) * n_batches
    for i, ((x0, y0, u0, v0), (x1, y1, u1, v1)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(x0, x1)
        # the same batches of two through the same engine: bit-equal (the
        # padded last batch and one-pair shards are other shapes)
        if axes == {"pairs": 1} and i < 4:
            np.testing.assert_array_equal(u0, u1)
            np.testing.assert_array_equal(v0, v1)
        else:
            assert np.sqrt(np.mean(((u0 - u1) / 1000.0) ** 2)) < 0.01
            assert np.sqrt(np.mean(((v0 - v1) / 1000.0) ** 2)) < 0.01


def test_mesh_background_on_one_card(card, tmp_path):
    """``background="auto"`` over a one-device mesh (subtracted on the host
    by the decode workers) bit-equal to the unsharded run (subtracted on the
    card), batch for batch."""
    from torchpiv_tpu_torch.parallel import make_mesh

    glare = np.random.default_rng(5).uniform(0, 60, (256, 256)).astype(np.uint8)
    for i in range(4):
        fa, fb = particle_pair((256, 256), (3.0 - 0.5 * i, 1.0), seed=80 + i)
        for tag, f in (("a", fa), ("b", fb)):
            imwrite_gray(str(tmp_path / f"p{i}_{tag}.bmp"),
                         np.clip(f.astype(int) + glare, 0, 255).astype(np.uint8))
    kw = dict(wind_size=64, overlap=32, multipass=2, batch_size=2, background="auto")
    want = list(OfflinePIV(str(tmp_path), **kw)())
    dev = torch.device("cuda", torch.cuda.current_device())
    got = list(OfflinePIV(str(tmp_path), mesh=make_mesh({"pairs": 1}, [dev]), **kw)())
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---- the dtype knob on the kernel paths -------------------------------------

@pytest.mark.parametrize("kw", [
    dict(multipass_mode="CWS"), dict(multipass_mode="DWS"),
    dict(multipass_mode="DEF"), dict(multipass_mode="DEF", peakfit="pallas"),
    dict(multipass_mode="CWS", cws_interp="bicubic"),
    dict(multipass_mode="CWS", fused="split"), dict(multipass_mode="CWS", fused="on"),
    dict(multipass_mode="CWS", shift_variant="phases"),
], ids=lambda kw: "-".join(kw.values()))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float64"])
def test_cuda_engine_dtype_matches_cpu_engine(card, dtype, kw):
    """The rounding of ``dtype`` on the card and on the CPU, on float-valued
    frames that the low-precision types round."""
    flow = shear_flow(1.0, 0.01) if kw["multipass_mode"] == "DEF" else (3.3, -2.1)
    fa, fb = particle_pair((512, 512), flow, seed=9)
    fa, fb = (torch.from_numpy((f * 0.731).astype(np.float32)) for f in (fa, fb))
    cfg = PIVConfig(frame_shape=(512, 512), wind_size=64, overlap=32,
                    multipass=2, dtype=dtype, **kw)
    cu, cv, ci = (t.cpu().numpy() for t in MultipassPIV(cfg, device=card)(fa, fb))
    pu, pv, pi = (t.numpy() for t in MultipassPIV(cfg, device="cpu")(fa, fb))
    assert np.mean(ci != pi) < 0.02
    both = ~(ci | pi)
    assert np.sqrt(np.mean((cu - pu)[both] ** 2)) < 0.01
    assert np.sqrt(np.mean((cv - pv)[both] ** 2)) < 0.01


# ---- the streaming front ends, the runner and the service -------------------

STREAM_KW = dict(wind_size=32, overlap=16, multipass=2)


def _within_budget(got, want):
    assert len(got) == len(want)
    for (gx, gy, gu, gv), (wx, wy, wu, wv) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
        d = np.abs(np.concatenate([(gu - wu).ravel(), (gv - wv).ravel()])) / 1000.0
        assert np.sqrt(np.mean(d ** 2)) < 0.01 and (d > 0.01).mean() < 0.02


def _online(folder, device, n):
    from torchpiv_tpu_torch import OnlinePIV

    folder.mkdir()
    piv = OnlinePIV(str(folder), device=device, poll_interval=0.02, idle_timeout=30.0,
                    catchup_batch=2, frame_shape=(256, 256), **STREAM_KW)
    _write_pairs(folder, n)  # before the first poll: catch-up chunks
    fields = []
    for res in piv():
        fields.append(res)
        if len(fields) == n:
            piv.stop()
    return piv, fields


def test_online_piv_on_the_card(card, tmp_path):
    before = shift_windows.launches
    piv, fields = _online(tmp_path / "card", "auto", 5)
    assert piv.engine.device.type == "cuda"
    assert dict(piv.dispatches) == {"warm": 2, "catchup": 2, "single": 1}
    assert shift_windows.launches == before + 2 * 5  # two a call
    _, want = _online(tmp_path / "cpu", "cpu", 5)
    _within_budget(fields, want)


def test_video_piv_on_the_card(card, tmp_path, monkeypatch):
    """Through the video stand-in of ``chip_smoke.py`` (the card's machine
    may have no OpenCV), a short last batch: the CPU's fields."""
    from torchpiv_tpu_torch import VideoPIV
    from torchpiv_tpu_torch.io import video as video_mod

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    frames = [f for i in range(3) for f in particle_pair((256, 256), (3.3, -2.1),
                                                         seed=70 + i)]
    monkeypatch.setattr(video_mod, "cv2", smoke.video_stand_in({"v.avi": frames}))
    runs = {}
    for device in ("auto", "cpu"):
        piv = VideoPIV("v.avi", device=device, folder_mode="pairs", batch_size=2,
                       **STREAM_KW)
        before = shift_windows.launches
        runs[device] = list(piv())
        assert len(runs[device]) == 3
    assert shift_windows.launches == before  # the CPU run launched nothing
    _within_budget(runs["auto"], runs["cpu"])


def test_service_on_the_card(card, monkeypatch):
    """The HTTP handler threads run the engine on the card; a burst of
    three in two calls (``TPIV_SERVE_SCAN_B=2``), one pair, the CPU's fields."""
    from torchpiv_tpu_torch.client import PIVClient
    from torchpiv_tpu_torch.serve import PIVService, make_server

    monkeypatch.setenv("TPIV_SERVE_SCAN_B", "2")
    pairs = [particle_pair((256, 256), (3.3, -2.1), seed=80 + i) for i in range(3)]
    a, b = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    service = PIVService(**STREAM_KW)
    srv = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        client = PIVClient("http://%s:%d" % srv.server_address)
        before = shift_windows.launches
        burst = client.analyze_burst(a, b)
        single = client.analyze(a[0], b[0])
        assert shift_windows.launches == before + 2 * 3
        assert client.health()["device"].startswith("cuda")
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    want = PIVService(device="cpu", **STREAM_KW).analyze_batch(a, b)
    assert not burst["skipped_pairs"].any()
    _within_budget([(burst["x"], burst["y"], burst["u"][i], burst["v"][i]) for i in range(3)],
                   [(want["x"], want["y"], want["u"][i], want["v"][i]) for i in range(3)])
    # one pair a call and three: the same field within the budget
    _within_budget([single[:4]], [(burst["x"], burst["y"], burst["u"][0], burst["v"][0])])


def test_runner_on_the_card(card, tmp_path):
    from torchpiv_tpu_torch.pipeline import PIVRunner
    from torchpiv_tpu_torch.utils.config import PIVParams

    _write_pairs(tmp_path, 4)
    tables = {}
    for device in ("auto", "cpu"):
        params = PIVParams(folder=str(tmp_path), device=device, **STREAM_KW)
        tables[device] = PIVRunner(params, batch_size=2).run()
    for key in ("Vx[m/s]", "Vy[m/s]"):
        d = np.abs(tables["auto"][key] - tables["cpu"][key]) / 1000.0
        assert np.sqrt(np.mean(d ** 2)) < 0.01
    np.testing.assert_array_equal(tables["auto"]["x[mm]"], tables["cpu"]["x[mm]"])


# ---- the other device-path models: EnsemblePIV, MultiDtPIV, FolkiPIV, PTV,
# the quality maps, the SAD matchers, the particle detector and the blur ------

MODEL_SHAPE = (256, 256)


def test_gaussian_blur_and_sad_on_the_card(card):
    from torchpiv_tpu_torch.ops.filters import gaussian_blur
    from torchpiv_tpu_torch.ops.sad import fast_sad, sad_fft

    fa, fb = particle_pair(MODEL_SHAPE, (3.3, -2.1), seed=21)
    a, b = torch.from_numpy(fa), torch.from_numpy(fb)
    for sigma, truncate in ((1.0, 3.0), (1.3, 2.5)):
        got = gaussian_blur(a.to(card).float(), sigma, truncate).cpu()
        assert (got - gaussian_blur(a.float(), sigma, truncate)).abs().max() <= 1e-5 * 255
    wa, wb = extract_windows(a, 32, 16), extract_windows(b, 32, 16)
    for g, w in zip(fast_sad(wa.to(card), wb.to(card)), fast_sad(wa, wb)):
        assert (g.cpu() - w).abs().max() <= 1e-5
    got, want = sad_fft(wa.to(card), wb.to(card)).cpu(), sad_fft(wa, wb)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_blur_refuses_tf32(card, monkeypatch):
    from torchpiv_tpu_torch.ops.filters import gaussian_blur

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        gaussian_blur(torch.zeros(8, 8, device=card), 1.0)


def test_detect_particles_on_the_card(card):
    from torchpiv_tpu_torch.ops.particles import detect_particles

    frames = torch.from_numpy(np.stack(particle_pair(MODEL_SHAPE, (2.3, -1.2),
                                                     density=0.01, seed=22)))
    got = [t.cpu() for t in detect_particles(frames.to(card), 2048, 3, smooth_sigma=1.3)]
    want = detect_particles(frames, 2048, 3, smooth_sigma=1.3)
    for i in range(2):
        g = sorted(zip(got[1][i][got[3][i]].tolist(), got[0][i][got[3][i]].tolist()))
        w = sorted(zip(want[1][i][want[3][i]].tolist(), want[0][i][want[3][i]].tolist()))
        assert len(g) == len(w) > 100
        assert np.abs(np.array(g) - np.array(w)).max() <= 1e-4


@pytest.mark.parametrize("fit", ["xla", "pallas"])
def test_ensemble_on_the_card(card, fit):
    from torchpiv_tpu_torch.models import EnsemblePIV

    pairs = [particle_pair(MODEL_SHAPE, (3.3, -2.1), density=0.002, seed=230 + i)
             for i in range(4)]
    A = torch.from_numpy(np.stack([p[0] for p in pairs]))
    B = torch.from_numpy(np.stack([p[1] for p in pairs]))
    cfg = PIVConfig(frame_shape=MODEL_SHAPE, wind_size=64, overlap=32, multipass=1,
                    peakfit=fit)
    em = EnsemblePIV(cfg, device=card)
    peakfit.launches = 0
    cu, cv, ci = (t.cpu().numpy() for t in em(A, B))
    assert peakfit.launches == (1 if fit == "pallas" else 0)
    pu, pv, pi = (t.numpy() for t in EnsemblePIV(cfg, device="cpu")(A, B))
    np.testing.assert_array_equal(ci, pi)
    assert np.abs(cu - pu)[~ci].max() <= 1e-4 and np.abs(cv - pv)[~ci].max() <= 1e-4


def test_multidt_on_the_card(card):
    from torchpiv_tpu_torch.models import MultiDtPIV
    from torchpiv_tpu_torch.utils.synthetic import render_particles

    rng = np.random.default_rng(4)
    n = int(0.02 * 256 * 256)
    xs, ys, inten = rng.uniform(0, 256, n), rng.uniform(0, 256, n), rng.uniform(100, 220, n)
    frames = np.stack([np.clip(render_particles(MODEL_SHAPE, xs + 0.8 * t, ys, inten), 0, 255)
                       .astype(np.uint8) for t in range(5)])
    cfg = PIVConfig(frame_shape=MODEL_SHAPE, wind_size=64, overlap=32, multipass=2)
    shift_windows.launches = 0
    got = MultiDtPIV(cfg, device=card)(frames, 0)
    assert shift_windows.launches == 2  # one batched engine call
    want = MultiDtPIV(cfg, device="cpu")(frames, 0)
    assert np.mean(got.invalid != want.invalid) < 0.02
    both = ~(got.invalid | want.invalid)
    assert np.sqrt(np.mean((got.u - want.u)[both] ** 2)) < 0.01
    assert np.mean(got.dt_map == want.dt_map) >= 0.98


@pytest.mark.parametrize("hybrid", [False, True])
def test_folki_on_the_card(card, hybrid):
    from torchpiv_tpu_torch.models import FolkiPIV, folki_flow

    disp = (11.0, 0.0) if hybrid else (3.3, -2.1)
    fa, fb = particle_pair(MODEL_SHAPE, disp, seed=23, density=0.02)
    cfg = (PIVConfig(frame_shape=MODEL_SHAPE, wind_size=64, overlap=32, multipass=2)
           if hybrid else None)
    if not hybrid:
        a, b = torch.from_numpy(fa), torch.from_numpy(fb)
        du, dv = (t.cpu() for t in folki_flow(a.to(card), b.to(card), levels=3))
        pu, pv = folki_flow(a, b, levels=3)
        assert ((du - pu) ** 2).mean().sqrt() <= 1e-3 and ((dv - pv) ** 2).mean().sqrt() <= 1e-3
    got = FolkiPIV(MODEL_SHAPE, 32, 16, piv_config=cfg, device=card)(fa, fb)
    want = FolkiPIV(MODEL_SHAPE, 32, 16, piv_config=cfg, device="cpu")(fa, fb)
    for g, w in zip(got[:2], want[:2]):
        assert np.sqrt(np.mean((g - w) ** 2)) <= 1e-3
    assert np.mean(got[2] != want[2]) <= 0.02


@pytest.mark.parametrize("guided", [False, True])
def test_ptv_on_the_card(card, guided):
    from torchpiv_tpu_torch.models import PTV

    fa, fb = particle_pair(MODEL_SHAPE, (3.3, -2.1), density=0.01, seed=24)
    cfg = (PIVConfig(frame_shape=MODEL_SHAPE, wind_size=64, overlap=32, multipass=2)
           if guided else None)
    mask = np.zeros(MODEL_SHAPE, bool)
    mask[:, :64] = True
    for m in (None, mask):
        got = PTV(MODEL_SHAPE, piv_config=cfg, max_particles=2048, frame_mask=m,
                  device=card)(fa, fb)
        want = PTV(MODEL_SHAPE, piv_config=cfg, max_particles=2048, frame_mask=m,
                   device="cpu")(fa, fb)
        assert (got.n_a, got.n_b) == (want.n_a, want.n_b)
        g = {(round(float(x), 3), round(float(y), 3)): u for x, y, u in zip(got.x, got.y, got.u)}
        w = {(round(float(x), 3), round(float(y), 3)): u for x, y, u in zip(want.x, want.y, want.u)}
        common = set(g) & set(w)
        assert len(common) >= 0.99 * max(len(g), len(w)) > 50
        assert max(abs(g[k] - w[k]) for k in common) <= 1e-4
        if m is not None:
            assert (got.x >= 63.5).all()


def test_quality_maps_on_the_card(card):
    from torchpiv_tpu_torch.stats import quality

    fa, fb = particle_pair(MODEL_SHAPE, (3.3, -2.1), seed=25)
    for name in ("snr_map", "peak_width_map", "uncertainty_map"):
        got = getattr(quality, name)(fa, fb, 64, 32, device=card)
        want = getattr(quality, name)(fa, fb, 64, 32, device="cpu")
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            fin = np.isfinite(w)
            assert (np.abs(g[fin] - w[fin]) <= 1e-4 * np.abs(w[fin])).all()


# ---- the command line on the card -------------------------------------------

def test_cli_run_on_the_card(card, tmp_path, monkeypatch):
    """``tpiv-torch run --multipass 2`` with no ``--device`` runs on the card
    (row 1 launched) and its per-pair tables equal ``--device cpu``'s within
    the parity budget."""
    from torchpiv_tpu_torch.cli import main
    from torchpiv_tpu_torch.utils.persistence import load_table

    monkeypatch.setenv("TORCHPIV_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    frames = tmp_path / "frames"
    frames.mkdir()
    _write_pairs(frames, 4)
    tables = {}
    for device in ("auto", "cpu"):
        shift_windows.launches = 0
        out = tmp_path / device
        assert main(["run", str(frames), "--device", device, "--wind-size", "32",
                     "--overlap", "16", "--multipass", "2", "--save",
                     "Save all text", "--save-dir", str(out)]) == 0
        assert (shift_windows.launches > 0) == (device == "auto")
        tables[device] = [load_table(str(p)) for p in sorted(out.glob("*_pair*.txt"))]
    fields = {d: [tuple(t[k] for k in ("x[mm]", "y[mm]", "Vx[m/s]", "Vy[m/s]"))
                  for t in ts] for d, ts in tables.items()}
    assert len(fields["auto"]) == 4
    _within_budget(fields["auto"], fields["cpu"])


def test_cli_doctor_on_the_card(card, capsys):
    """Every check of ``tpiv-torch doctor`` passes on the card, the build
    cache round trip included."""
    from torchpiv_tpu_torch.cli import main

    rc = main(["doctor", "--bandwidth-mb", "16", "--cache"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "8/8 checks passed" in out and "using cuda:" in out
    assert "second: loaded from disk (wrote 0)" in out


# ---- the JAX engine's XLA resampling paths ----------------------------------

XLA_FUNCTIONS = [("cws_shift", False), ("cws_shift", True), ("bicubic_cws_shift", False),
                 ("bicubic_cws_shift", True), ("dws_shift", False),
                 ("def_windows_xla", False)]


@pytest.mark.parametrize("name,per_pixel", XLA_FUNCTIONS)
def test_xla_paths_on_the_card_match_the_cpu(card, name, per_pixel):
    """The XLA-semantics torch ops on the card against the same ops on the
    CPU, within 1e-4 of a grey level: shifts past ``w/2`` and out of the
    frame, three columns of them integer."""
    from torchpiv_tpu_torch.ops import shifts
    from torchpiv_tpu_torch.ops.deform import def_windows_xla
    from torchpiv_tpu_torch.ops.geometry import per_window_origins

    (H, W), w, o = (200, 264), 32, 16
    r0, c0 = (torch.from_numpy(t) for t in per_window_origins((H, W), w, o))
    g = torch.Generator().manual_seed(3)
    frames = (torch.rand(2, H, W, generator=g) * 255).round()
    shape = (2, r0.numel(), w, w) if per_pixel else (2, r0.numel())
    maps = [torch.randn(*shape, generator=g) * 24 for _ in range(2)]
    maps[0][..., :3] = maps[0][..., :3].round()
    if name == "def_windows_xla":
        maps += [torch.rand(*shape, generator=g) * 0.4 - 0.2 for _ in range(4)]
        fn = def_windows_xla
    else:
        fn = getattr(shifts, name)
    want = fn(frames, r0, c0, w, *maps)
    got = fn(frames.to(card), r0.to(card), c0.to(card), w, *(m.to(card) for m in maps))
    assert got.device.type == "cuda" and got.shape == want.shape
    assert torch.allclose(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw,launches", [
    (dict(wind_size=256, overlap=128, multipass_mode="DEF"), {}),
    (dict(wind_size=256, overlap=128, cws_interp="bicubic"), {}),
    (dict(wind_size=512, overlap=256, multipass=3), {"shift_windows": 2}),
    (dict(wind_size=250, overlap=124, cws_interp="bicubic"), {"shift_windows_bicubic": 2}),
    (dict(wind_size=248, overlap=124, multipass_mode="DEF"), {"def_windows": 2}),
    (dict(wind_size=64, overlap=32, use_pallas="off"), {}),
    (dict(wind_size=64, overlap=32, use_pallas="off", fused="split"),
     {"correlate_peakfit": 2}),
], ids=["def-256", "bicubic-256", "cws-512-x3", "bicubic-125", "def-tile-129",
        "off", "off-split"])
def test_xla_path_launch_counts(card, kw, launches):
    """Beyond the kernels' limits (and under ``use_pallas="off"``) the
    resampling kernels never launch; within them each launches once a frame
    and pass, the limit cases too (a 125 px bicubic window, a 129 px DEF
    tile)."""
    from torchpiv_tpu_torch.kernels import KERNELS

    cfg = PIVConfig(**{"frame_shape": (1024, 1024), "multipass": 2, **kw})
    flow = shear_flow(1.0, 0.004) if cfg.multipass_mode == "DEF" else (3.3, -2.1)
    fa, fb = (torch.from_numpy(f) for f in particle_pair((1024, 1024), flow, seed=4))
    engine = MultipassPIV(cfg, device=card)
    for k in KERNELS:
        k.launches = 0
    u, _, inval = engine(fa, fb)
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in KERNELS}
    assert counts == {**dict.fromkeys(counts, 0), **launches}
    assert (~inval).float().mean() > 0.9


@pytest.mark.parametrize("kw", [
    dict(multipass_mode="CWS"), dict(multipass_mode="DWS"), dict(multipass_mode="DEF"),
    dict(multipass_mode="CWS", cws_interp="bicubic"),
    dict(multipass_mode="CWS", fused="split"), dict(multipass_mode="CWS", peakfit="pallas"),
], ids=lambda kw: "-".join(kw.values()))
def test_cuda_engine_off_matches_cpu_engine(card, kw):
    """``use_pallas="off"`` on the card against the CPU engine: the parity
    budget."""
    flow = shear_flow(1.0, 0.01) if kw["multipass_mode"] == "DEF" else (3.3, -2.1)
    fa, fb = (torch.from_numpy(f) for f in particle_pair((512, 512), flow, seed=9))
    cfg = PIVConfig(frame_shape=(512, 512), wind_size=64, overlap=32, multipass=2,
                    use_pallas="off", **kw)
    cu, cv, ci = (t.cpu().numpy() for t in MultipassPIV(cfg, device=card)(fa, fb))
    pu, pv, pi = (t.numpy() for t in MultipassPIV(cfg, device="cpu")(fa, fb))
    assert np.mean(ci != pi) < 0.02
    both = ~(ci | pi)
    assert both.mean() > 0.5
    assert np.sqrt(np.mean((cu - pu)[both] ** 2)) < 0.01
    assert np.sqrt(np.mean((cv - pv)[both] ** 2)) < 0.01
