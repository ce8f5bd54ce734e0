"""The ``"lanephases"`` window shift on the CPU: the step model of the ring
of shared-memory stages fed by the copy engine (``tma_ring_steps`` in
``tools/lanephases_ring_cuda.py``, the design measured against the
package's kernel) and the lane model of the package's kernel
(``warp_window_steps``: ``warp_bilinear.cuh``'s body on the float32 frame),
each equal bit for bit to ``blend_reference_variant(..., "lanephases")`` at
every lane map, against the right and bottom edges, with shifts integer in
one axis, on padded widths that are and are not a multiple of 4; the model
raises on a wrong ring or a read past the tile; the wrapper hands the
kernel the padded frame itself.  The kernel and the ring themselves are
held against the plain version on a card in ``test_torch_cuda.py``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from torchpiv_tpu_torch.kernels.shift import variant_frame
from torchpiv_tpu_torch.ops.shifts import (blend_reference_variant, shift_operands,
                                           warp_window_steps)

_spec = importlib.util.spec_from_file_location(
    "lanephases_ring_cuda", Path(__file__).resolve().parents[1] / "tools"
    / "lanephases_ring_cuda.py")
ring = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ring)

WIDTHS = (4, 16, 31, 32, 64, 128)
KINDS = ("fractional", "integer", "mixed", "edges")


def _operands(w, kind, odd, seed=0, batch=2):
    """Float-valued frames whose padded width is (``odd``) or is not a
    multiple of 4, a grid with a ragged last item a row, and shifts of
    ``kind``: uniform past the clamp, rounded, rounded in x only, or all
    past the clamp to the right and bottom."""
    o = w // 2
    step = w - o
    G = ring.warp_lanes(w)[0]
    Wf = w + step * (32 // G + 1)
    Wp = Wf + 2 * max(w // 2, 1)
    Wf += (1 - Wp % 2) if odd else -Wp % 4
    shape = (w + 3 * step - 1, Wf)
    n = ((shape[0] - w) // step + 1) * ((Wf - w) // step + 1)
    rng = np.random.default_rng(seed + w)
    frame = rng.uniform(0, 255, (batch, *shape)).astype(np.float32)
    vx = rng.uniform(-1.5 * w, 1.5 * w, (batch, n)).astype(np.float32)
    vy = rng.uniform(-1.5 * w, 1.5 * w, (batch, n)).astype(np.float32)
    if kind == "integer":
        vx, vy = np.round(vx), np.round(vy)
    elif kind == "mixed":
        vx = np.round(vx)
    elif kind == "edges":
        vx, vy = np.abs(vx) + 0.25 * w, np.abs(vy) + 0.25 * w
    ops = shift_operands(*(torch.from_numpy(a) for a in (frame, vx, vy)),
                         frame_shape=shape, wind_size=w, overlap=o)
    assert (ops.frame.shape[-1] % 4 == 0) != odd
    return ops


@pytest.mark.parametrize("odd", [False, True], ids=["Wp4", "Wp_odd"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("w", WIDTHS)
def test_ring_model_equals_the_plain_version(w, kind, odd):
    ops = _operands(w, kind, odd)
    want = blend_reference_variant(ops, w, "lanephases")
    for resident in (1, 5, 1000):  # one long run; several; one item a warp
        assert torch.equal(ring.tma_ring_steps(ops, w, resident_warps=resident), want)


@pytest.mark.parametrize("odd", [False, True], ids=["Wp4", "Wp_odd"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("w", WIDTHS)
def test_register_body_model_equals_the_plain_version(w, kind, odd):
    """The package's kernel: warp_bilinear.cuh's lanes on the float32
    frame, which is also the ``rolls`` kernel's function."""
    ops = _operands(w, kind, odd, seed=1)
    want = blend_reference_variant(ops, w, "lanephases")
    assert torch.equal(warp_window_steps(ops, w), want)
    assert torch.equal(want, blend_reference_variant(ops, w, "rolls"))


@pytest.mark.parametrize("w", [4, 32, 64])
def test_ring_model_catches_a_wrong_ring(w):
    """A stage refilled one item early or one late is read before its
    phase completes with its own tile, and a lane reading one column past
    the tile is caught (runs longer than the ring: eight frames)."""
    ops = _operands(w, "fractional", False, batch=8)
    D = ring.ring_plan(w)["depth"]
    for ahead in (D - 1, D + 1):
        with pytest.raises(RuntimeError, match="before its phase"):
            ring.tma_ring_steps(ops, w, resident_warps=1, _lookahead=ahead)
    with pytest.raises(RuntimeError, match="past the tile"):
        ring.tma_ring_steps(ops, w, resident_warps=1, _last_column=w)


def test_ring_plan_fits_a_block():
    """Every window size the variant takes has a ring of at least two
    stages that fits a block, the committed depth and warps at the main
    path's w = 32."""
    for w in range(1, 129):
        pl = ring.ring_plan(w)
        assert pl["depth"] >= 2 and pl["warps"] >= 1
        assert pl["smem"] + 64 * pl["warps"] <= ring.RING_SMEM_MAX
        assert pl["box_w"] % 4 == 0 and pl["box_w"] >= w + 4
    assert (ring.ring_plan(32)["depth"], ring.ring_plan(32)["warps"]) == \
        (ring.RING_DEPTH, ring.RING_WARPS)


@pytest.mark.parametrize("odd", [False, True], ids=["Wp4", "Wp_odd"])
def test_the_kernel_reads_the_padded_frame_itself(odd):
    ops = _operands(32, "fractional", odd)
    got = variant_frame(ops, "lanephases")
    assert got.data_ptr() == ops.frame.data_ptr() and got.shape == ops.frame.shape
