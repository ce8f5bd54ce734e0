"""The yardstick of the kernel metrics: the table of peaks and the least
bytes of each resampling step, reckoned from the step's shapes and not from
any kernel's own traffic: the float32 frame read once, the per-window maps
read once, the windows written once at their store type.
"""
from __future__ import annotations

from typing import Optional

# published peaks by ``torch.cuda.get_device_name()``: NVIDIA's data sheet,
# SXM part at its 700 W limit, dense rates
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12,
                              "tf32_flops": 495e12, "bf16_flops": 989e12},
}


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)


def store_bytes(engine: dict) -> int:
    """Bytes a stored window sample takes: bfloat16 where the engine
    stores its windows so (the matmul DFT at default precision, no window
    weights), float32 otherwise."""
    narrow = (engine.get("correlator") == "matmul"
              and engine.get("dft_precision", "high") == "default"
              and engine.get("window_weight") is None)
    return 2 if narrow else 4


def refine_step_bytes(frame_shape, engine: dict, batch: int, n_maps: int):
    """Least bytes of one frame batch through each refine pass's resampling
    (``n_maps`` float32 maps a window: 2 for a shift, 6 for a deformation),
    a list over passes 2..n."""
    from ..reference.piv import schedule

    H, W = frame_shape
    out = []
    for w, o in schedule(engine)[1:]:
        step = w - o
        n = ((H - w) // step + 1) * ((W - w) // step + 1)
        out.append(batch * (H * W * 4 + n * n_maps * 4 + n * w * w * store_bytes(engine)))
    return out


def roofline_pct(trace: dict, words, bytes_per_launch: float, kind: str) -> Optional[float]:
    """The share, in %, of the kernels' measured time that moving their
    least bytes at the card's peak bandwidth would take; None where the
    trace has no such kernel or the card has no peak in the table."""
    from .trace import kernel_time

    bw = peak(kind, "hbm_bytes_per_s")
    sec, n = kernel_time(trace, words)
    if bw is None or n == 0 or sec <= 0:
        return None
    return 100.0 * (n * bytes_per_launch / bw) / sec
