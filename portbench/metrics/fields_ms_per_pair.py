"""Device ms a pair of the engine's field operations: ``piv.input`` (the
frames' cast and mask), ``piv.passN.predict`` (upsample, half-shift,
zeroing, DEF gradients), ``piv.passN.guard`` (anti-divergence guards,
window mask) and ``piv.post`` (global filters, median, fallback, fused
infill), over the window's calls (``lib/stages.py``)."""
from portbench.lib.stages import stage_ms_per_pair


def read(rec):
    return stage_ms_per_pair(rec, ("input", "predict", "guard", "post"))
