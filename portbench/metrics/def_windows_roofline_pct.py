"""The DEF window deformation's share of its bandwidth roofline: the
resampling step's least bytes (``lib/roofline.py``: the float32 frame, the
centre shift and its four gradients a window, the windows at their store
type) at the card's peak bandwidth, over the profiler's time of the
kernels named here."""
from portbench.lib.roofline import refine_step_bytes, roofline_pct

KERNELS = ("def_windows",)


def read(rec):
    cfg = rec.cell.config
    if rec.trace is None or cfg["engine"].get("multipass_mode") != "DEF":
        return None
    steps = refine_step_bytes(cfg["frame_shape"], cfg["engine"], cfg["batch"], 6)
    if not steps:
        return None
    return roofline_pct(rec.trace, KERNELS, sum(steps) / len(steps), rec.kind)
