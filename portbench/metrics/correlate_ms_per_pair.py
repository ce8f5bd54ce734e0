"""Device ms a pair of the engine's ``piv.passN.correlate`` spans: window
weights and the FFT correlation (transforms, spectrum product, fftshift
roll), or the ``corrfit`` or ``fused_pass`` launch, over the window's
calls (``lib/stages.py``)."""
from portbench.lib.stages import stage_ms_per_pair


def read(rec):
    return stage_ms_per_pair(rec, ("correlate",))
