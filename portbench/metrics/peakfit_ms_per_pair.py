"""Device ms a pair of the engine's ``piv.passN.peakfit`` spans: the
sub-pixel fit, peak-ratio validation and second-peak candidates of the
unfused chain, over the window's calls (``lib/stages.py``)."""
from portbench.lib.stages import stage_ms_per_pair


def read(rec):
    return stage_ms_per_pair(rec, ("peakfit",))
