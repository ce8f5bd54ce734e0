"""Device ms a pair of the engine's ``piv.passN.windows`` spans: window
extraction (pass 1), the shift or DEF resampling with its frame casts and
flat wrap (refine passes), over the window's calls (``lib/stages.py``)."""
from portbench.lib.stages import stage_ms_per_pair


def read(rec):
    return stage_ms_per_pair(rec, ("windows",))
