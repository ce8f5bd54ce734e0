"""The engine's own call records (``torchpiv_tpu_torch.utils.profiling``):
which of them belong to the window, and their stage spans' device ms.

A staged run appends a span for every call issued after the window
opened and issues none after it closes, so its window's calls are the
last ``len(rec.spans)`` records.  The folder run's batches name their
call's record (``span_log``'s ``call``).  Where the program keeps no such
records, or they hold no device time (off CUDA), the readers find nothing
and return None.
"""
from __future__ import annotations

from typing import List, Optional


def window_calls(rec) -> Optional[List]:
    """The window's call records, or None."""
    try:
        from torchpiv_tpu_torch.utils import profiling
    except ImportError:
        return None
    calls = getattr(profiling, "calls", None)
    if calls is None:
        return None
    if rec.spans is not None:
        n = len(rec.spans)
        got = calls()[-n:] if n else []
        if len(got) != n:
            return None
    elif rec.span_log is not None:
        ids = {s.get("call") for s in rec.span_log} - {None}
        got = [c for c in calls() if c.id in ids] if ids else []
        if len(got) != len(ids) or len(ids) != len(rec.span_log):
            return None
    else:
        return None
    if not got or any(c.call is None or c.call.device_ms is None for c in got):
        return None
    return got


def stage_ms_per_pair(rec, stages) -> Optional[float]:
    """Device ms of the spans whose last name part is in ``stages`` (e.g.
    ``piv.pass2.windows`` -> ``windows``), summed over the window's calls,
    over their pairs."""
    got = window_calls(rec)
    if got is None:
        return None
    ms = sum(s.device_ms for c in got for s in c.spans
             if s.name.rsplit(".", 1)[-1] in stages)
    return ms / sum(c.pairs for c in got)
