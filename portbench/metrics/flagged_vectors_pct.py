"""The engine's ``flagged`` counter (the final field's invalid vectors,
counted on the device) over the final-grid vectors, summed over the
window's calls (``lib/stages.py``); None where those calls hold no device
time."""
from portbench.lib.stages import window_calls


def read(rec):
    got = window_calls(rec)
    if got is None:
        return None
    vectors = sum(c.vectors for c in got)
    return 100.0 * sum(c.counts.get("flagged", 0) for c in got) / vectors
