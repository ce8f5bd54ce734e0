"""Host clock around each pair's tail (``pipeline.tail_of``: invalid
vectors NaN, infill, flip, units) on the drainer thread, the mean over the
window's pairs (staged mixes)."""


def read(rec):
    t = rec.tail_s or ()
    return 1000.0 * sum(t) / len(t) if t else None
