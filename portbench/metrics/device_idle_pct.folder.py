"""Share of the traced window with no kernel, copy or set on the card
(the folder mix)."""


def read(rec):
    t = rec.trace
    if rec.span_log is None or t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
