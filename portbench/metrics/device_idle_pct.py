"""Share of the traced window with no kernel, copy or set on the card
(staged mixes)."""


def read(rec):
    t = rec.trace
    if rec.spans is None or t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
