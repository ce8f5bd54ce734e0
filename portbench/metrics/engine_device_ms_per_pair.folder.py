"""``OfflinePIV.span_log``'s ``device_ms`` (CUDA events around the engine
on the feeder's stream), summed over the window's batches, over their
pairs."""


def read(rec):
    spans = [s for s in rec.span_log or () if s.get("device_ms") is not None]
    pairs = sum(s["pairs"] for s in spans)
    return sum(s["device_ms"] for s in spans) / pairs if pairs else None
