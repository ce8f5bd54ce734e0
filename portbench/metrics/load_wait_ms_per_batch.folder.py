"""``OfflinePIV.span_log``'s ``load_s`` (the feeder waiting for the
prefetcher's next batch: decode, pinned staging, H2D), the mean over the
window's batches."""


def read(rec):
    spans = rec.span_log or ()
    return 1000.0 * sum(s["load_s"] for s in spans) / len(spans) if spans else None
