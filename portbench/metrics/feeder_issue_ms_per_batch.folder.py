"""``OfflinePIV.span_log``'s ``issue_s`` (host clock around the feeder's
background subtract and engine call), the mean over the window's
batches."""


def read(rec):
    spans = rec.span_log or ()
    return 1000.0 * sum(s["issue_s"] for s in spans) / len(spans) if spans else None
