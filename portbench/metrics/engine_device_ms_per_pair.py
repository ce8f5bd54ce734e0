"""CUDA events on the stream around each ``pipeline.packed_forward`` of
the window, summed, over the pairs of those calls (staged mixes)."""


def read(rec):
    spans = [s for s in rec.spans or () if s["device_ms"] is not None]
    pairs = sum(s["pairs"] for s in spans)
    return sum(s["device_ms"] for s in spans) / pairs if pairs else None
