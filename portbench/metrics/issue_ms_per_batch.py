"""Host clock around each ``pipeline.packed_forward`` of the window (it
returns before the card is done), the mean over the window's calls
(staged mixes)."""


def read(rec):
    spans = rec.spans or ()
    return 1000.0 * sum(s["issue_s"] for s in spans) / len(spans) if spans else None
