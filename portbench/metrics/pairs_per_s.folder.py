"""Fields that ``OfflinePIV`` yielded inside the window, over its seconds
(the folder mix)."""


def read(rec):
    if rec.span_log is None:
        return None
    return rec.fields / rec.seconds
