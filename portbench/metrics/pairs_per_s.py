"""Fields that passed the host tail inside the window, over its seconds
(staged mixes)."""


def read(rec):
    if rec.spans is None:
        return None
    return rec.fields / rec.seconds
