"""Set-up: from the interpreter's start of ``run.py`` to the window's
opening (imports, kernel loads or builds, the frames, the warm-up)."""


def read(rec):
    return rec.setup_s
