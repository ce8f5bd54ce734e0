"""GUI layer (counterpart of ``torchpiv_tpu/gui``): headless matplotlib
visualisation core (`viz`) plus the optional PyQt5 application
(`app.runGUI`).  Importing this package never requires Qt; only launching
the GUI does."""

from . import viz  # noqa: F401


def runGUI():
    from .app import runGUI as _run

    _run()


__all__ = ["runGUI", "viz"]
