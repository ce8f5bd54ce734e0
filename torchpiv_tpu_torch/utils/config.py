"""Run configuration with JSON round-trip (copy of
``torchpiv_tpu/utils/config.py``; ``device`` defaults to ``"auto"``, the
CUDA card, where the JAX package's defaults to ``"tpu"``).

Same 14-key schema as the reference's ``PIVparams`` singleton
(``PlotterFunctions.py:113-173``) so existing settings.json files load
unchanged — but stored in the user config dir
(~/.torchpiv_tpu/settings.json) instead of inside the installed package, and
implemented as a mutable dataclass rather than class-attribute mutation.

One key beyond the reference schema: ``extras``, a free-form dict where
the GUI persists its beyond-reference run options (ROI mask path,
preprocess, correlation estimator, smoothing, vector rescue).  Both this
loader and the reference's ignore unknown keys (:143-157 semantics), so
settings files remain interchangeable in either direction.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


def _default_settings_path() -> str:
    base = os.environ.get(
        "TORCHPIV_TPU_CONFIG_DIR",
        os.path.join(os.path.expanduser("~"), ".torchpiv_tpu"),
    )
    return os.path.join(base, "settings.json")


@dataclasses.dataclass
class PIVParams:
    wind_size: int = 64
    overlap: int = 32
    scale: float = 1.0  # mm per pixel
    dt: float = 1.0  # microseconds between frames
    device: str = "auto"
    multipass: int = 1
    file_fmt: str = ".bmp"
    save_opt: str = "Dont save"
    save_dir: str = ""
    multipass_scale: float = 2.0
    folder: str = ""
    regime: str = "offline"  # "offline" | "online"
    multipass_mode: str = "CWS"
    folder_mode: str = "pairs"  # "pairs" | "sequential"
    # beyond-reference GUI/runner options (see module docstring)
    extras: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_json(cls, path: Optional[str] = None) -> "PIVParams":
        """Load settings; unknown keys are ignored, missing keys keep their
        defaults (reference from_json semantics, :143-157)."""
        path = path or _default_settings_path()
        params = cls()
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            fields = {f.name for f in dataclasses.fields(cls)}
            for key, val in data.items():
                if key in fields:
                    setattr(params, key, val)
        return params

    def to_json(self, path: Optional[str] = None) -> str:
        path = path or _default_settings_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f)
        return path
