"""Shared-state result store (Borg pattern; copy of
``torchpiv_tpu/utils/database.py``), mirroring the reference's
``Database`` (``PlotterFunctions.py:175-199``): a
process-wide dict of named result fields that UI/plot layers read and the
runner writes, plus re-loading of saved CSV tables."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .persistence import load_table


class Database:
    _shared_state: dict = {}

    def __init__(self):
        self.__dict__ = self._shared_state
        if "_data" not in self.__dict__:
            self._data: Dict[str, np.ndarray] = {}
            self.name = ""

    def get(self) -> Dict[str, np.ndarray]:
        return self._data

    def set(self, data: Dict[str, np.ndarray]) -> None:
        self._data = data

    def load(self, path: str) -> None:
        self._data = load_table(path)
        name = os.path.basename(path)
        self.name, _ = os.path.splitext(name)
