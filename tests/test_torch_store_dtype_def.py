"""The window store type (``_window_store_dtype``) of the DEF refine pass
in the port's engine on the CPU against the JAX engine (its Pallas kernels
interpreted) under ``correlator="matmul"``, unfused and with
``fused="split"``, at ``dft_precision="default"`` (bfloat16 window stores)
beside ``"high"`` (float32) with one tolerance; the other modes are in
``test_torch_store_dtype_engine.py``, whose helper runs both engines.

Without the rounding at the store the port reads RMS 5.9e-4 px and 9.3e-3
px at the worst vector against the JAX engine at ``"default"`` (both DEF
and ``split``).  Tolerances, from DEF at ``"high"`` (RMS 5.5e-5 px, 2.1e-3
px at the worst vector: the interpreted DEF kernel's float32 residuals may
move a pixel across a cell, ``test_torch_deform.py``): invalid masks equal,
RMS below 2e-4 px and the largest difference below 3e-3 px."""
import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "store_dtype_engine", Path(__file__).with_name("test_torch_store_dtype_engine.py"))
_engine = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_engine)

CASES = {"DEF": dict(multipass_mode="DEF"),
         "DEF-split": dict(multipass_mode="DEF", fused="split")}


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_def_store_type_matches_jax_engine(case, precision):
    _engine.engines_agree(CASES[case], precision, (2e-4, 3e-3))
