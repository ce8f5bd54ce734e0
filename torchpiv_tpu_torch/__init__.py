"""PyTorch/CUDA port of the torchpiv-tpu PIV engine.

The same ``PIVConfig``, ``MultipassPIV`` and ``OfflinePIV`` contracts as the
JAX package ``torchpiv_tpu``, on an NVIDIA card: plain tensor code is
PyTorch (cuFFT through ``torch.fft``), and the TPU's Pallas window-shift
kernel is a hand-written CUDA kernel (``kernels/csrc/shift_windows.cu``).
Entry points run on the CUDA device unless given ``device="cpu"``.
"""
from .config import PIVConfig
from .models.multipass import MultipassPIV
from .pipeline import OfflinePIV

__all__ = ["PIVConfig", "MultipassPIV", "OfflinePIV"]
