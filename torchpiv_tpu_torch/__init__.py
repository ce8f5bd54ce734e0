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

__all__ = ["PIVConfig", "MultipassPIV", "OfflinePIV", "OnlinePIV", "VideoPIV",
           "PIVClient"]


def __getattr__(name):
    # the streaming front ends and the client load on first use, as in the
    # JAX package
    if name in ("OnlinePIV", "VideoPIV"):
        from . import pipeline

        return getattr(pipeline, name)
    if name == "PIVClient":
        from .client import PIVClient

        return PIVClient
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
