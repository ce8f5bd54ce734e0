"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU;
without a card they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "auto") -> torch.device:
    """``"auto"``/``"default"``/``""``/``None``/``"cuda"`` -> the current
    CUDA device (raises ``RuntimeError`` naming ``device='cpu'`` when there
    is none); ``"cpu"`` or ``"cuda:<i>"`` (a ``torch.device`` or its
    ``str`` too) as given.  Any other name, ``"tpu"`` among them, raises
    ``ValueError``: a name is never mapped to another device."""
    auto = device is None or device in ("", "auto", "default")
    name = "cuda" if auto else str(device)
    platform, _, idx = name.partition(":")
    if name != "cpu" and not (platform == "cuda" and (idx == "" or idx.isdigit())):
        raise ValueError(f"unknown device {name!r}: the port takes 'auto', "
                         f"'cpu', 'cuda' and 'cuda:<i>'")
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r}: no CUDA device is available "
                f"(pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise ValueError(f"unknown device {name!r}: there are "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def check_no_tf32(device: torch.device) -> None:
    """Raise unless TF32 is off for float32 matmuls and cuDNN: a TF32
    predictor upsample flips CWS integer-crossing decisions."""
    if device.type != "cuda":
        return
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is on: set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.backends.cudnn.allow_tf32 = False before running the engine "
            "(the predictor upsample must be full float32)")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def script_device(device: Union[str, torch.device, None] = None):
    """The device of a script beside the package and the line that names
    it: ``device``, else ``TPIV_DEVICE``, else the card, resolved by
    :func:`resolve_device` (so without a card it raises unless the CPU was
    asked for).  On a card TF32 is switched off, as the engine needs, and
    the line is :func:`card_line`'s; on the CPU it is ``"cpu"``.  Returns
    ``(torch.device, line)``."""
    import os

    dev = resolve_device(device or os.environ.get("TPIV_DEVICE") or "cuda")
    if dev.type != "cuda":
        return dev, "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev, card_line()
