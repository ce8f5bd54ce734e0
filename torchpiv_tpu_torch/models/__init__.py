"""The multipass engine."""
from .multipass import MultipassPIV

__all__ = ["MultipassPIV"]
