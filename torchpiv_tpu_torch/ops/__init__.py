"""Tensor ops of the engine and their numpy/scipy set-up helpers."""
