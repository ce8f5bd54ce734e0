"""Ensemble (correlation-averaged) PIV (counterpart of
``torchpiv_tpu/models/ensemble_corr.py``).

For sparsely seeded flows (micro-PIV) one image pair carries too few
particles for a reliable peak; the remedy is to average the correlation
planes of many pairs before the peak fit (Meinhart et al. 2000).  With the
engine's batched ``[B, N, w, w]`` correlation tensor that is one reduction
over the batch.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import PIVConfig, compute_dtype
from ..ops.correlate import mean_normalize
from ..ops.windows import extract_windows
from .multipass import MultipassPIV


class EnsemblePIV(nn.Module):
    """Correlation-averaged single-pass PIV over a batch of pairs.

    ``forward(batch_a, batch_b)``: ``[B, H, W]`` frame batches -> ``(u, v,
    invalid)`` of the field shape, one averaged field for the whole batch.
    The windows are mean-normalised (and weighted by the engine's taper)
    before the correlation, as in the JAX package; the peak fit is the
    engine's, so ``peakfit="pallas"`` runs the fused peak-fit kernel once a
    ``finalize``.
    """

    def __init__(self, config: PIVConfig, device="auto"):
        super().__init__()
        if config.multipass != 1:
            raise ValueError("ensemble correlation averaging is a single-pass method")
        if compute_dtype(config.dtype) != "float32" and config.correlator == "fft" \
                and config.window_weight is None:
            # the ensemble correlates its windows unfused whatever ``fused``
            # says, so the engine's rule applies here with any ``fused``
            raise ValueError(
                f"dtype={config.dtype!r} with correlator='fft': the ensemble "
                f"hands its {config.dtype} windows to the FFT, which takes "
                f"float32 and float64 only in the JAX package; use correlator="
                f"'auto' or 'matmul' (the windows promoted to float32)")
        self.config = config
        self.engine = MultipassPIV(config, device=device)

    @property
    def final_coordinates(self):
        return self.engine.final_coordinates

    def _correlations(self, batch_a: torch.Tensor, batch_b: torch.Tensor) -> torch.Tensor:
        """``[B, N, w, w]`` correlation planes of a pair batch."""
        eng = self.engine
        w, o = eng.schedule[0]
        planes = []
        for frames in (batch_a, batch_b):
            windows = extract_windows(frames.to(eng.device), w, o)
            nw = mean_normalize(windows.to(eng.compute_dtype))
            planes.append(nw if eng.weight_0 is None else nw * eng.weight_0)
        return eng._correlate(0, *planes)

    @torch.no_grad()
    def forward(self, batch_a: torch.Tensor, batch_b: torch.Tensor):
        return self.finalize(self._correlations(batch_a, batch_b).mean(dim=0))

    @torch.no_grad()
    def corr_batch(self, batch_a: torch.Tensor, batch_b: torch.Tensor) -> torch.Tensor:
        """Summed correlation planes ``[N, w, w]`` of one pair batch:
        accumulate the sums across batches on the device and divide by the
        total pair count before ``finalize`` (the fit and the peak-ratio
        validation are scale-invariant; the mean keeps long runs in a
        float32-friendly range)."""
        return self._correlations(batch_a, batch_b).sum(dim=0)

    @torch.no_grad()
    def finalize(self, corr: torch.Tensor):
        """Peak-fit an (averaged) correlation stack ``[N, w, w]`` into the
        ``(u, v, invalid)`` field triple."""
        eng = self.engine
        shape = eng.field_shapes[0]
        u, v, inval = eng._peakfit(corr.to(eng.device).float(), self.config.validate)
        u = u.reshape(shape)
        v = v.reshape(shape)
        if inval is not None:
            inval = inval.reshape(shape)
        return u, v, inval
