"""Top-k gradient compression with error feedback (EF-SGD style): own copy
of ``repro.train.compress`` in PyTorch.

Only the largest ratio * N magnitudes of each gradient leaf survive; the
residual is carried in an error-feedback buffer so the update stays
unbiased over time.  Every magnitude at or above the k-th largest is kept,
so a tie at the threshold keeps more than k."""
from __future__ import annotations

from typing import Optional

import torch

from .tree import leaves, unflatten


def _topk_mask(g: torch.Tensor, ratio: float) -> torch.Tensor:
    if g.dim() == 0 or ratio >= 1.0:
        return g
    k = max(1, int(g.numel() * ratio))
    thresh = torch.topk(g.abs().reshape(-1), k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


def topk_compress_decompress(grads, ef: Optional[dict], *,
                             ratio: float) -> tuple:
    """Returns (compressed grads, new error-feedback buffers), both shaped
    like ``grads``; ``ef`` None starts from zeros."""
    flat = leaves(grads)
    err = leaves(ef) if ef is not None else [torch.zeros_like(g)
                                             for g in flat]
    corrected = [g + e for g, e in zip(flat, err)]
    sparse = [_topk_mask(c, ratio) for c in corrected]
    return (unflatten(grads, sparse),
            unflatten(grads, [c - s for c, s in zip(corrected, sparse)]))
