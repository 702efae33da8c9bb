"""Classification metrics (counterpart of distribuuuu_tpu/utils/metrics.py).

They run on the device inside the train and eval steps and return device
tensors; the loop fetches them at ``PRINT_FREQ``, not every step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from distribuuuu_tpu_torch.models.layers import head_dtype


def accuracy(logits: torch.Tensor, targets: torch.Tensor, topk=(1,)) -> list[torch.Tensor]:
    """Top-k accuracy percentages over the batch, one fp32 scalar per k
    (each k at most the class count; the trainer clamps it)."""
    maxk = max(topk)
    if maxk > logits.shape[-1]:
        raise ValueError(f"top-{maxk} needs ≥{maxk} classes, got {logits.shape[-1]}")
    pred = logits.topk(maxk, dim=-1).indices
    hits = pred == targets.long()[..., None]
    return [hits[..., :k].any(dim=-1).float().mean() * 100.0 for k in topk]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels: log-softmax in the
    promoted head dtype (fp32 for bf16 logits, fp64 for fp64), mean NLL."""
    logp = F.log_softmax(logits.to(head_dtype(logits.dtype)), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def count_parameters(model: torch.nn.Module) -> tuple[float, float]:
    """(parameters in millions, fp32 megabytes)."""
    n = sum(p.numel() for p in model.parameters())
    return n / 1e6, n * 4 / 2**20
