"""2D multi-head self-attention with relative position logits (counterpart
of distribuuuu_tpu/ops/attention.py): BoTNet's MHSA, the Shaw/Ramachandran
relative-position scheme of arXiv:1803.02155 / 1904.09925, as plain
functions on tensors.

No kernel: the JAX package retired its fused BoTNet kernel (0.854× XLA at
the 196-token grid) and computes this with einsums and an fp32 softmax,
and so does the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """Relative → absolute index shift by the pad-reshape trick.

    x: ``[B, N, L, 2L-1]`` relative logits → ``[B, N, L, L]`` absolute,
    ``abs[i, j] = rel[i, (j - i) + L - 1]``."""
    b, n, l, _ = x.shape
    x = F.pad(x, (0, 1))  # [., L, 2L]
    x = x.reshape(b, n, l * 2 * l)
    x = F.pad(x, (0, l - 1))  # [., 2L² + L - 1]
    x = x.reshape(b, n, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def relative_logits_1d(q: torch.Tensor, rel_k: torch.Tensor) -> torch.Tensor:
    """Relative logits along the last spatial dim.

    q: ``[B, N, H, W, d]``; rel_k: ``[2W-1, d]`` → ``[B, N, H, H, W, W]``,
    broadcast over the expanded (key-row) axis."""
    b, n, h, w, _ = q.shape
    logits = torch.einsum("bnhwd,md->bnhwm", q, rel_k)
    logits = rel_to_abs(logits.reshape(b, n * h, w, 2 * w - 1))
    return logits.reshape(b, n, h, 1, w, w).expand(b, n, h, h, w, w)


def rel_pos_logits(q: torch.Tensor, rel_height: torch.Tensor, rel_width: torch.Tensor,
                   height: int, width: int) -> torch.Tensor:
    """The full 2D relative-position logits: q ``[B, N, HW, d]`` →
    ``[B, N, HW, HW]``, the width term plus the height term."""
    b, n, _, d = q.shape
    q2 = q.reshape(b, n, height, width, d)
    lw = relative_logits_1d(q2, rel_width)  # b n x X y j
    lw = lw.permute(0, 1, 2, 4, 3, 5).reshape(b, n, height * width, height * width)
    lh = relative_logits_1d(q2.transpose(2, 3), rel_height)  # b n y Y x i
    lh = lh.permute(0, 1, 4, 2, 5, 3).reshape(b, n, height * width, height * width)
    return lw + lh


def abs_pos_logits(q: torch.Tensor, emb_height: torch.Tensor,
                   emb_width: torch.Tensor) -> torch.Tensor:
    """Absolute position logits: q ``[B, N, HW, d]``, emb_height
    ``[H, d]``, emb_width ``[W, d]`` → ``[B, N, HW, HW]``."""
    emb = (emb_height[:, None, :] + emb_width[None, :, :]).reshape(-1, q.shape[-1])
    return torch.einsum("bnid,jd->bnij", q, emb)


def mhsa_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_logits: torch.Tensor,
            scale: float) -> torch.Tensor:
    """``softmax(q·scale·kᵀ + pos) · v`` on ``[B, N, L, d]``: ``q·scale``
    and its product with k in the input dtype, the logits and ``pos``
    summed in fp32 through the softmax (fp32 whatever the input dtype, f64
    included, as in JAX), the weights cast back to ``v.dtype`` before the
    PV product. Output in ``v.dtype``."""
    logits = torch.einsum("bnxd,bnyd->bnxy", q * scale, k)
    weights = torch.softmax(logits.float() + pos_logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bnxy,bnyd->bnxd", weights, v)
