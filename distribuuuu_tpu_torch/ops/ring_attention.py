"""Single-device exact attention in plain PyTorch (counterpart of the
single-device half of distribuuuu_tpu/ops/ring_attention.py).

* :func:`blockwise_attention`: exact softmax in O(L·chunk) memory, an
  online-softmax loop over K/V chunks (``DEVICE.ATTN_IMPL blockwise``);
* :func:`reference_attention`: the dense oracle of the tests.

Both compute in fp32 whatever the input dtype and return ``v.dtype``, as
the JAX functions do. Neither is a kernel: the JAX package runs them as
XLA ops, and so the port runs them as PyTorch ops. The sequence-sharded
strategies (``ring_attention``, ``ulysses_attention``) need a mesh's
``seq`` axis and raise until the parallel layouts are ported.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from distribuuuu_tpu_torch import not_ported

_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)  # safe additive -inf


def _block_update(q, k, v, m, l, o, scale: float, mask):
    """One online-softmax step over a K/V block, in fp32.

    q: [B,H,Sq,D]; k, v: [B,H,Sk,D]; m, l: [B,H,Sq] running max and
    normalizer; o: [B,H,Sq,Dv] unnormalized accumulator; mask: [Sq,Sk]
    bool or None."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, _NEG_BIG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = corr * l + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, o_new


def blockwise_attention(q, k, v, *, chunk: int = 256, causal: bool = False,
                        scale: float | None = None, remat: bool = True):
    """Exact attention over K/V chunks of ``chunk`` keys (the last one
    padded and masked). ``remat`` recomputes each chunk's block in the
    backward (``torch.utils.checkpoint``), so autograd stores no
    probabilities. q, k: [B,H,L,D]; v: [B,H,L,Dv]; returns [B,H,L,Dv] in
    ``v.dtype``."""
    b, h, L, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    chunk = min(chunk, L)
    nc = -(-L // chunk)
    pad = nc * chunk - L
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.float()
    q_pos = torch.arange(L, device=q.device)
    m = torch.full((b, h, L), _NEG_BIG, device=q.device)
    l = torch.zeros((b, h, L), device=q.device)
    o = torch.zeros((b, h, L, v.shape[-1]), device=q.device)
    for i in range(nc):
        k_pos = i * chunk + torch.arange(chunk, device=q.device)
        mask = None
        if causal or pad:
            mask = (k_pos < L)[None, :].expand(L, chunk)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
        kb, vb = kp[:, :, i * chunk:(i + 1) * chunk], vp[:, :, i * chunk:(i + 1) * chunk]
        if remat and torch.is_grad_enabled():
            m, l, o = torch.utils.checkpoint.checkpoint(
                _block_update, qf, kb, vb, m, l, o, scale, mask, use_reentrant=False)
        else:
            m, l, o = _block_update(qf, kb, vb, m, l, o, scale, mask)
    return (o / l.clamp_min(1e-30)[..., None]).to(v.dtype)


def reference_attention(q, k, v, *, causal: bool = False, scale: float | None = None):
    """Dense exact attention in fp32, the numerics oracle of the tests."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sl = s.shape[-1]
        s = torch.where(torch.ones((sl, sl), dtype=torch.bool, device=s.device).tril(), s,
                        _NEG_BIG)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(v.dtype)


def ring_attention(*_args, **_kwargs):
    """Ring attention over the ``seq`` mesh axis: not ported."""
    raise not_ported("ring attention (a sequence-sharded mesh, MESH.SEQ > 1)",
                     "Parallel layouts beyond DP")


def ulysses_attention(*_args, **_kwargs):
    """Ulysses all-to-all attention over the ``seq`` mesh axis: not ported."""
    raise not_ported("Ulysses attention (a sequence-sharded mesh, MESH.SEQ > 1)",
                     "Parallel layouts beyond DP")
