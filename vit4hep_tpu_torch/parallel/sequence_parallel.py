"""Ring attention over the grid's model axis (port of
``vit4hep_tpu/parallel/sequence_parallel.py``).

The token axis is split over a process group: each rank holds its block
of queries and one block of keys and values, and the key/value blocks go
around the ring (``_comm.ppermute``, whose backward sends the gradients the
other way) while an online softmax builds the exact attention of the local
queries over every key, as JAX's ``_ring_shard`` (``:28-63``) does. Its
block products are ``torch.matmul`` in float32, as JAX's are ``einsum``s
outside any Pallas kernel.

:func:`ring_attention_shard` works on the local blocks;
:func:`ring_attention` takes the whole (B, H, N, D) tensors every rank
holds (JAX's global arrays), runs the ring on this rank's block of N / n
tokens and gathers the outputs, so that every rank returns the whole
attention, and the gradients of the whole inputs are summed over the group.
With one rank it is the plain attention (``ops/attention.xla_attention``),
and an N that the group's size does not divide raises (``:66-75``).
"""

from __future__ import annotations

import torch

from vit4hep_tpu_torch.ops.attention import xla_attention
from vit4hep_tpu_torch.parallel import _comm

_NEG_INF = -1e30


def ring_attention_shard(q, k, v, group, scale=None):
    """softmax(q K^T * scale) V for this rank's block of queries ``q``
    (B, H, n, D) over the keys and values of every rank's block (``k``,
    ``v``: this rank's); returns (B, H, n, D)."""
    n_dev = _comm.size(group)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float()
    acc = torch.zeros_like(qf)
    m = torch.full((*q.shape[:-1], 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)  # noqa: E741
    k_cur, v_cur = k, v
    for step in range(n_dev):
        s = torch.matmul(qf, k_cur.float().transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)  # noqa: E741
        acc = acc * alpha + torch.matmul(p, v_cur.float())
        m = m_new
        if step < n_dev - 1:  # the last blocks are not sent on
            k_cur, v_cur = _comm.ppermute((k_cur, v_cur), group)
    return (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)


def ring_attention(q, k, v, group=None):
    """Exact attention with the token axis split over ``group``.

    q, k, v: (B, H, N, D), the same on every rank, N divisible by the
    group's size. Returns (B, H, N, D) on every rank."""
    n_dev = _comm.size(group)
    if n_dev == 1:
        return xla_attention(q, k, v)
    n = q.shape[2]
    if n % n_dev != 0:
        raise ValueError(f"sequence length {n} not divisible by {n_dev}")
    blk, r = n // n_dev, _comm.index(group)
    q, k, v = (_comm.copy_to(t, group).narrow(2, r * blk, blk) for t in (q, k, v))
    out = ring_attention_shard(q, k, v, group, scale=q.shape[-1] ** -0.5)
    return _comm.all_gather(out, group, dim=2)
