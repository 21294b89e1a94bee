"""Ring attention: exact attention over a sequence sharded across the
``sp`` ranks.

The counterpart of ``horovod_tpu/parallel/ring_attention.py``, in plain
torch and fp32 as the reference's is plain ``jnp``: no kernel of this
repo runs here.  Each rank holds a ``[B, T/n, H, D]`` shard of Q, K and V.
K/V chunks rotate around the ring (``ppermute``, each rank receiving from
its right), and each rank merges its queries' attention over every chunk
with an online softmax.  The chunk held at step ``s`` came from ring
position ``(my_idx + s) % n``; the causal mask uses global positions.

Differentiable: autograd runs back through the merges and the inverse
permutations.  Every rank's graph has the same shape (masks are data),
so the backward's exchanges pair up.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import ppermute, world_size

NEG_INF = -1e30


def _chunk_attention(q, k, v, sm_scale, mask):
    """Dense attention over one KV chunk.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; mask: [Tq, Tk] bool or None.
    Returns unnormalised ``o`` [B, Tq, H, D] fp32 (= exp(s - m) @ v), the
    softmax denominator ``l`` and the log-sum-exp, both [B, H, Tq] fp32.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if mask is not None:
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                    # [B,H,Tq]
    # Fully-masked rows: clamp m so p underflows to 0 instead of becoming
    # exp(NEG_INF - NEG_INF) = 1, and lse stays ~NEG_INF.
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)                                     # [B,H,Tq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    lse = torch.where(l > 0.0, m_safe + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, NEG_INF))
    return o, l, lse


def _merge(o_acc, lse_acc, o_c, l_c, lse_c):
    """Online-softmax merge of the running (normalised o, lse) with one
    chunk's (unnormalised o, l, lse)."""
    l_safe = torch.clamp(l_c, min=1e-30)
    o_c = o_c / l_safe.transpose(1, 2)[..., None]         # normalise chunk
    lse_new = torch.logaddexp(lse_acc, lse_c)
    wp = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    wc = torch.exp(lse_c - lse_new).transpose(1, 2)[..., None]
    return o_acc * wp + o_c * wc, lse_new


def local_attention(q, k, v, causal: bool = False,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Single-shard dense attention (the ring's degenerate case), in fp32;
    the result in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    mask = None
    if causal:
        t, tk = q.shape[1], k.shape[1]
        mask = torch.arange(t, device=q.device)[:, None] \
            >= torch.arange(tk, device=q.device)[None, :]
    o, l, _ = _chunk_attention(q, k, v, sm_scale, mask)
    l_safe = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / l_safe).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: dist.ProcessGroup | None = None,
                   causal: bool = False, sm_scale: float | None = None,
                   axis_size: int | None = None) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``group``'s ranks
    (this rank's ring position is its group rank).

    q, k, v: local shards [B, T_local, H, D]; returns the local output
    shard in q's dtype.  ``axis_size`` is the ring's size (default: the
    group's); at one, ``local_attention``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n = axis_size if axis_size is not None else world_size(group)
    if n == 1:
        return local_attention(q, k, v, causal=causal, sm_scale=sm_scale)

    my_idx = dist.get_rank(group)
    t_local = q.shape[1]
    perm = [(i, (i - 1) % n) for i in range(n)]   # receive from the right
    steps = torch.arange(t_local, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((q.shape[0], q.shape[2], t_local), NEG_INF,
                     dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        src = (my_idx + s) % n
        mask = None
        if causal:
            q_pos = my_idx * t_local + steps[:, None]
            kv_pos = src * t_local + steps[None, :]
            mask = q_pos >= kv_pos
        o_c, l_c, lse_c = _chunk_attention(q, k_cur, v_cur, sm_scale, mask)
        o, lse = _merge(o, lse, o_c, l_c, lse_c)
        if s < n - 1:                  # the last chunk goes nowhere
            k_cur = ppermute(k_cur, group, perm)
            v_cur = ppermute(v_cur, group, perm)
    return o.to(q.dtype)
