"""Ring attention: exact self-attention with the token axis sharded over a
process group.

Counterpart of ``fgdm_tpu/parallel/ring_attention.py``.  Each rank holds a
query shard ``[B, H, n, D]`` and the K/V shards of the same tokens; the K/V
blocks travel around the ring to rank + 1 while a float32 online softmax
builds the full-attention result (JAX's ``_ring_body``, ``:28-56``), so no
rank ever holds the N x N score matrix or the whole K/V.  JAX expresses it
with ``shard_map`` and ``ppermute``; the port posts
``batch_isend_irecv`` for the next block before it computes on this one,
so the transfer overlaps the compute.  It skips the rotation after the last
block and when the group has one rank: the same result, and NCCL will not
send to itself.  The math is torch ops (``einsum`` in float32), as JAX's is
XLA's: this module has no kernel.

``set_context_group``/``get_context_group`` are the counterparts of
``set_context_mesh``/``get_context_mesh``: the group the context-parallel
modules (``seq_axis`` set, ``parallel/context.py``) run their ring over.
``constrain_seq``/``make_sh`` (GSPMD layout pins inside a jitted program)
have no counterpart: the port runs its H-sharded forward by hand and every
activation keeps its rows by construction.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ring_attention", "set_context_group", "get_context_group"]


def _size_rank(group):
    if group is None and not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over the tokens of every rank of ``group``.

    q/k/v: this rank's ``[B, H, n, D]`` shards, the ranks' shards in token
    order (rank r holds tokens ``[r n, (r + 1) n)``); every rank's ``n`` is
    the same.  Returns this rank's queries' output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p, r = _size_rank(group)
    if p > 1:
        group = group or dist.group.WORLD
        nxt = dist.get_global_rank(group, (r + 1) % p)
        prv = dist.get_global_rank(group, (r - 1) % p)
    qf = q.float()
    b, h, n, d = q.shape
    acc = torch.zeros((b, h, n, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m_i = torch.full((b, h, n, 1), -torch.inf, dtype=torch.float32,
                     device=q.device)
    l_i = torch.zeros((b, h, n, 1), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k.contiguous(), v.contiguous()
    for step in range(p):
        reqs = None
        if step < p - 1:
            # post the next block's transfer before computing on this one
            k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k_blk, nxt, group),
                dist.P2POp(dist.isend, v_blk, nxt, group),
                dist.P2POp(dist.irecv, k_next, prv, group),
                dist.P2POp(dist.irecv, v_next, prv, group)])
        s = torch.einsum("bhid,bhjd->bhij", qf, k_blk.float()) * scale
        m_new = torch.maximum(m_i, s.amax(dim=-1, keepdim=True))
        pexp = torch.exp(s - m_new)
        alpha = torch.exp(m_i - m_new)
        l_i = l_i * alpha + pexp.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhij,bhjd->bhid", pexp,
                                         v_blk.float())
        m_i = m_new
        if reqs is not None:
            for req in reqs:
                req.wait()
            k_blk, v_blk = k_next, v_next
    return (acc / l_i).to(q.dtype)


# The group the ``seq_axis`` attention modules ring over; registered by
# ``parallel.context.context_parallel_pipeline``.
_CONTEXT_GROUP = None


def set_context_group(group) -> None:
    """Register ``group`` for the context-parallel modules (None clears
    it, as ``set_context_mesh(None)``)."""
    global _CONTEXT_GROUP
    _CONTEXT_GROUP = group


def get_context_group():
    if _CONTEXT_GROUP is None:
        raise RuntimeError(
            "seq_axis is set on an attention module but no context group is "
            "registered — build the model through "
            "parallel.context.context_parallel_pipeline (or call "
            "set_context_group) before running it")
    return _CONTEXT_GROUP
