"""Ring attention and Ulysses sequence parallelism (counterpart of
``mxnet_tpu/parallel/ring.py``).

Both take q/k/v sharded over a mesh axis along the sequence.

* :func:`ring_attention`: each position keeps its Q shard and the K/V
  shards travel round the ring (:func:`.collectives.ppermute`, one hop
  per step). The JAX package folds each block into an online softmax in
  plain ``jnp`` (``_block_update``); the port runs its flash kernels
  block by block instead: position ``r`` at step ``i`` holds the block of
  ``src = (r - i) mod n`` and calls the K1 forward on ``(q_r, k_src,
  v_src)``, causal when ``src == r``, and not at all when causal and
  ``src > r`` (the JAX mask makes that block's weights exactly 0). The
  partial ``(out, lse)`` pairs are merged by log-sum-exp in float32.
  The backward calls K2a and K2b once per block that was computed, with
  the merged ``out`` and ``lse``, which make each block's dq, dk and dv
  exact; dk and dv travel home with their block, as in the JAX
  ``_ring_bwd``. Gradients are summed in float32 and rounded once.
  Causal over n positions: n(n+1)/2 calls of each kernel per forward
  and backward; not causal, n².
* :func:`ulysses_attention`: an all-to-all swaps the sequence split for
  a head split, the port's :func:`~..ops.attention.flash_attention` runs
  over the whole sequence at each position (one K1, and one K2a and K2b
  in the backward), and an all-to-all swaps back.

The ``*_local`` functions are the bodies: the JAX package's run inside
``shard_map`` on one shard; the port's run all the positions at once
(one controller) and take and return per-position lists.
"""
from __future__ import annotations

import torch

from ..ops import attention as _attn
from . import collectives as C

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_local",
           "ulysses_attention_local"]


def _merge(out, lse, o_new, lse_new):
    """Log-sum-exp merge of two normalized partial attentions."""
    m = torch.maximum(lse, lse_new)
    a, b = torch.exp(lse - m), torch.exp(lse_new - m)
    tot = a + b
    return ((out * a[..., None] + o_new * b[..., None]) / tot[..., None],
            m + torch.log(tot))


def _ring_steps(n, causal):
    """For each ring step i and ring index r: the block's home ``src`` and
    whether the step computes (False: causal and src > r)."""
    return [[((r - i) % n, not causal or (r - i) % n <= r) for r in range(n)]
            for i in range(n)]


class _RingAttention(torch.autograd.Function):
    """All positions of the ring in one Function: inputs are the n q, n k
    and n v shards (one axis group, in ring order), outputs the n outs."""

    @staticmethod
    def forward(ctx, devices, causal, scale, *qkv):
        n = len(devices)
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        k_blk, v_blk = list(ks), list(vs)
        outs, lses = [None] * n, [None] * n
        for i, row in enumerate(_ring_steps(n, causal)):
            for r, (src, live) in enumerate(row):
                if not live:
                    continue
                o, lse = _attn.flash_attention_forward(
                    qs[r], k_blk[r], v_blk[r], causal and src == r, scale)
                if outs[r] is None:
                    outs[r], lses[r] = o, lse
                else:
                    outs[r], lses[r] = _merge(outs[r], lses[r], o, lse)
            if i < n - 1:
                k_blk = _rotate(k_blk, devices)
                v_blk = _rotate(v_blk, devices)
        outs = [o.to(q.dtype) for o, q in zip(outs, qs)]
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.ring = (devices, causal, scale)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        devices, causal, scale = ctx.ring
        n = len(devices)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        gs = [g.contiguous() for g in gs]
        k_blk, v_blk = list(ks), list(vs)
        dk_acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
                  for k in ks]
        dv_acc = [torch.zeros_like(a) for a in dk_acc]
        dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
              for q in qs]
        for i, row in enumerate(_ring_steps(n, causal)):
            for r, (src, live) in enumerate(row):
                if not live:
                    continue
                a, b, c = _attn.flash_attention_backward_f32(
                    qs[r], k_blk[r], v_blk[r], outs[r], lses[r], gs[r],
                    causal and src == r, scale)
                dq[r] += a
                dk_acc[r] += b
                dv_acc[r] += c
            # a block's gradient travels on with it: after n hops it is
            # back at the block's home position
            if i < n - 1:
                k_blk = _rotate(k_blk, devices)
                v_blk = _rotate(v_blk, devices)
            dk_acc = _rotate(dk_acc, devices)
            dv_acc = _rotate(dv_acc, devices)
        return (None, None, None,
                *[d.to(q.dtype) for d, q in zip(dq, qs)],
                *[d.to(k.dtype) for d, k in zip(dk_acc, ks)],
                *[d.to(v.dtype) for d, v in zip(dv_acc, vs)])


def _rotate(xs, devices):
    """One hop round the ring: ring index j's value to j + 1 (the
    ``ppermute`` of one axis group, inside the Function)."""
    n = len(xs)
    return [C.transfer(xs[(j - 1) % n], devices[j]) for j in range(n)]


def _check_local(qs, ks, vs, mesh):
    if not len(qs) == len(ks) == len(vs) == mesh.size:
        raise ValueError("one q, k and v shard per position of the mesh "
                         "(%d), got %d %d %d" % (mesh.size, len(qs), len(ks),
                                                 len(vs)))


def ring_attention_local(qs, ks, vs, mesh, axis="sp", causal=False,
                         sm_scale=None):
    """The ring over per-position shards (B, H, S/n, D), in position
    order; returns the per-position outputs. Differentiable."""
    _check_local(qs, ks, vs, mesh)
    scale = _attn._scale(sm_scale, qs[0].shape[-1])
    outs = [None] * mesh.size
    for group in mesh.groups(axis):
        args = ([qs[p].contiguous() for p in group]
                + [ks[p].contiguous() for p in group]
                + [vs[p].contiguous() for p in group])
        res = _RingAttention.apply([mesh.device_list[p] for p in group],
                                   bool(causal), scale, *args)
        for p, o in zip(group, res):
            outs[p] = o
    return outs


def _seq_spec(axis):
    return C.P(None, None, axis, None)


def ring_attention(q, k, v, mesh, axis="sp", causal=False, sm_scale=None):
    """Sequence-parallel attention over global (B, H, S, D) tensors: S is
    split over ``mesh`` axis ``axis`` (it must divide) and the ring runs
    over the shards. Returns the global output on position 0's device."""
    n = mesh.shape[axis]
    if q.shape[2] % n:
        raise ValueError("seq len %d not divisible by %s=%d" % (q.shape[2], axis, n))
    spec = _seq_spec(axis)
    outs = ring_attention_local(C.shard(q, mesh, spec), C.shard(k, mesh, spec),
                                C.shard(v, mesh, spec), mesh, axis, causal,
                                sm_scale)
    return C.unshard(outs, mesh, spec)


def ulysses_attention_local(qs, ks, vs, mesh, axis="sp", causal=False,
                            sm_scale=None):
    """Seq-sharded (B, H, S/n, D) shards in, all-to-all to head-sharded
    (B, H/n, S, D), flash attention at each position, all-to-all back."""
    _check_local(qs, ks, vs, mesh)

    def seq_to_heads(ts):
        return C.all_to_all(ts, mesh, axis, split_axis=1, concat_axis=2)

    qh, kh, vh = seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs)
    out = [_attn.flash_attention(a.contiguous(), b.contiguous(),
                                 c.contiguous(), causal, sm_scale)
           for a, b, c in zip(qh, kh, vh)]
    return C.all_to_all(out, mesh, axis, split_axis=2, concat_axis=1)


def ulysses_attention(q, k, v, mesh, axis="sp", causal=False, sm_scale=None):
    """All-to-all (DeepSpeed-Ulysses style) sequence parallelism. Requires
    heads % axis_size == 0 and S % axis_size == 0."""
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError("heads %d not divisible by %s=%d" % (q.shape[1], axis, n))
    if q.shape[2] % n:
        raise ValueError("seq len %d not divisible by %s=%d" % (q.shape[2], axis, n))
    spec = _seq_spec(axis)
    outs = ulysses_attention_local(
        C.shard(q, mesh, spec), C.shard(k, mesh, spec), C.shard(v, mesh, spec),
        mesh, axis, causal, sm_scale)
    return C.unshard(outs, mesh, spec)
