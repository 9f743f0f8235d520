"""Expert parallelism (ep): a Switch-style mixture-of-experts FFN with its
experts sharded over a mesh axis (counterpart of
``mxnet_tpu/parallel/moe.py``).

The JAX package's recipe, op for op: a replicated router picks each
token's top-1 expert (softmax, argmax: ties take the first index in both
libraries); tokens are packed into per-expert capacity slots
``C = max(int(B * capacity_factor / E), 1)`` per expert and position with
one-hot dispatch einsums, the slot from a cumulative sum; an
:func:`.collectives.all_to_all` (not tiled, ``(n, E_local, C, D)``)
carries each expert's slots to the position that owns it; the experts
run; the reverse all-to-all and a gate-weighted combine return the
results. A token over capacity contributes exactly 0.

:func:`moe_ffn_local` is the body: the JAX package's runs inside
``shard_map`` on one position's tokens; the port's runs all the
positions at once and takes and returns per-position lists.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import collectives as C

__all__ = ["moe_ffn", "moe_ffn_local"]


def _dispatch(x, gate_w, E, C_cap):
    """Routing of one position's tokens x (B, D): the (B, E, C) dispatch
    one-hots and the (B,) gate, zero for tokens over capacity."""
    logits = x @ gate_w
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.max(dim=-1).values
    onehot = F.one_hot(expert, E).to(x.dtype)
    # each token's slot within its expert's capacity
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    pos_tok = (pos * onehot).sum(dim=1)
    keep = (pos_tok < C_cap).to(x.dtype)
    gate = gate * keep
    slot_oh = F.one_hot(pos_tok.clamp(0, C_cap - 1).to(torch.int64),
                        C_cap).to(x.dtype)
    dispatch = onehot[:, :, None] * slot_oh[:, None, :] * keep[:, None, None]
    return dispatch, gate


def _stock_experts(w1, w2, xe):
    """The stock Switch expert body over all local experts at once: a
    2-layer relu FFN, w1 (E_local, D, H), w2 (E_local, H, D)."""
    return torch.bmm(torch.relu(torch.bmm(xe, w1)), w2)


def moe_ffn_local(xs, gate_ws, w1s, w2s, mesh, axis="ep",
                  capacity_factor=1.25, expert_fn=None, expert_params=None):
    """Per-position lists: ``xs`` tokens (B, D); ``gate_ws`` the router
    (D, E), replicated; ``w1s`` (E/n, D, H) and ``w2s`` (E/n, H, D), each
    position's experts. ``expert_fn(params_of_one_expert, tokens (C', D))
    -> (C', D)`` replaces the stock body, with ``expert_params`` a list of
    per-position trees whose leaves have leading axis E/n (then ``w1s``
    and ``w2s`` are ignored). Returns the per-position (B, D) outputs."""
    n = mesh.shape[axis]
    if expert_fn is None:
        E_local = w1s[0].shape[0]
    else:
        E_local = C.tree_leaves(expert_params[0])[0].shape[0]
    E = E_local * n
    packed = []
    routes = []
    for p, x in enumerate(xs):
        B, D = x.shape
        C_cap = max(int(B * capacity_factor / E), 1)
        dispatch, gate = _dispatch(x, gate_ws[p], E, C_cap)
        routes.append((dispatch, gate, C_cap))
        xe = torch.einsum("bec,bd->ecd", dispatch, x)
        packed.append(xe.reshape(n, E_local, C_cap, D))
    caps = {c for _, _, c in routes}
    if len(caps) != 1:
        raise ValueError("every position needs the same token count")
    C_cap = caps.pop()
    # my experts' slots from every position: (n, E_local, C, D)
    recv = C.all_to_all(packed, mesh, axis, split_axis=0, concat_axis=0,
                        tiled=False)
    outs = []
    for p, xe in enumerate(recv):
        D = xe.shape[-1]
        xe = xe.transpose(0, 1).reshape(E_local, n * C_cap, D)
        if expert_fn is None:
            ye = _stock_experts(w1s[p], w2s[p], xe)
        else:
            ye = torch.stack([expert_fn(C.tree_map(lambda a, e=e: a[e],
                                                   expert_params[p]), xe[e])
                              for e in range(E_local)])
        outs.append(ye.reshape(E_local, n, C_cap, D).transpose(0, 1))
    back = C.all_to_all(outs, mesh, axis, split_axis=0, concat_axis=0,
                        tiled=False)
    res = []
    for (dispatch, gate, _), ye in zip(routes, back):
        ye = ye.reshape(E, C_cap, ye.shape[-1])
        combine = dispatch * gate[:, None, None]
        res.append(torch.einsum("bec,ecd->bd", combine, ye))
    return res


def moe_ffn(x, gate_w, w1, w2, mesh, axis="ep", capacity_factor=1.25,
            expert_fn=None, expert_params=None):
    """Expert-parallel Switch FFN over ``mesh[axis]``.

    x: (N, D) tokens split over ``axis`` (each position N/n); gate_w:
    (D, E) replicated; w1: (E, D, H), w2: (E, H, D) split over ``axis``
    (each position owns E/n experts). Returns (N, D) on position 0's
    device. A custom expert body: ``expert_fn(params_one_expert, tokens)
    -> tokens`` with ``expert_params`` (a tree, leading axis E, split over
    ``axis``); w1/w2 may then be None."""
    custom = expert_fn is not None
    if custom and expert_params is None:
        raise ValueError("expert_fn requires expert_params")
    if not custom and (w1 is None or w2 is None):
        raise ValueError("pass w1/w2 for the stock FFN or expert_fn+expert_params")
    spec = C.P(axis)
    t = torch.as_tensor
    xs = C.shard(t(x), mesh, spec)
    gate_ws = C.broadcast(t(gate_w), mesh)
    if custom:
        expert_params = C.tree_map(t, expert_params)
        pieces = {id(a): C.shard(a, mesh, spec)
                  for a in C.tree_leaves(expert_params)}
        per_pos = [C.tree_map(lambda a, p=p: pieces[id(a)][p], expert_params)
                   for p in range(mesh.size)]
        outs = moe_ffn_local(xs, gate_ws, None, None, mesh, axis,
                             capacity_factor, expert_fn, per_pos)
    else:
        outs = moe_ffn_local(xs, gate_ws, C.shard(t(w1), mesh, spec),
                             C.shard(t(w2), mesh, spec), mesh, axis,
                             capacity_factor)
    return C.unshard(outs, mesh, spec)
