"""Parallel decoder-only LM training: sp, pp and ep (counterpart of
``mxnet_tpu/parallel/lm.py``).

The same LM family as the JAX package's, with its parameter names
(``layer{i}_ln1_gamma``, ``layer{i}_attn_in_weight``, ...) and its
initialization (:func:`init_lm_params` is numpy, bitwise equal to the JAX
package's from the same seed):

* :class:`DenseLMTrainer` — one device, the oracle the others are held to;
* :class:`SPLMTrainer` — sequence parallel: activations split along T
  over an ``sp`` axis, attention the ring over the port's flash kernels
  (:func:`.ring.ring_attention_local`): the slice's kernel path;
* :class:`PPLMTrainer` — pipeline parallel: the embedding and the blocks
  in heterogeneous stages over a ``pp`` axis (:func:`.pipeline.
  pipeline_apply`, GPipe), the head on the drained microbatches;
* :class:`MoELMTrainer` — expert parallel: each block's FFN a Switch MoE
  with its experts over an ``ep`` axis (:func:`.moe.moe_ffn_local`), the
  batch split over the same axis.

Dense, pp and ep attention is the plain materialized causal softmax, as
in the JAX package (``_dense_causal_attention``); it is no kernel there.

Every trainer has the JAX package's surface: ``init_params(seed)``,
``init_opt_state(params)``, ``step(params, opt_state, tokens, labels) ->
(params, opt_state, loss)`` and ``forward(params, tokens) -> logits``.
``step`` takes numpy or torch tokens, updates the parameter and state
tensors in place (the JAX step donates them) and returns the same dicts
and the loss as a 0-d tensor; the update is the fused rule of
:mod:`.fused_opt` for the optimizer. Each trainer's ``step`` and
``forward`` are ``compileobs`` programs (``lm.step``, ``lm.fwd``; the
graph key the trainer class and its config, as the JAX package's
``_obs_jit``): the first call at a new signature is their compile.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import compileobs
from .. import optimizer as opt_mod
from . import collectives as C
from . import fused_opt
from .moe import moe_ffn_local
from .pipeline import pipeline_apply
from .ring import ring_attention_local

__all__ = ["DenseLMTrainer", "SPLMTrainer", "PPLMTrainer", "MoELMTrainer",
           "init_lm_params", "lm_param_names", "lm_forward_dense"]


# ---------------------------------------------------------------- params
def init_lm_params(seed, vocab_size, num_layers, model_dim, num_heads,
                   ffn_dim, seq_len, num_experts=0, dtype=np.float32):
    """Parameter dict (numpy) of the LM family. With ``num_experts > 0``
    each layer's FFN is a Switch MoE: layer{i}_gate_weight (D, E),
    layer{i}_ffn1_weight (E, D, F), layer{i}_ffn2_weight (E, F, D)."""
    rng = np.random.RandomState(seed)
    D, F, V, T = model_dim, ffn_dim, vocab_size, seq_len

    def normal(*shape, scale=0.02):
        return (rng.randn(*shape) * scale).astype(dtype)

    p = {
        "embed_weight": normal(V, D),
        "pos_embed_weight": normal(1, T, D),
        "final_ln_gamma": np.ones(D, dtype),
        "final_ln_beta": np.zeros(D, dtype),
        "lm_head_weight": normal(D, V),
    }
    for i in range(num_layers):
        n = "layer%d_" % i
        p[n + "ln1_gamma"] = np.ones(D, dtype)
        p[n + "ln1_beta"] = np.zeros(D, dtype)
        p[n + "ln2_gamma"] = np.ones(D, dtype)
        p[n + "ln2_beta"] = np.zeros(D, dtype)
        p[n + "attn_in_weight"] = normal(D, 3 * D)
        p[n + "attn_out_weight"] = normal(D, D)
        if num_experts:
            p[n + "gate_weight"] = normal(D, num_experts)
            p[n + "ffn1_weight"] = normal(num_experts, D, F)
            p[n + "ffn2_weight"] = normal(num_experts, F, D)
        else:
            p[n + "ffn1_weight"] = normal(D, F)
            p[n + "ffn2_weight"] = normal(F, D)
    return p


def lm_param_names(num_layers, num_experts=0, **_):
    """The parameter names of the LM family, allocating nothing."""
    names = ["embed_weight", "pos_embed_weight", "final_ln_gamma",
             "final_ln_beta", "lm_head_weight"]
    for i in range(num_layers):
        n = "layer%d_" % i
        names += [n + "ln1_gamma", n + "ln1_beta", n + "ln2_gamma",
                  n + "ln2_beta", n + "attn_in_weight", n + "attn_out_weight"]
        if num_experts:
            names.append(n + "gate_weight")
        names += [n + "ffn1_weight", n + "ffn2_weight"]
    return names


# ---------------------------------------------------------------- blocks
def _ln(x, gamma, beta, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def _qkv(h, w_in, num_heads):
    """(B, T, D) @ (D, 3D) -> three (B, H, T, Dh)."""
    B, T, D = h.shape
    Dh = D // num_heads
    q, k, v = torch.split(h @ w_in, D, dim=-1)

    def to_heads(a):
        return a.reshape(B, T, num_heads, Dh).transpose(1, 2)

    return to_heads(q), to_heads(k), to_heads(v)


def _merge_heads(a):
    B, H, T, Dh = a.shape
    return a.transpose(1, 2).reshape(B, T, H * Dh)


def _dense_causal_attention(q, k, v):
    """The materialized causal softmax the JAX package's dense, pp and ep
    blocks use."""
    Dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(Dh)
    T = q.shape[2]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                        device=s.device))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def _ffn_dense(p, prefix, h):
    return torch.relu(h @ p[prefix + "ffn1_weight"]) @ p[prefix + "ffn2_weight"]


def _block_dense(p, prefix, x, num_heads):
    """One pre-norm block with dense causal attention and a dense FFN."""
    h = _ln(x, p[prefix + "ln1_gamma"], p[prefix + "ln1_beta"])
    q, k, v = _qkv(h, p[prefix + "attn_in_weight"], num_heads)
    x = x + _merge_heads(_dense_causal_attention(q, k, v)) @ p[prefix + "attn_out_weight"]
    h = _ln(x, p[prefix + "ln2_gamma"], p[prefix + "ln2_beta"])
    return x + _ffn_dense(p, prefix, h)


def _head(p, x):
    x = _ln(x, p["final_ln_gamma"], p["final_ln_beta"])
    return x @ p["lm_head_weight"]


def lm_forward_dense(params, tokens, num_layers, num_heads):
    """Single-device reference forward: (B, T) int tokens -> (B, T, V)
    logits. The oracle the parallel modes are held to."""
    x = params["embed_weight"][tokens.long()] + params["pos_embed_weight"][0]
    for i in range(num_layers):
        x = _block_dense(params, "layer%d_" % i, x, num_heads)
    return _head(params, x)


def _xent(logits, labels):
    """Mean next-token cross-entropy; labels int (..., T)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


# ---------------------------------------------------------------- trainers
class _LMTrainerBase:
    """The shared surface: parameters and optimizer state as tensors on the
    trainer's home device (position 0's), the fused rule's update."""

    def __init__(self, cfg, mesh=None, optimizer="sgd", optimizer_params=None,
                 device=None):
        if isinstance(optimizer, str):
            self.optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        else:
            self.optimizer = optimizer
        self.rule = fused_opt.make_rule(self.optimizer)
        self.mesh = mesh
        self.cfg = cfg
        key = (type(self).__name__,
               tuple(sorted((k, str(v)) for k, v in cfg.items())))
        site = "mxnet_tpu_torch/parallel/lm.py:%s" % type(self).__name__
        self._programs = {kind: compileobs.Program("lm." + kind, site, key)
                          for kind in ("step", "fwd")}
        if mesh is not None:
            self.device = mesh.device_list[0]
        else:
            from ..context import resolve

            self.device = resolve(device)

    def init_params(self, seed=0):
        return self._params_on_device(init_lm_params(seed, **self.cfg))

    def init_opt_state(self, params):
        return {n: self.rule.init_state(tuple(a.shape), self.device)
                for n, a in params.items()}

    def _params_on_device(self, params):
        """``params`` as float32 tensors on the home device (tensors there
        already are kept, so an update in place reaches the caller's)."""
        out = {}
        for n, a in params.items():
            if not isinstance(a, torch.Tensor):
                a = torch.as_tensor(np.asarray(a))
            out[n] = a.to(self.device, torch.float32)
        return out

    def _ids(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(x), dtype=torch.int64,
                               device=self.device)

    def _loss(self, p, tokens, labels):
        raise NotImplementedError

    def _forward(self, p, tokens):
        raise NotImplementedError

    def step(self, params, opt_state, tokens, labels):
        """One step: loss, gradients and the optimizer's update, written
        into ``params`` and ``opt_state`` in place."""
        t0 = time.perf_counter()
        params = self._params_on_device(params)
        tokens, labels = self._ids(tokens), self._ids(labels)
        lr, t = fused_opt.host_step_values(self.optimizer, list(params))
        names = list(params)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            loss = self._loss(leaves, tokens, labels)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        lr_t = self.rule.step_lr(lr, t)
        wd = float(self.optimizer.wd)
        with torch.no_grad():
            for n, g in zip(names, grads):
                self.rule.apply_(params[n], g, opt_state[n], lr_t, wd)
        self._programs["step"].charge(
            compileobs.signature([("tokens", tokens), ("labels", labels)]
                                 + list(params.items())),
            time.perf_counter() - t0)
        return params, opt_state, loss.detach()

    def forward(self, params, tokens):
        t0 = time.perf_counter()
        tokens = self._ids(tokens)
        with torch.no_grad():
            out = self._forward(self._params_on_device(params), tokens)
        self._programs["fwd"].charge(
            compileobs.signature([("tokens", tokens)]),
            time.perf_counter() - t0)
        return out


def _lm_cfg(vocab_size, num_layers, model_dim, num_heads, ffn_dim, seq_len):
    return dict(vocab_size=vocab_size, num_layers=num_layers,
                model_dim=model_dim, num_heads=num_heads, ffn_dim=ffn_dim,
                seq_len=seq_len)


class DenseLMTrainer(_LMTrainerBase):
    """The dense LM on one device (``device``, default the current
    context): the baseline every parallel mode is held to."""

    def __init__(self, mesh=None, vocab_size=0, num_layers=0, model_dim=0,
                 num_heads=0, ffn_dim=0, seq_len=0, optimizer="sgd",
                 optimizer_params=None, device=None, **_):
        super().__init__(_lm_cfg(vocab_size, num_layers, model_dim, num_heads,
                                 ffn_dim, seq_len), None, optimizer,
                         optimizer_params, device)
        self.mesh = mesh  # unused; accepted for constructor symmetry

    def _forward(self, p, tokens):
        return lm_forward_dense(p, tokens, self.cfg["num_layers"],
                                self.cfg["num_heads"])

    def _loss(self, p, tokens, labels):
        return _xent(self._forward(p, tokens), labels)


def _replicate(p, mesh):
    """Per position, the parameter dict on its device (each tensor itself
    where the position's device holds it)."""
    per = [dict() for _ in range(mesh.size)]
    for n, a in p.items():
        for d, t in zip(per, C.broadcast(a, mesh)):
            d[n] = t
    return per


def _mean_to(values, device):
    """The mean of per-position scalars on ``device`` (a ``pmean`` whose
    result one controller reads once)."""
    return torch.stack(C.gather_to(values, device)).mean()


class SPLMTrainer(_LMTrainerBase):
    """Sequence-parallel LM: activations split along T over the ``axis``
    positions, ring attention over the flash kernels; batch replicated."""

    def __init__(self, mesh, vocab_size, num_layers, model_dim, num_heads,
                 ffn_dim, seq_len, axis="sp", optimizer="sgd",
                 optimizer_params=None):
        super().__init__(_lm_cfg(vocab_size, num_layers, model_dim, num_heads,
                                 ffn_dim, seq_len), mesh, optimizer,
                         optimizer_params)
        self.axis = axis

    def _local_logits(self, p, tokens):
        """Per-position logits (B, T/n, V) of the per-position tokens."""
        mesh, axis, cfg = self.mesh, self.axis, self.cfg
        toks = C.shard(tokens, mesh, C.P(None, axis))
        ps = _replicate(p, mesh)
        xs = []
        for pos, (tok, q) in enumerate(zip(toks, ps)):
            t_loc = tok.shape[1]
            i = mesh.axis_index(pos, axis)
            xs.append(q["embed_weight"][tok]
                      + q["pos_embed_weight"][0, i * t_loc:(i + 1) * t_loc])
        for layer in range(cfg["num_layers"]):
            pre = "layer%d_" % layer
            qkv = [_qkv(_ln(x, q[pre + "ln1_gamma"], q[pre + "ln1_beta"]),
                        q[pre + "attn_in_weight"], cfg["num_heads"])
                   for x, q in zip(xs, ps)]
            attn = ring_attention_local([a[0] for a in qkv], [a[1] for a in qkv],
                                        [a[2] for a in qkv], mesh, axis,
                                        causal=True)
            xs = [x + _merge_heads(a) @ q[pre + "attn_out_weight"]
                  for x, a, q in zip(xs, attn, ps)]
            xs = [x + _ffn_dense(q, pre, _ln(x, q[pre + "ln2_gamma"],
                                             q[pre + "ln2_beta"]))
                  for x, q in zip(xs, ps)]
        return [_head(q, x) for x, q in zip(xs, ps)]

    def _loss(self, p, tokens, labels):
        labs = C.shard(labels, self.mesh, C.P(None, self.axis))
        losses = [_xent(lg, lab) for lg, lab in
                  zip(self._local_logits(p, tokens), labs)]
        # equal shards: the mean of the means is the global mean
        return _mean_to(losses, self.device)

    def _forward(self, p, tokens):
        return C.unshard(self._local_logits(p, tokens), self.mesh,
                         C.P(None, self.axis, None))


class PPLMTrainer(_LMTrainerBase):
    """Pipeline-parallel LM: the embedding and the blocks in heterogeneous
    stages over the ``axis`` positions (GPipe); the LM head on the drained
    microbatches. Parameters and optimizer state stay whole on the home
    device, as the JAX package's stay replicated: this pipelines compute,
    not parameter memory. Tokens and labels come as (M, B/M, T)
    microbatches."""

    def __init__(self, mesh, vocab_size, num_layers, model_dim, num_heads,
                 ffn_dim, seq_len, axis="pp", optimizer="sgd",
                 optimizer_params=None):
        S = mesh.shape[axis]
        if num_layers % S:
            raise ValueError("num_layers=%d must divide over %d pipeline "
                             "stages" % (num_layers, S))
        super().__init__(_lm_cfg(vocab_size, num_layers, model_dim, num_heads,
                                 ffn_dim, seq_len), mesh, optimizer,
                         optimizer_params)
        self.axis = axis

    def _stages(self):
        S = self.mesh.shape[self.axis]
        per = self.cfg["num_layers"] // S
        heads = self.cfg["num_heads"]

        def embed_and_blocks(p, tok):
            x = p["embed_weight"][tok.long()] + p["pos_embed_weight"][0]
            for i in range(per):
                x = _block_dense(p, "layer%d_" % i, x, heads)
            return x

        def blocks_only(first, p, x):
            for i in range(first, first + per):
                x = _block_dense(p, "layer%d_" % i, x, heads)
            return x

        return [embed_and_blocks] + [
            (lambda p, x, _f=s * per: blocks_only(_f, p, x))
            for s in range(1, S)]

    def _forward(self, p, tokens_mb):
        S = self.mesh.shape[self.axis]
        carry = (tokens_mb.shape[1], self.cfg["seq_len"], self.cfg["model_dim"])
        acts = pipeline_apply(self._stages(), [p] * S, tokens_mb, self.mesh,
                              axis=self.axis, carry_shape=carry,
                              carry_dtype=torch.float32)
        return _head(p, acts)

    def _loss(self, p, tokens_mb, labels_mb):
        return _xent(self._forward(p, tokens_mb), labels_mb)


class MoELMTrainer(_LMTrainerBase):
    """Expert-parallel MoE LM: the batch split over the ``axis`` positions,
    each block's FFN a Switch MoE whose experts are split over the same
    positions, tokens routed by all-to-all."""

    def __init__(self, mesh, vocab_size, num_layers, model_dim, num_heads,
                 ffn_dim, seq_len, num_experts, axis="ep",
                 capacity_factor=2.0, optimizer="sgd", optimizer_params=None):
        n = mesh.shape[axis]
        if num_experts % n:
            raise ValueError("num_experts=%d must divide %s=%d"
                             % (num_experts, axis, n))
        cfg = _lm_cfg(vocab_size, num_layers, model_dim, num_heads, ffn_dim,
                      seq_len)
        cfg["num_experts"] = num_experts
        super().__init__(cfg, mesh, optimizer, optimizer_params)
        self.axis = axis
        self.capacity_factor = capacity_factor

    def _local_logits(self, p, tokens):
        mesh, axis, cfg = self.mesh, self.axis, self.cfg
        D = cfg["model_dim"]
        spec = C.P(axis)
        toks = C.shard(tokens, mesh, spec)
        ps = _replicate({n: a for n, a in p.items()
                         if "ffn1_weight" not in n and "ffn2_weight" not in n},
                        mesh)
        xs = [q["embed_weight"][tok] + q["pos_embed_weight"][0]
              for tok, q in zip(toks, ps)]
        for layer in range(cfg["num_layers"]):
            pre = "layer%d_" % layer
            new = []
            for x, q in zip(xs, ps):
                h = _ln(x, q[pre + "ln1_gamma"], q[pre + "ln1_beta"])
                a = _dense_causal_attention(*_qkv(h, q[pre + "attn_in_weight"],
                                                  cfg["num_heads"]))
                new.append(x + _merge_heads(a) @ q[pre + "attn_out_weight"])
            xs = new
            hs = [_ln(x, q[pre + "ln2_gamma"], q[pre + "ln2_beta"]).reshape(-1, D)
                  for x, q in zip(xs, ps)]
            fs = moe_ffn_local(hs, [q[pre + "gate_weight"] for q in ps],
                               C.shard(p[pre + "ffn1_weight"], mesh, spec),
                               C.shard(p[pre + "ffn2_weight"], mesh, spec),
                               mesh, axis, capacity_factor=self.capacity_factor)
            xs = [x + f.reshape(x.shape) for x, f in zip(xs, fs)]
        return [_head(q, x) for x, q in zip(xs, ps)]

    def _loss(self, p, tokens, labels):
        labs = C.shard(labels, self.mesh, C.P(self.axis))
        losses = [_xent(lg, lab) for lg, lab in
                  zip(self._local_logits(p, tokens), labs)]
        return _mean_to(losses, self.device)

    def _forward(self, p, tokens):
        return C.unshard(self._local_logits(p, tokens), self.mesh,
                         C.P(self.axis, None, None))
