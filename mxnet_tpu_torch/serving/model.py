"""Functional Transformer-LM forward for serving (the port of
``mxnet_tpu/serving/model.py``).

Same parameter names and the same numerics op for op as the JAX package
(LayerNorm composed from mean/square/sqrt with the 1e-5 epsilon, fused qkv
projection, causal flash attention for prefill, paged attention for
decode), in float32 at full precision: the package turns TF32 off at
import. The projections, FFN and LM head are ``torch.matmul``, as the JAX
package leaves them to XLA; attention goes through the hand-written
kernels of :mod:`..ops.attention` on the card.

Where the JAX step functions are pure and the engine donates the pool
pages, here ``prefill``, ``decode`` and ``extend`` write their K/V into
``k_pages`` / ``v_pages`` IN PLACE and return the same tensors. None of
them waits for the host (no ``.item()``, no branch on a tensor's value,
no ``nonzero``; the prompt length is a device tensor), so each can be
captured once per shape bucket as a CUDA graph and replayed
(:mod:`.graphs`).

Padded-lane safety contract, as in the JAX package: dead lanes write
through the block table's TRASH entries (block 0) and read under a
context-length mask. A decode (or verify-lane) position >= max_len writes
to the trash block, its token is -1 and its logits are NaN.
"""
import numpy as np
import torch

from .. import context
from ..base import torch_dtype
from ..ops.attention import (flash_attention, paged_attention,
                             paged_attention_multi)

#: parameter init scale matching models/transformer_lm.py's Normal(0.02)
_INIT_SCALE = 0.02


class ModelConfig:
    """Static Transformer-LM shape config. ``max_len`` is the training
    graph's ``seq_len``: the position-embedding table bounds every
    stream's total length."""

    __slots__ = ("vocab_size", "num_layers", "model_dim", "num_heads",
                 "ffn_dim", "max_len")

    def __init__(self, vocab_size=32000, num_layers=4, model_dim=256,
                 num_heads=4, ffn_dim=1024, max_len=128):
        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.model_dim = int(model_dim)
        self.num_heads = int(num_heads)
        self.ffn_dim = int(ffn_dim)
        self.max_len = int(max_len)
        if self.model_dim % self.num_heads:
            raise ValueError("model_dim must divide by num_heads")

    def key(self):
        """The model shape: equal keys, interchangeable weights."""
        return (self.vocab_size, self.num_layers, self.model_dim,
                self.num_heads, self.ffn_dim, self.max_len)

    def _slot_names(self):
        # the whole MRO: on a subclass (ServingConfig) bare self.__slots__
        # names the subclass's slots only
        names = []
        for klass in reversed(type(self).__mro__):
            names.extend(getattr(klass, "__slots__", ()))
        return names

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, ", ".join(
            "%s=%r" % (k, getattr(self, k)) for k in self._slot_names()))


def param_shapes(cfg):
    """Name -> shape for every weight the serving forward consumes —
    exactly the training graph's ``arg_dict`` names (minus data/label)."""
    m, f, v = cfg.model_dim, cfg.ffn_dim, cfg.vocab_size
    shapes = {
        "embed_weight": (v, m),
        "pos_embed_weight": (1, cfg.max_len, m),
        "final_ln_gamma": (1, 1, m),
        "final_ln_beta": (1, 1, m),
        "lm_head_weight": (v, m),
        "lm_head_bias": (v,),
    }
    for i in range(cfg.num_layers):
        p = "layer%d" % i
        shapes.update({
            p + "_ln1_gamma": (1, 1, m), p + "_ln1_beta": (1, 1, m),
            p + "_ln2_gamma": (1, 1, m), p + "_ln2_beta": (1, 1, m),
            p + "_attn_in_weight": (3 * m, m),
            p + "_attn_out_weight": (m, m),
            p + "_ffn1_weight": (f, m), p + "_ffn1_bias": (f,),
            p + "_ffn2_weight": (m, f), p + "_ffn2_bias": (m,),
        })
    return shapes


def random_params(cfg, seed=0, dtype=np.float32):
    """Deterministic host-side random weights (gamma=1, beta/bias=0,
    weights ~N(0, 0.02)) from numpy's ``RandomState``: byte-identical to
    the JAX package's ``random_params`` for the same config and seed."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith("_gamma"):
            out[name] = np.ones(shape, dtype)
        elif name.endswith(("_beta", "_bias")):
            out[name] = np.zeros(shape, dtype)
        else:
            out[name] = (rng.randn(*shape) * _INIT_SCALE).astype(dtype)
    return out


def as_device_params(arg_params, cfg, dtype=None, device=None):
    """Carry a params dict onto the device as torch tensors, validating
    names and shapes against the config. Values may be numpy arrays (the
    JAX package's ``random_params``, or a checkpoint's ``arg_params``
    converted with ``.asnumpy()``), anything with ``asnumpy()``, or torch
    tensors. Extra entries are ignored. ``device`` None means the card
    (:func:`..context.default_device`)."""
    device = context.resolve(device)
    dtype = None if dtype is None else torch_dtype(dtype)
    want = param_shapes(cfg)
    out = {}
    missing = []
    for name, shape in want.items():
        if name not in arg_params:
            missing.append(name)
            continue
        a = arg_params[name]
        if hasattr(a, "asnumpy"):
            a = a.asnumpy()
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
        if tuple(a.shape) != tuple(shape):
            raise ValueError("param %s: shape %s != expected %s (config %r)"
                             % (name, tuple(a.shape), shape, cfg))
        out[name] = a.to(device=device, dtype=dtype).contiguous()
    if missing:
        raise ValueError("params missing for serving config %r: %s"
                         % (cfg, sorted(missing)))
    return out


# ---------------------------------------------------------------------------
# functional blocks (numerics mirror models/transformer_lm.py op for op)
# ---------------------------------------------------------------------------


def draft_config(cfg, spec):
    """Resolve a draft-model selection against a target config.
    ``"self"`` is the self-drafting harness: the draft IS the target shape
    (the engine then shares the target's weights, so greedy proposals
    match the verify pass and acceptance sits near 1.0); any other name
    must be a ``models/transformer_lm.py`` ``SERVING_DRAFT_PRESETS`` entry.
    vocab_size and max_len always follow the target."""
    from ..models.transformer_lm import SERVING_DRAFT_PRESETS

    if spec == "self":
        return ModelConfig(cfg.vocab_size, cfg.num_layers, cfg.model_dim,
                           cfg.num_heads, cfg.ffn_dim, cfg.max_len)
    if spec not in SERVING_DRAFT_PRESETS:
        raise ValueError(
            "unknown draft model %r: expected 'self' or one of %s "
            "(models/transformer_lm.py SERVING_DRAFT_PRESETS)"
            % (spec, sorted(SERVING_DRAFT_PRESETS)))
    p = SERVING_DRAFT_PRESETS[spec]
    return ModelConfig(cfg.vocab_size, p["num_layers"], p["model_dim"],
                       p["num_heads"], p["ffn_dim"], cfg.max_len)


def _layer_norm(x, gamma, beta):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * gamma + beta


def _ffn(x2d, params, prefix):
    f = x2d @ params[prefix + "_ffn1_weight"].T
    f = torch.clamp_min(f + params[prefix + "_ffn1_bias"], 0)
    f = f @ params[prefix + "_ffn2_weight"].T
    return f + params[prefix + "_ffn2_bias"]


def prefill(params, tokens, length, block_table, k_pages, v_pages, cfg):
    """Full-sequence prefill for ONE request at a padded bucket length.

    tokens:      (1, S) int tensor, S a multiple of the pool block size
                 (prompt left-aligned, tail padded with 0s)
    length:      true prompt length (1 <= length <= S): a (1,) int32
                 tensor on the tokens' device (what a bucket's CUDA graph
                 takes: one graph serves every length in its bucket) or a
                 host int
    block_table: (S // block_size,) int tensor — the request's blocks in
                 position order; tail entries past the prompt = 0 (trash)
    k/v_pages:   the pool pages, (L, N, bs, H, D), written in place

    Returns ``(next_token (1,) int32, logits (1, V), k_pages, v_pages)``.
    Attention is causal flash attention: padded tail rows compute garbage
    but cannot reach rows < length, and their K/V land in trash blocks.
    """
    S = tokens.shape[1]
    m, hh = cfg.model_dim, cfg.num_heads
    hd = m // hh
    bs = k_pages.shape[2]

    x = params["embed_weight"][tokens] + params["pos_embed_weight"][:, :S]

    def split_heads(t):  # (1, S, M) -> contiguous (1, H, S, hd)
        return t.reshape(1, S, hh, hd).transpose(1, 2).contiguous()

    k_all, v_all = [], []
    for i in range(cfg.num_layers):
        p = "layer%d" % i
        h = _layer_norm(x, params[p + "_ln1_gamma"], params[p + "_ln1_beta"])
        qkv = h @ params[p + "_attn_in_weight"].T
        q, k, v = qkv.split(m, dim=-1)                          # (1, S, M)
        k_all.append(k.reshape(S, hh, hd))
        v_all.append(v.reshape(S, hh, hd))
        attn = flash_attention(split_heads(q), split_heads(k),
                               split_heads(v), True)
        attn = attn.transpose(1, 2).reshape(1, S, m)
        x = x + attn @ params[p + "_attn_out_weight"].T
        h = _layer_norm(x, params[p + "_ln2_gamma"], params[p + "_ln2_beta"])
        x = x + _ffn(h.reshape(S, m), params, p).reshape(1, S, m)

    # scatter every layer's K/V through the block table (trash entries
    # absorb the padded tail)
    kw = torch.stack(k_all).reshape(cfg.num_layers, S // bs, bs, hh, hd)
    vw = torch.stack(v_all).reshape(cfg.num_layers, S // bs, bs, hh, hd)
    table = block_table.long()
    k_pages[:, table] = kw.to(k_pages.dtype)
    v_pages[:, table] = vw.to(v_pages.dtype)

    x = _layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"])
    if not isinstance(length, torch.Tensor):
        length = torch.tensor([length], dtype=torch.int32,
                              device=tokens.device)
    last = length.reshape(1).to(torch.int64) - 1                # on device
    h_last = x[0].index_select(0, last)                         # (1, M)
    logits = h_last @ params["lm_head_weight"].T + params["lm_head_bias"]
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_token, logits, k_pages, v_pages


def decode(params, tokens, positions, block_tables, context_lens,
           k_pages, v_pages, cfg):
    """The fused paged decode step: one token for every sequence in the
    padded batch.

    tokens:       (B,) int tensor — each stream's pending input token
    positions:    (B,) int tensor — the slot this token is written at
    block_tables: (B, max_len // block_size) int32 — pool blocks per
                  stream in position order; unused/padded entries = 0
    context_lens: (B,) int32 — valid tokens AFTER this step's write
    k/v_pages:    pool pages, written in place

    Returns ``(next_tokens (B,) int32, logits (B, V), k_pages, v_pages)``.
    Out-of-range positions (>= max_len) honour the overflow contract.
    """
    B = tokens.shape[0]
    m, hh = cfg.model_dim, cfg.num_heads
    hd = m // hh
    bs = k_pages.shape[2]

    positions = positions.long()
    in_range = positions < cfg.max_len
    safe_pos = torch.clamp_max(positions, cfg.max_len - 1)
    page_ids = torch.gather(block_tables.long(), 1,
                            (safe_pos // bs)[:, None])[:, 0]
    page_ids = torch.where(in_range, page_ids, 0)  # overflow -> trash block
    slots = torch.where(in_range, safe_pos % bs, 0)

    pos_tab = params["pos_embed_weight"].reshape(cfg.max_len, m)
    x = params["embed_weight"][tokens.long()] + pos_tab[safe_pos]  # (B, M)
    x = x[:, None, :]                                              # (B, 1, M)

    for i in range(cfg.num_layers):
        p = "layer%d" % i
        h = _layer_norm(x, params[p + "_ln1_gamma"], params[p + "_ln1_beta"])
        qkv = h @ params[p + "_attn_in_weight"].T
        q, k_new, v_new = qkv.split(m, dim=-1)                  # (B, 1, M)
        q = q.reshape(B, hh, hd).contiguous()   # the kernel takes dense q
        k_pages[i, page_ids, slots] = k_new.reshape(B, hh, hd).to(
            k_pages.dtype)
        v_pages[i, page_ids, slots] = v_new.reshape(B, hh, hd).to(
            v_pages.dtype)
        attn = paged_attention(q, k_pages[i], v_pages[i], block_tables,
                               context_lens)                    # (B, H, hd)
        x = x + attn.reshape(B, 1, m) @ params[p + "_attn_out_weight"].T
        h = _layer_norm(x, params[p + "_ln2_gamma"], params[p + "_ln2_beta"])
        x = x + _ffn(h.reshape(B, m), params, p).reshape(B, 1, m)

    x = _layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"])
    logits = x.reshape(B, m) @ params["lm_head_weight"].T \
        + params["lm_head_bias"]                                 # (B, V)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    # overflow contract: poison the overflowed lanes, loudly
    next_tokens = torch.where(in_range, next_tokens, -1)
    logits = torch.where(in_range[:, None], logits, float("nan"))
    return next_tokens, logits, k_pages, v_pages


def extend(params, tokens, positions, block_tables, context_lens,
           k_pages, v_pages, cfg):
    """The speculative-decoding VERIFY step: :func:`decode` generalized to
    T tokens per stream, scored in ONE multi-query paged-attention pass.

    tokens:       (B, T) int tensor — lane 0 is the stream's pending
                  token, lanes 1..T-1 the draft's proposals
    positions:    (B, T) int tensor — each lane's write slot
    block_tables: (B, max_len // block_size) int32 — ONE table per stream
    context_lens: (B, T) int32 — valid tokens PER LANE after this step's
                  writes (positions + 1 for live lanes): per-lane masking
                  is what makes the window causal
    k/v_pages:    pool pages, written in place

    Returns ``(next_tokens (B, T) int32, logits (B, T, V), k_pages,
    v_pages)``: lane t's output is the target's greedy next token given
    the stream's context plus window lanes 0..t — what :func:`decode`
    would produce fed the window one token at a time. Out-of-range lanes
    (position >= max_len) honour the overflow contract per lane.
    """
    B, T = tokens.shape
    m, hh = cfg.model_dim, cfg.num_heads
    hd = m // hh
    bs = k_pages.shape[2]

    positions = positions.long()
    in_range = positions < cfg.max_len                          # (B, T)
    safe_pos = torch.clamp_max(positions, cfg.max_len - 1)
    page_ids = torch.gather(block_tables.long(), 1, safe_pos // bs)
    page_ids = torch.where(in_range, page_ids, 0)  # overflow -> trash block
    slots = torch.where(in_range, safe_pos % bs, 0)

    pos_tab = params["pos_embed_weight"].reshape(cfg.max_len, m)
    x = params["embed_weight"][tokens.long()] + pos_tab[safe_pos]  # (B, T, M)

    for i in range(cfg.num_layers):
        p = "layer%d" % i
        h = _layer_norm(x, params[p + "_ln1_gamma"], params[p + "_ln1_beta"])
        qkv = h @ params[p + "_attn_in_weight"].T
        q, k_new, v_new = qkv.split(m, dim=-1)                  # (B, T, M)
        q = q.reshape(B, T, hh, hd).contiguous()   # the kernel takes dense q
        # window lanes write their K/V first (distinct slots per lane;
        # overflow lanes pile into trash), then every lane reads back under
        # its OWN context length: lane t cannot see lanes > t
        k_pages[i, page_ids, slots] = k_new.reshape(B, T, hh, hd).to(
            k_pages.dtype)
        v_pages[i, page_ids, slots] = v_new.reshape(B, T, hh, hd).to(
            v_pages.dtype)
        attn = paged_attention_multi(q, k_pages[i], v_pages[i], block_tables,
                                     context_lens)              # (B, T, H, hd)
        x = x + attn.reshape(B, T, m) @ params[p + "_attn_out_weight"].T
        h = _layer_norm(x, params[p + "_ln2_gamma"], params[p + "_ln2_beta"])
        x = x + _ffn(h.reshape(B * T, m), params, p).reshape(B, T, m)

    x = _layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"])
    logits = (x.reshape(B * T, m) @ params["lm_head_weight"].T
              + params["lm_head_bias"]).reshape(B, T, -1)       # (B, T, V)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    # overflow contract: poison the overflowed lanes, loudly
    next_tokens = torch.where(in_range, next_tokens, -1)
    logits = torch.where(in_range[:, :, None], logits, float("nan"))
    return next_tokens, logits, k_pages, v_pages
