"""Attention ops of the port: flash attention (forward and backward),
paged decode and multi-query paged attention (the speculative verify
pass).

The PyTorch counterpart of ``mxnet_tpu/ops/attention.py``, in the same
layouts: (B, H, S, D) for flash attention and (N, bs, H, D) pool pages
for paged attention.

Each public function dispatches on ``q.device.type``:

* ``cpu``  — the plain PyTorch version (:func:`_flash_forward_plain` and
  :func:`_flash_backward_plain`, the twins of the JAX package's
  ``_scan_forward``/``_scan_backward``; :func:`paged_attention_reference`
  and :func:`paged_attention_multi_reference`, the twins of its XLA
  references);
* ``cuda`` — the hand-written Hopper kernel (``csrc/flash_fwd.cu`` for
  ``_pallas_forward``; ``csrc/flash_bwd_dkv.cu`` and
  ``csrc/flash_bwd_dq.cu`` for the two kernels of ``_pallas_backward``;
  for head dimensions past :data:`FLASH_MAX_D` the three kernels of
  ``csrc/flash_wide.cu`` in their place, picked by the shape alone;
  ``csrc/paged_decode.cu`` for ``_paged_pallas``;
  ``csrc/paged_decode_multi.cu`` for ``_paged_pallas_multi``), or
  :class:`MXNetError` for a shape or dtype the kernel does not take.

Nothing falls back: a CUDA tensor reaches its kernel or raises.
:func:`flash_attention` is a ``torch.autograd.Function`` whose backward
runs the two backward kernels; the ops ``_contrib_FlashAttention`` and
``_contrib_MultiHeadAttention`` are registered on top of it,
``_contrib_PagedAttention`` on :func:`paged_attention`, and
``_contrib_CachedMultiHeadAttention`` (the decode symbol's cached step,
dense torch attention over its aux caches) beside them.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build
from .registry import Param, get_op, register

__all__ = ["attention_reference", "flash_attention_forward",
           "flash_attention_backward", "flash_attention_backward_f32",
           "flash_attention",
           "paged_attention_reference", "paged_attention",
           "paged_attention_multi_reference", "paged_attention_multi"]

_NEG_INF = -1e30

#: dtype codes of the kernels' C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the largest head dimension the tensor-core flash kernels take: at D 512
#: their K/V ring alone would need 264 KB of the 227 KB of shared memory a
#: block has. Wider heads (any multiple of 8, as the JAX package computes
#: them) take the wide route, ``csrc/flash_wide.cu``
FLASH_MAX_D = 256
#: the longest sequence the flash kernels take: 16-row tiles on the
#: grid's y axis, at most 65535 of them
FLASH_MAX_S = 16 * 65535
#: the largest head dimension and pool block size the paged kernels take
#: (csrc/paged_common.cuh: a query row, a pool block's scores and the
#: staging ring in the 227 KB of shared memory)
PAGED_MAX_D = 4096
PAGED_MAX_BS = 16384


def _scale(sm_scale, d):
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def attention_reference(q, k, v, causal=False, sm_scale=None):
    """Naive softmax attention — the numeric oracle (O(S^2) memory)."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None]
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ------------------------------------------------------------ flash forward
def _flash_forward_plain(q, k, v, causal, sm_scale, block_k=256):
    """Plain flash forward: a loop over KV blocks with the online softmax
    (m, l, acc) in float32 — the twin of the JAX ``_scan_forward``. The
    last block is short instead of zero-padded; padded keys contribute
    exactly 0 there, so the arithmetic is the same. Returns (out, lse)."""
    sq = q.shape[2]
    sk = k.shape[2]
    block_k = min(block_k, sk)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3], _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    qi = torch.arange(sq, device=q.device)
    for start in range(0, sk, block_k):
        kb = kf[:, :, start:start + block_k]
        vb = vf[:, :, start:start + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * sm_scale
        if causal:
            ki = start + torch.arange(kb.shape[2], device=q.device)
            s = torch.where(qi[:, None] >= ki[None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


def _check_flash(q, k, v):
    """Validate what ``csrc/flash_fwd.cu`` takes; raises otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash attention wants (B, H, S, D) q/k/v, got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, h, sq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise MXNetError("flash attention: k/v %s %s do not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash kernel takes float32, bfloat16 or float16 "
                         "q/k/v of one dtype, got %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if d % 8 or d < 8:
        raise MXNetError("flash kernel takes a head_dim that is a multiple "
                         "of 8, got %d" % d)
    if not (1 <= sq <= FLASH_MAX_S and 1 <= k.shape[2] <= FLASH_MAX_S
            and 1 <= b * h < 2 ** 31):
        raise MXNetError("flash kernel: empty or oversized problem %s / %s"
                         % (tuple(q.shape), tuple(k.shape)))
    if not (q.device == k.device == v.device):
        raise MXNetError("flash attention: q/k/v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash kernel takes contiguous q/k/v")


def _aligned16(x):
    """``x``, or a fresh copy when its data does not start on 16 bytes:
    the kernels stage their rows with 16-byte ``cp.async`` copies."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _flash_forward_cuda(q, k, v, causal, sm_scale):
    _check_flash(q, k, v)
    # the kernels stage Q (the wide one), K and V with 16-byte cp.async
    q, k, v = (_aligned16(x) for x in (q, k, v))
    b, h, sq, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    kernel = _build.FLASH_FWD if d <= FLASH_MAX_D else _build.FLASH_WIDE_FWD
    with torch.cuda.device(q.device):
        kernel.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, k.shape[2], d, sm_scale, int(causal),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    return out, lse


def flash_attention_forward(q, k, v, causal=False, sm_scale=None):
    """Flash-attention forward over (B, H, S, D): returns ``(out, lse)``,
    both float32 — the residuals a backward consumes. CPU tensors take the
    plain version, CUDA tensors the ``flash_fwd`` kernel (``flash_wide_fwd``
    past D 256)."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, causal, sm_scale)
    raise MXNetError("flash attention: no implementation on %s" % q.device)


# ----------------------------------------------------------- flash backward
def _flash_backward_plain(q, k, v, out, lse, g, causal, sm_scale,
                          block_k=256, keep_f32=False):
    """Plain flash backward: P recomputed per KV block from the saved
    ``lse``, dq accumulated across blocks, dk/dv written per block — the
    twin of the JAX ``_scan_backward``. ``delta = rowsum(dout * out)`` in
    float32. Masked scores are pinned to -1e30, so their p is exactly 0;
    the last block is short instead of zero-padded. Returns (dq, dk, dv)
    in the dtypes of q, k and v (float32 with ``keep_f32``)."""
    sq = q.shape[2]
    sk = k.shape[2]
    block_k = min(block_k, sk)
    qf, kf, vf = q.float(), k.float(), v.float()
    gf = g.float()
    delta = (out.float() * gf).sum(dim=-1)
    qi = torch.arange(sq, device=q.device)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for start in range(0, sk, block_k):
        kb = kf[:, :, start:start + block_k]
        vb = vf[:, :, start:start + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * sm_scale
        if causal:
            ki = start + torch.arange(kb.shape[2], device=q.device)
            s = torch.where(qi[:, None] >= ki[None, :], s, _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, gf))
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vb)
        ds = p * (dp - delta[..., None]) * sm_scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf))
    dk, dv = torch.cat(dks, dim=2), torch.cat(dvs, dim=2)
    if keep_f32:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_backward_cuda(q, k, v, out, lse, g, causal, sm_scale,
                         keep_f32=False):
    _check_flash(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous():
        raise MXNetError("flash backward takes a contiguous output gradient "
                         "of q's shape and dtype, got %s %s"
                         % (tuple(g.shape), g.dtype))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise MXNetError("flash backward takes a contiguous float32 lse of "
                         "shape %s" % ((b, h, sq),))
    if out.shape != q.shape:
        raise MXNetError("flash backward: out %s does not match q %s"
                         % (tuple(out.shape), tuple(q.shape)))
    if not (g.device == lse.device == out.device == q.device):
        raise MXNetError("flash backward: inputs on different devices")
    delta = (out.float() * g.float()).sum(dim=-1)
    # both kernels stage their tiles with 16-byte cp.async copies
    q, k, v, g = (_aligned16(x) for x in (q, k, v, g))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    code = _DTYPE_CODE[q.dtype]
    if d <= FLASH_MAX_D:
        dkv, dq_kernel = _build.FLASH_BWD_DKV, _build.FLASH_BWD_DQ
    else:
        dkv, dq_kernel = _build.FLASH_WIDE_BWD_DKV, _build.FLASH_WIDE_BWD_DQ
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        dkv.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk, d, sm_scale, int(causal), code, stream)
        dq_kernel.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, sk, d, sm_scale, int(causal), code, stream)
    if keep_f32:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_f32(q, k, v, out, lse, g, causal=False,
                                 sm_scale=None):
    """:func:`flash_attention_backward` with ``(dq, dk, dv)`` left in the
    kernels' float32, for callers that sum several calls' gradients (ring
    attention) and round once at the end."""
    return _flash_backward(q, k, v, out, lse, g, causal, sm_scale, True)


def _flash_backward(q, k, v, out, lse, g, causal, sm_scale, keep_f32):
    sm_scale = _scale(sm_scale, q.shape[-1])
    if q.device.type == "cuda":
        return _flash_backward_cuda(q, k, v, out, lse, g, causal, sm_scale,
                                    keep_f32=keep_f32)
    if q.device.type == "cpu":
        return _flash_backward_plain(q, k, v, out, lse, g, causal, sm_scale,
                                     keep_f32=keep_f32)
    raise MXNetError("flash attention: no implementation on %s" % q.device)


def flash_attention_backward(q, k, v, out, lse, g, causal=False,
                             sm_scale=None):
    """Flash-attention backward over (B, H, S, D) from the forward's
    residuals (``out`` and float32 ``lse``) and the output gradient ``g``:
    returns ``(dq, dk, dv)`` in the dtypes of q, k and v. CPU tensors take
    the plain version, CUDA tensors the ``flash_bwd_dkv`` and
    ``flash_bwd_dq`` kernels (their ``flash_wide_*`` twins past D 256)."""
    return _flash_backward(q, k, v, out, lse, g, causal, sm_scale, False)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``flash_attention`` custom_vjp: the forward keeps
    (q, k, v, out, lse); the backward hands the kernels a contiguous
    gradient (the head merge after it is a transpose, so autograd gives a
    strided one)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_attention_forward(q, k, v, causal, sm_scale)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, g.contiguous(), ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Memory-efficient attention over (B, H, S, D), output in q's dtype
    (as the JAX package's ``_forward_impl`` casts it); differentiable
    through the hand-written backward kernels."""
    return _FlashAttention.apply(q, k, v, causal,
                                 _scale(sm_scale, q.shape[-1]))


# ------------------------------------------------------------ registered ops
@register(
    "_contrib_FlashAttention",
    arg_names=("query", "key", "value"),
    params={
        "causal": Param.bool(False),
        "sm_scale": Param.float(-1.0),
    },
)
def _flash_attention_op(octx, attrs, args, auxs):
    q, k, v = args
    scale = attrs["sm_scale"]
    return [flash_attention(q, k, v, attrs["causal"],
                            None if scale <= 0 else scale)], []


get_op("_contrib_FlashAttention")._infer_shape = (
    lambda attrs, in_shapes, aux_shapes: (in_shapes, [tuple(in_shapes[0])], []))


@register(
    "_contrib_MultiHeadAttention",
    arg_names=("data", "in_weight", "out_weight"),
    params={
        "num_heads": Param.int(),
        "causal": Param.bool(True),
    },
)
def _mha_op(octx, attrs, args, auxs):
    """Self-attention block over (batch, seq, model): fused qkv projection,
    flash attention, output projection. in_weight (3*model, model) and
    out_weight (model, model) are laid out like FullyConnected (out, in).
    The head split and merge copy to contiguous memory: the kernels take
    nothing else."""
    x, w_in, w_out = args
    bsz, seq, model = x.shape
    heads = attrs["num_heads"]
    hd = model // heads
    qkv = torch.matmul(x, w_in.t())                       # (B, S, 3*model)
    q, k, v = qkv.split(model, dim=-1)

    def split_heads(t):
        return t.reshape(bsz, seq, heads, hd).transpose(1, 2).contiguous()

    out = flash_attention(split_heads(q), split_heads(k), split_heads(v),
                          attrs["causal"])
    out = out.transpose(1, 2).contiguous().reshape(bsz, seq, model)
    return [torch.matmul(out, w_out.t())], []


def _mha_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    if data is None:
        raise ValueError("MultiHeadAttention: data shape required")
    model = data[2]
    if in_shapes[1] is None:
        in_shapes[1] = (3 * model, model)
    if in_shapes[2] is None:
        in_shapes[2] = (model, model)
    return in_shapes, [tuple(data)], []


get_op("_contrib_MultiHeadAttention")._infer_shape = _mha_infer_shape


# ---------------------------------------------------- incremental decoding
@register(
    "_contrib_CachedMultiHeadAttention",
    arg_names=("data", "in_weight", "out_weight", "position"),
    aux_names=("cache_k", "cache_v"),
    params={
        "num_heads": Param.int(),
        "max_len": Param.int(),
    },
)
def _cached_mha_op(octx, attrs, args, auxs):
    """One autoregressive decode step over static-shape KV caches, the
    aux states ``cache_k``/``cache_v`` of shape (batch, heads, max_len,
    head_dim): the step's k/v are written at ``position`` and the query
    attends over positions <= it. data (B, 1, model); position (1,) float.

    Overflow contract, as in the JAX package: a position outside
    [0, max_len) drops both cache writes (the index is clipped first, so
    the dropped write never leaves the cache) and poisons the output to
    NaN. The position stays on the device: nothing here waits for the
    host. The attention over the cache is dense torch, as the JAX op
    leaves it to XLA. The new caches come back detached, so an aux never
    carries autograd history from one step into the next."""
    x, w_in, w_out, position = args
    cache_k, cache_v = auxs
    bsz, _one, model = x.shape
    heads = attrs["num_heads"]
    max_len = attrs["max_len"]
    hd = model // heads
    pos_raw = position.reshape(()).to(torch.int32)
    in_range = (pos_raw >= 0) & (pos_raw < max_len)
    pos = pos_raw.clamp(0, max_len - 1).to(torch.int64).reshape(1)
    qkv = torch.matmul(x, w_in.t())                       # (B, 1, 3*model)
    q, k_new, v_new = qkv.split(model, dim=-1)

    def heads_first(t):                                   # (B, H, 1, hd)
        return t.reshape(bsz, 1, heads, hd).transpose(1, 2)

    q, k_new, v_new = heads_first(q), heads_first(k_new), heads_first(v_new)
    new_k = cache_k.index_copy(2, pos, k_new.to(cache_k.dtype))
    new_v = cache_v.index_copy(2, pos, v_new.to(cache_v.dtype))
    new_k = torch.where(in_range, new_k, cache_k)
    new_v = torch.where(in_range, new_v, cache_v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), new_k.float()) \
        / math.sqrt(hd)
    valid = torch.arange(max_len, device=x.device) <= pos
    s = torch.where(valid, s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(new_v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, new_v)
    out = out.transpose(1, 2).reshape(bsz, 1, model)
    out = torch.matmul(out, w_out.t())
    out = torch.where(in_range, out, math.nan)
    return [out], [new_k.detach(), new_v.detach()]


def _cached_mha_infer(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    if data is None:
        raise ValueError("CachedMultiHeadAttention: data shape required")
    b, _one, model = data
    heads = attrs["num_heads"]
    hd = model // heads
    if in_shapes[1] is None:
        in_shapes[1] = (3 * model, model)
    if in_shapes[2] is None:
        in_shapes[2] = (model, model)
    if in_shapes[3] is None:
        in_shapes[3] = (1,)
    cache = (b, heads, attrs["max_len"], hd)
    return in_shapes, [tuple(data)], [cache, cache]


get_op("_contrib_CachedMultiHeadAttention")._infer_shape = _cached_mha_infer


# ------------------------------------------------------------- paged decode
def paged_attention_reference(q, k_pages, v_pages, block_tables, context_lens,
                              sm_scale=None):
    """Plain paged decode attention — the twin of the JAX package's
    ``paged_attention_reference``.

    q (B, H, D); k_pages/v_pages (N, bs, H, D); block_tables (B, nb) int;
    context_lens (B,) int. Returns (B, H, D) in q's dtype. Positions >=
    context_len contribute exactly zero (scores pinned to -1e30) and a
    context_len == 0 row returns exactly zero."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    b, h, d = q.shape
    t = block_tables.shape[1] * k_pages.shape[1]
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, t, h, d).float()
    v = v_pages[tables].reshape(b, t, h, d).float()
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * sm_scale
    lens = context_lens.to(q.device)
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    s = torch.where(valid[:, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    # an all-masked row would softmax to uniform and average garbage
    p = torch.where((lens > 0)[:, None, None], p, 0.0)
    return torch.einsum("bht,bthd->bhd", p, v).to(q.dtype)


def _check_paged(q, k_pages, v_pages, block_tables, context_lens):
    """Validate what ``csrc/paged_decode.cu`` takes; raises otherwise."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise MXNetError("paged attention wants q (B, H, D) and pages "
                         "(N, bs, H, D), got %s %s"
                         % (tuple(q.shape), tuple(k_pages.shape)))
    b, h, d = q.shape
    if (v_pages.shape != k_pages.shape or k_pages.shape[2:] != (h, d)):
        raise MXNetError("paged attention: pages %s %s do not match q %s"
                         % (tuple(k_pages.shape), tuple(v_pages.shape),
                            tuple(q.shape)))
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or context_lens.shape != (b,):
        raise MXNetError("paged attention: tables %s / lens %s for batch %d"
                         % (tuple(block_tables.shape),
                            tuple(context_lens.shape), b))
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _DTYPE_CODE \
            or v_pages.dtype != k_pages.dtype:
        raise MXNetError("paged kernel takes float32/bfloat16/float16 q and "
                         "pages, got %s %s %s" % (q.dtype, k_pages.dtype,
                                                  v_pages.dtype))
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise MXNetError("paged kernel takes int32 block tables and lengths")
    _check_paged_sizes(b, h, d, k_pages.shape[1], block_tables.shape[1],
                       (q.shape, k_pages.shape))
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if any(x.device != q.device for x in tensors):
        raise MXNetError("paged attention: inputs on different devices")
    if not all(x.is_contiguous() for x in tensors):
        raise MXNetError("paged kernel takes contiguous inputs")


def _check_paged_sizes(b, h, d, bs, nb, shapes):
    """The sizes both paged kernels take: what the JAX package's
    ``_paged_shapes_ok`` asks (D a multiple of 8, at least 8), within what
    their shared memory holds."""
    if d % 8 or not 8 <= d <= PAGED_MAX_D or not 1 <= bs <= PAGED_MAX_BS \
            or b < 1 or not 1 <= h <= 65535 or nb < 1:
        raise MXNetError("paged kernel takes head_dim a multiple of 8 in "
                         "[8, %d], block_size <= %d, B >= 1, 1 <= H <= 65535 "
                         "and a table of >= 1 slot; got %s"
                         % (PAGED_MAX_D, PAGED_MAX_BS,
                            " / ".join(str(tuple(x)) for x in shapes)))


def _paged_cuda(q, k_pages, v_pages, block_tables, context_lens, sm_scale):
    _check_paged(q, k_pages, v_pages, block_tables, context_lens)
    # the kernel stages K/V rows with 16-byte cp.async copies, and reads
    # and writes float32 rows (a cast is exact, and rounds as it would)
    k_pages, v_pages = _aligned16(k_pages), _aligned16(v_pages)
    b, h, d = q.shape
    qf = q.float()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.PAGED_DECODE.launch(
            qf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            b, h, d, k_pages.shape[0], k_pages.shape[1],
            block_tables.shape[1], sm_scale, _DTYPE_CODE[k_pages.dtype],
            torch.cuda.current_stream().cuda_stream)
    return out.to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    sm_scale=None):
    """Paged ragged decode attention over a shared KV block pool. CPU
    tensors take :func:`paged_attention_reference`, CUDA tensors the
    ``paged_decode`` kernel (int32 tables and lengths on the card)."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    if q.device.type == "cuda":
        return _paged_cuda(q, k_pages, v_pages, block_tables, context_lens,
                           sm_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         context_lens, sm_scale)
    raise MXNetError("paged attention: no implementation on %s" % q.device)


# ------------------------------------------- paged multi-query (verify)

def paged_attention_multi_reference(q, k_pages, v_pages, block_tables,
                                    context_lens, sm_scale=None):
    """Plain multi-query paged attention — the twin of the JAX package's
    ``paged_attention_multi_reference``.

    q (B, T, H, D): T query lanes per sequence; k_pages/v_pages
    (N, bs, H, D); block_tables (B, nb) int, ONE table per sequence;
    context_lens (B, T) int, valid pool positions PER LANE. Returns
    (B, T, H, D) in q's dtype. Lane t reads only positions
    < context_lens[b, t] (scores pinned to -1e30 elsewhere); a lane with
    context 0 returns exactly zero."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    b, _tq, h, d = q.shape
    t = block_tables.shape[1] * k_pages.shape[1]
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, t, h, d).float()
    v = v_pages[tables].reshape(b, t, h, d).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * sm_scale
    lens = context_lens.to(q.device)
    valid = torch.arange(t, device=q.device)[None, None, :] < lens[:, :, None]
    s = torch.where(valid[:, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    # an all-masked lane would softmax to uniform and average garbage
    p = torch.where((lens > 0)[:, None, :, None], p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def _check_paged_multi(q, k_pages, v_pages, block_tables, context_lens):
    """Validate what ``csrc/paged_decode_multi.cu`` takes; raises
    otherwise."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise MXNetError("multi-query paged attention wants q (B, T, H, D) "
                         "and pages (N, bs, H, D), got %s %s"
                         % (tuple(q.shape), tuple(k_pages.shape)))
    b, tq, h, d = q.shape
    if v_pages.shape != k_pages.shape or k_pages.shape[2:] != (h, d):
        raise MXNetError("multi-query paged attention: pages %s %s do not "
                         "match q %s" % (tuple(k_pages.shape),
                                         tuple(v_pages.shape),
                                         tuple(q.shape)))
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or context_lens.shape != (b, tq):
        raise MXNetError("multi-query paged attention: tables %s / lens %s "
                         "for q %s" % (tuple(block_tables.shape),
                                       tuple(context_lens.shape),
                                       tuple(q.shape)))
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _DTYPE_CODE \
            or v_pages.dtype != k_pages.dtype:
        raise MXNetError("multi-query paged kernel takes float32/bfloat16/"
                         "float16 q and pages, got %s %s %s"
                         % (q.dtype, k_pages.dtype, v_pages.dtype))
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise MXNetError("multi-query paged kernel takes int32 block tables "
                         "and lengths")
    if not 1 <= tq <= 16 * 65535:
        raise MXNetError("multi-query paged kernel takes 1 <= T <= %d, got %d"
                         % (16 * 65535, tq))
    _check_paged_sizes(b, h, d, k_pages.shape[1], block_tables.shape[1],
                       (q.shape, k_pages.shape, block_tables.shape))
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if any(x.device != q.device for x in tensors):
        raise MXNetError("multi-query paged attention: inputs on different "
                         "devices")
    if not all(x.is_contiguous() for x in tensors):
        raise MXNetError("multi-query paged kernel takes contiguous inputs")


def _paged_multi_cuda(q, k_pages, v_pages, block_tables, context_lens,
                      sm_scale):
    _check_paged_multi(q, k_pages, v_pages, block_tables, context_lens)
    k_pages, v_pages = _aligned16(k_pages), _aligned16(v_pages)
    b, tq, h, d = q.shape
    qf = q.float()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.PAGED_DECODE_MULTI.launch(
            qf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            b, tq, h, d, k_pages.shape[0], k_pages.shape[1],
            block_tables.shape[1], sm_scale, _DTYPE_CODE[k_pages.dtype],
            torch.cuda.current_stream().cuda_stream)
    return out.to(q.dtype)


def paged_attention_multi(q, k_pages, v_pages, block_tables, context_lens,
                          sm_scale=None):
    """Multi-query paged attention over a shared KV block pool: q is
    (B, T, H, D) and context_lens (B, T), one length per lane — the
    speculative verify pass scores all T = k+1 window positions in one
    call. CPU tensors take :func:`paged_attention_multi_reference`, CUDA
    tensors the ``paged_decode_multi`` kernel, whose lane t equals
    :func:`paged_attention` at ``context_lens[:, t]`` bit for bit."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    if q.device.type == "cuda":
        return _paged_multi_cuda(q, k_pages, v_pages, block_tables,
                                 context_lens, sm_scale)
    if q.device.type == "cpu":
        return paged_attention_multi_reference(q, k_pages, v_pages,
                                               block_tables, context_lens,
                                               sm_scale)
    raise MXNetError("multi-query paged attention: no implementation on %s"
                     % q.device)


@register(
    "_contrib_PagedAttention",
    arg_names=("query", "key_pages", "value_pages", "block_table",
               "context_len"),
    params={
        "sm_scale": Param.float(-1.0),
    },
)
def _paged_attention_op(octx, attrs, args, auxs):
    """Paged decode attention from ``mx.sym``/``mx.nd``: query (B, heads,
    head_dim), pages (num_blocks, block_size, heads, head_dim), block
    table (B, nb) and context lengths (B,), any numeric dtype (a graph's
    inputs are float32). Tables and lengths are cast to contiguous int32
    on their own device, then :func:`paged_attention` runs: the
    ``paged_decode`` kernel on the card, the plain version on the CPU."""
    q, kp, vp, bt, cl = args
    scale = attrs["sm_scale"]
    out = paged_attention(q, kp, vp, bt.to(torch.int32).contiguous(),
                          cl.to(torch.int32).contiguous(),
                          None if scale <= 0 else scale)
    return [out], []


def _paged_infer_shape(attrs, in_shapes, aux_shapes):
    qs = in_shapes[0]
    if qs is None:
        raise ValueError("PagedAttention: query shape required")
    return in_shapes, [tuple(qs)], []


get_op("_contrib_PagedAttention")._infer_shape = _paged_infer_shape
