"""Attention ops of the port: flash attention (forward and backward),
paged decode and multi-query paged attention (the speculative verify
pass).

The PyTorch counterpart of ``mxnet_tpu/ops/attention.py`` without the
cached decode op, in the same layouts: (B, H, S, D) for flash attention
and (N, bs, H, D) pool pages for paged attention.

Each public function dispatches on ``q.device.type``:

* ``cpu``  — the plain PyTorch version (:func:`_flash_forward_plain` and
  :func:`_flash_backward_plain`, the twins of the JAX package's
  ``_scan_forward``/``_scan_backward``; :func:`paged_attention_reference`
  and :func:`paged_attention_multi_reference`, the twins of its XLA
  references);
* ``cuda`` — the hand-written Hopper kernel (``csrc/flash_fwd.cu`` for
  ``_pallas_forward``; ``csrc/flash_bwd_dkv.cu`` and
  ``csrc/flash_bwd_dq.cu`` for the two kernels of ``_pallas_backward``;
  ``csrc/paged_decode.cu`` for ``_paged_pallas``;
  ``csrc/paged_decode_multi.cu`` for ``_paged_pallas_multi``), or
  :class:`MXNetError` for a shape or dtype the kernel does not take.

Nothing falls back: a CUDA tensor reaches its kernel or raises.
:func:`flash_attention` is a ``torch.autograd.Function`` whose backward
runs the two backward kernels; the ops ``_contrib_FlashAttention`` and
``_contrib_MultiHeadAttention`` are registered on top of it.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build
from .registry import Param, get_op, register

__all__ = ["attention_reference", "flash_attention_forward",
           "flash_attention_backward", "flash_attention",
           "paged_attention_reference", "paged_attention",
           "paged_attention_multi_reference", "paged_attention_multi"]

_NEG_INF = -1e30

#: dtype codes of the kernels' C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
        raise MXNetError("flash kernel takes float32 or bfloat16 q/k/v of one "
                         "dtype, got %s %s %s" % (q.dtype, k.dtype, v.dtype))
    if d % 8 or d > 128:
        raise MXNetError("flash kernel takes head_dim <= 128, a multiple of "
                         "8, got %d" % d)
    if sq < 1 or k.shape[2] < 1 or not 1 <= b * h <= 65535:
        raise MXNetError("flash kernel: empty or oversized problem %s / %s"
                         % (tuple(q.shape), tuple(k.shape)))
    if not (q.device == k.device == v.device):
        raise MXNetError("flash attention: q/k/v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash kernel takes contiguous q/k/v")


def _flash_forward_cuda(q, k, v, causal, sm_scale):
    _check_flash(q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, k.shape[2], d, sm_scale, int(causal),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    return out, lse


def flash_attention_forward(q, k, v, causal=False, sm_scale=None):
    """Flash-attention forward over (B, H, S, D): returns ``(out, lse)``,
    both float32 — the residuals a backward consumes. CPU tensors take the
    plain version, CUDA tensors the ``flash_fwd`` kernel."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, causal, sm_scale)
    raise MXNetError("flash attention: no implementation on %s" % q.device)


# ----------------------------------------------------------- flash backward
def _flash_backward_plain(q, k, v, out, lse, g, causal, sm_scale,
                          block_k=256):
    """Plain flash backward: P recomputed per KV block from the saved
    ``lse``, dq accumulated across blocks, dk/dv written per block — the
    twin of the JAX ``_scan_backward``. ``delta = rowsum(dout * out)`` in
    float32. Masked scores are pinned to -1e30, so their p is exactly 0;
    the last block is short instead of zero-padded. Returns (dq, dk, dv)
    in the dtypes of q, k and v."""
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
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def _flash_backward_cuda(q, k, v, out, lse, g, causal, sm_scale):
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
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    code = _DTYPE_CODE[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.FLASH_BWD_DKV.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk, d, sm_scale, int(causal), code, stream)
        _build.FLASH_BWD_DQ.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, sk, d, sm_scale, int(causal), code, stream)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(q, k, v, out, lse, g, causal=False,
                             sm_scale=None):
    """Flash-attention backward over (B, H, S, D) from the forward's
    residuals (``out`` and float32 ``lse``) and the output gradient ``g``:
    returns ``(dq, dk, dv)`` in the dtypes of q, k and v. CPU tensors take
    the plain version, CUDA tensors the ``flash_bwd_dkv`` and
    ``flash_bwd_dq`` kernels."""
    sm_scale = _scale(sm_scale, q.shape[-1])
    if q.device.type == "cuda":
        return _flash_backward_cuda(q, k, v, out, lse, g, causal, sm_scale)
    if q.device.type == "cpu":
        return _flash_backward_plain(q, k, v, out, lse, g, causal, sm_scale)
    raise MXNetError("flash attention: no implementation on %s" % q.device)


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
        raise MXNetError("paged kernel takes float32/bfloat16 q and pages, "
                         "got %s %s %s" % (q.dtype, k_pages.dtype,
                                           v_pages.dtype))
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise MXNetError("paged kernel takes int32 block tables and lengths")
    if d % 8 or d > 128 or k_pages.shape[1] > 256 or b < 1:
        raise MXNetError("paged kernel takes head_dim <= 128 (a multiple of "
                         "8), block_size <= 256 and B >= 1; got %s / %s"
                         % (tuple(q.shape), tuple(k_pages.shape)))
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if any(x.device != q.device for x in tensors):
        raise MXNetError("paged attention: inputs on different devices")
    if not all(x.is_contiguous() for x in tensors):
        raise MXNetError("paged kernel takes contiguous inputs")


def _paged_cuda(q, k_pages, v_pages, block_tables, context_lens, sm_scale):
    _check_paged(q, k_pages, v_pages, block_tables, context_lens)
    b, h, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.PAGED_DECODE.launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            b, h, d, k_pages.shape[0], k_pages.shape[1],
            block_tables.shape[1], sm_scale, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], torch.cuda.current_stream().cuda_stream)
    return out


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
#: most query lanes per sequence ``csrc/paged_decode_multi.cu`` takes
MAX_LANES = 16


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
        raise MXNetError("multi-query paged kernel takes float32/bfloat16 q "
                         "and pages, got %s %s %s"
                         % (q.dtype, k_pages.dtype, v_pages.dtype))
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise MXNetError("multi-query paged kernel takes int32 block tables "
                         "and lengths")
    if d % 8 or d > 128 or k_pages.shape[1] > 256 or b < 1 \
            or not 1 <= tq <= MAX_LANES:
        raise MXNetError("multi-query paged kernel takes head_dim <= 128 (a "
                         "multiple of 8), block_size <= 256, B >= 1 and "
                         "1 <= T <= %d; got %s / %s"
                         % (MAX_LANES, tuple(q.shape), tuple(k_pages.shape)))
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if any(x.device != q.device for x in tensors):
        raise MXNetError("multi-query paged attention: inputs on different "
                         "devices")
    if not all(x.is_contiguous() for x in tensors):
        raise MXNetError("multi-query paged kernel takes contiguous inputs")


def _paged_multi_cuda(q, k_pages, v_pages, block_tables, context_lens,
                      sm_scale):
    _check_paged_multi(q, k_pages, v_pages, block_tables, context_lens)
    b, tq, h, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.PAGED_DECODE_MULTI.launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            b, tq, h, d, k_pages.shape[0], k_pages.shape[1],
            block_tables.shape[1], sm_scale, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], torch.cuda.current_stream().cuda_stream)
    return out


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
