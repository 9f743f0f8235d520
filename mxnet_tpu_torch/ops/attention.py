"""Attention ops of the port: flash (prefill) attention and paged decode.

The PyTorch counterpart of the forward and paged-decode parts of
``mxnet_tpu/ops/attention.py``, in the same layouts: (B, H, S, D) for
flash attention and (N, bs, H, D) pool pages for paged decode.

Each public function dispatches on ``q.device.type``:

* ``cpu``  — the plain PyTorch version (:func:`_flash_forward_plain`, the
  twin of the JAX package's ``_scan_forward``; :func:`paged_attention_reference`,
  the twin of its XLA reference);
* ``cuda`` — the hand-written Hopper kernel (``csrc/flash_fwd.cu`` for
  ``_pallas_forward``, ``csrc/paged_decode.cu`` for ``_paged_pallas``),
  or :class:`MXNetError` for a shape or dtype the kernel does not take.

Nothing falls back: a CUDA tensor reaches its kernel or raises.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["attention_reference", "flash_attention_forward",
           "flash_attention", "paged_attention_reference", "paged_attention"]

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


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Memory-efficient attention over (B, H, S, D), output in q's dtype
    (as the JAX package's ``_forward_impl`` casts it)."""
    out, _ = flash_attention_forward(q, k, v, causal, sm_scale)
    return out.to(q.dtype)


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
