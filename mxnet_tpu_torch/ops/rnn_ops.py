"""The fused multi-layer ``RNN`` op of the port (counterpart of
``mxnet_tpu/ops/rnn_ops.py``).

The JAX package computes the recurrence with ``jax.lax.scan``; the port
runs the same time step, in the same order of operations, as torch ops in
a Python loop over T, and the gradient comes from ``torch.autograd`` over
that loop. On the fused training path the whole loop is part of the step
that one CUDA graph captures per bucket. It is not cuDNN's RNN: that one
handles the biases and the gates in its own order and would need a parity
proof of its own.

Parameter packing (the JAX package's contract, which
``rnn.FusedRNNCell`` and the ``FusedRNN`` initializer share): for layer l
in 0..L-1, for direction d (forward, then backward)
``i2h_weight (G*H, I_l), h2h_weight (G*H, H), i2h_bias (G*H,),
h2h_bias (G*H,)``, flattened in that order and concatenated. Gate order:
LSTM ``[i, f, c, o]``, GRU ``[r, z, n]``.

Modes ``lstm``, ``gru``, ``rnn_tanh`` and ``rnn_relu``; any
``num_layers``; ``bidirectional``; ``state_outputs``. Dropout between
layers (``p > 0``, training only) multiplies each layer's output but the
last by a mask from :func:`.sample.dropout_mask`, drawn from the graph's
generator, as the JAX package does; inside a bucket's CUDA graph each
replay draws a fresh mask.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import sample
from .registry import Param, get_op, register

__all__ = ["rnn_param_size"]


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Length of the packed parameter vector."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * d
        total += d * (g * state_size * (isz + state_size) + 2 * g * state_size)
    return total


def _unpack_params(params, num_layers, input_size, state_size, bidirectional, mode):
    """Views of the packed vector: per layer, per direction, the tuple
    ``(w_i2h, w_h2h, b_i2h, b_h2h)``."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    gh = g * state_size
    off = 0
    layers = []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * d
        dirs = []
        for _ in range(d):
            w_i2h = params[off:off + gh * isz].reshape(gh, isz)
            off += gh * isz
            w_h2h = params[off:off + gh * state_size].reshape(gh, state_size)
            off += gh * state_size
            b_i2h = params[off:off + gh]
            off += gh
            b_h2h = params[off:off + gh]
            off += gh
            dirs.append((w_i2h, w_h2h, b_i2h, b_h2h))
        layers.append(dirs)
    return layers


def _cell_step(mode):
    """``step(carry, xw_t, w_h2h, b_h2h) -> (carry, h)`` for one time step,
    in the JAX package's order of operations."""
    if mode == "lstm":
        def step(carry, xw, w_h2h, b_h2h):
            h, c = carry
            gates = xw + h @ w_h2h.T + b_h2h
            i, f, g_, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g_ = torch.tanh(g_)
            c2 = f * c + i * g_
            h2 = o * torch.tanh(c2)
            return (h2, c2), h2
    elif mode == "gru":
        def step(carry, xw, w_h2h, b_h2h):
            (h,) = carry
            hw = h @ w_h2h.T + b_h2h
            xr, xz, xn = xw.chunk(3, dim=-1)
            hr, hz, hn = hw.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h2 = (1 - z) * n + z * h
            return (h2,), h2
    else:
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(carry, xw, w_h2h, b_h2h):
            (h,) = carry
            h2 = act(xw + h @ w_h2h.T + b_h2h)
            return (h2,), h2
    return step


def _run_layer(x, wp, init, mode, reverse=False):
    """x: (T, N, I); returns (out (T, N, H), final carry)."""
    w_i2h, w_h2h, b_i2h, b_h2h = wp
    # the input projection of every step at once, outside the loop
    xw = x @ w_i2h.T + b_i2h
    step = _cell_step(mode)
    T = x.shape[0]
    outs = [None] * T
    carry = init
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry, outs[t] = step(carry, xw[t], w_h2h, b_h2h)
    return torch.stack(outs), carry


def _rnn_outputs(attrs):
    if not attrs.get("state_outputs"):
        return ["output"]
    if attrs.get("mode") == "lstm":
        return ["output", "state_output", "statecell_output"]
    return ["output", "state_output"]


@register(
    "RNN",
    arg_names=lambda attrs: ["data", "parameters", "state"]
    + (["state_cell"] if attrs.get("mode") == "lstm" else []),
    params={
        "state_size": Param.int(),
        "num_layers": Param.int(),
        "bidirectional": Param.bool(False),
        "mode": Param.str(),
        "p": Param.float(0.0),
        "state_outputs": Param.bool(False),
        "pkeep_": Param.float(1.0),
        "lstm_q_": Param.bool(False),
    },
    stochastic=lambda attrs: attrs["p"] > 0 and attrs["num_layers"] > 1,
    num_outputs=lambda attrs: len(_rnn_outputs(attrs)),
    output_names=_rnn_outputs,
)
def _rnn(octx, attrs, args, auxs):
    mode = attrs["mode"]
    H = attrs["state_size"]
    L = attrs["num_layers"]
    bidir = attrs["bidirectional"]
    d = 2 if bidir else 1
    dropout = attrs["p"] > 0 and octx.is_train and L > 1
    if dropout and octx.rng is None:
        raise MXNetError("RNN: dropout between layers (p=%g) draws masks and "
                         "was given no generator" % attrs["p"])
    x, params, h0 = args[0], args[1], args[2]
    c0 = args[3] if mode == "lstm" else None
    T, N, I = x.shape
    inp = x
    h_finals, c_finals = [], []
    for li, dirs in enumerate(_unpack_params(params, L, I, H, bidir, mode)):
        outs = []
        for di, wp in enumerate(dirs):
            sidx = li * d + di
            # begin_state may be batch 1 (the 0-dim wildcard of _zeros):
            # broadcast it to the real batch
            h_init = h0[sidx].expand(N, H).to(x.dtype)
            if mode == "lstm":
                init = (h_init, c0[sidx].expand(N, H).to(x.dtype))
            else:
                init = (h_init,)
            out, carry = _run_layer(inp, wp, init, mode, reverse=(di == 1))
            outs.append(out)
            h_finals.append(carry[0])
            if mode == "lstm":
                c_finals.append(carry[1])
        inp = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if dropout and li < L - 1:
            inp = inp * sample.dropout_mask(octx.rng, inp.shape,
                                            1.0 - attrs["p"], inp.dtype,
                                            inp.device)
    outputs = [inp]
    if attrs["state_outputs"]:
        outputs.append(torch.stack(h_finals))
        if mode == "lstm":
            outputs.append(torch.stack(c_finals))
    return outputs, []


def _rnn_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("RNN: data shape required")
    T, N, I = data
    H, L = attrs["state_size"], attrs["num_layers"]
    d = 2 if attrs["bidirectional"] else 1
    psize = rnn_param_size(L, I, H, attrs["bidirectional"], attrs["mode"])
    shapes = [tuple(data), (psize,), (L * d, N, H)]
    if attrs["mode"] == "lstm":
        shapes.append((L * d, N, H))
    outs = [(T, N, H * d)]
    if attrs["state_outputs"]:
        outs.append((L * d, N, H))
        if attrs["mode"] == "lstm":
            outs.append((L * d, N, H))
    return shapes, outs, []


get_op("RNN")._infer_shape = _rnn_infer_shape
