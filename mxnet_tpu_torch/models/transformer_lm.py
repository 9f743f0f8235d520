"""Decoder-only Transformer language model (counterpart of
``mxnet_tpu/models/transformer_lm.py``): pre-norm residual blocks around
the fused ``_contrib_MultiHeadAttention`` (causal flash attention, whose
forward and backward are the port's hand-written kernels on the card)
and a FullyConnected FFN, with a learned position table. The graph, its
parameter names and their initializers are the JAX package's, so its
JSON is the same byte for byte. ``get_decode_symbol`` is the one-token
decode graph over the same parameters (``_contrib_CachedMultiHeadAttention``
with per-layer KV caches as aux states), stepped by ``decode_step``; its
JSON too is the JAX package's byte for byte.
"""
from .. import symbol as sym
from ..initializer import Normal, One, Zero

__all__ = ["get_symbol", "get_decode_symbol", "decode_step", "block",
           "SERVING_DRAFT_PRESETS"]

#: Tiny zoo shapes for speculative-decoding DRAFT models
#: (``ServingConfig.draft`` / ``MXNET_SERVING_DRAFT``). vocab_size and
#: max_len always follow the target (``serving.model.draft_config``): the
#: draft proposes from the same vocabulary at the same absolute positions.
SERVING_DRAFT_PRESETS = {
    "tiny": dict(num_layers=1, model_dim=64, num_heads=2, ffn_dim=128),
    "small": dict(num_layers=2, model_dim=128, num_heads=2, ffn_dim=256),
}


def _layer_norm(x, model_dim, name):
    # composed from reference-era primitives (no LayerNorm op in v0.10)
    mean = sym.mean(x, axis=-1, keepdims=True)
    var = sym.mean(sym.square(sym.broadcast_minus(x, mean)), axis=-1, keepdims=True)
    xhat = sym.broadcast_div(sym.broadcast_minus(x, mean), sym.sqrt(var + 1e-5))
    g = sym.Variable(name + "_gamma", shape=(1, 1, model_dim), init=One())
    b = sym.Variable(name + "_beta", shape=(1, 1, model_dim), init=Zero())
    return sym.broadcast_add(sym.broadcast_mul(xhat, g), b)


def block(x, num_heads, model_dim, ffn_dim, seq_len, name, attn_fn=None):
    """Pre-norm residual block. ``attn_fn(h, w_in, w_out, name)`` builds the
    attention sub-graph (default: the full causal block for training)."""
    h = _layer_norm(x, model_dim, name + "_ln1")
    w_in = sym.Variable(name + "_attn_in_weight")
    w_out = sym.Variable(name + "_attn_out_weight")
    if attn_fn is None:
        attn = sym.contrib.MultiHeadAttention(
            h, w_in, w_out, num_heads=num_heads, causal=True, name=name + "_attn")
    else:
        attn = attn_fn(h, w_in, w_out, name)
    x = x + attn
    h = _layer_norm(x, model_dim, name + "_ln2")
    f = sym.FullyConnected(sym.Reshape(h, shape=(-1, model_dim)),
                           num_hidden=ffn_dim, name=name + "_ffn1")
    f = sym.Activation(f, act_type="relu", name=name + "_relu")
    f = sym.FullyConnected(f, num_hidden=model_dim, name=name + "_ffn2")
    f = sym.Reshape(f, shape=(-1, seq_len, model_dim))
    return x + f


def get_symbol(vocab_size=32000, num_layers=4, model_dim=256, num_heads=4,
               ffn_dim=1024, seq_len=128, **kwargs):
    data = sym.Variable("data")  # (batch, seq) float token ids
    label = sym.Variable("softmax_label")
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=model_dim,
                      name="embed")
    pos = sym.Variable("pos_embed_weight", shape=(1, seq_len, model_dim),
                       init=Normal(0.02))
    x = sym.broadcast_add(x, pos)
    for i in range(num_layers):
        x = block(x, num_heads, model_dim, ffn_dim, seq_len, "layer%d" % i)
    x = _layer_norm(x, model_dim, "final_ln")
    logits = sym.FullyConnected(sym.Reshape(x, shape=(-1, model_dim)),
                                num_hidden=vocab_size, name="lm_head")
    return sym.SoftmaxOutput(logits, label=sym.Reshape(label, shape=(-1,)),
                             name="softmax")


def get_decode_symbol(vocab_size=32000, num_layers=4, model_dim=256,
                      num_heads=4, ffn_dim=1024, seq_len=128, **kwargs):
    """One-token autoregressive decode graph sharing the training graph's
    parameter names, with per-layer KV caches as aux states
    (``_contrib_CachedMultiHeadAttention``): bind once at (batch, 1), load
    the trained checkpoint, and step.

    data: (batch, 1) token ids; position: (1,) step index, which MUST stay
    below ``seq_len``: in the graph an out-of-range position DROPS the
    cache write (both caches pass through unchanged) and poisons the op's
    output to NaN, so stepping past the cache can never corrupt it and the
    overflow fails loudly at the consumer. ``decode_step`` also raises on
    the host before the step runs. Step through ``decode_step`` (or call
    ``forward(is_train=True)``: only a training forward writes the caches
    back).
    """
    data = sym.Variable("data")
    position = sym.Variable("position", shape=(1,))
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=model_dim,
                      name="embed")
    pos_tab = sym.Reshape(
        sym.Variable("pos_embed_weight", shape=(1, seq_len, model_dim),
                     init=Normal(0.02)),
        shape=(seq_len, model_dim))
    pos_row = sym.take(pos_tab, position, axis=0)  # (1, model)
    x = sym.broadcast_add(x, sym.Reshape(pos_row, shape=(1, 1, model_dim)))

    def cached_attn(h, w_in, w_out, name):
        return sym.contrib.CachedMultiHeadAttention(
            h, w_in, w_out, position, num_heads=num_heads, max_len=seq_len,
            name=name + "_cached")

    for i in range(num_layers):
        x = block(x, num_heads, model_dim, ffn_dim, 1, "layer%d" % i,
                  attn_fn=cached_attn)
    x = _layer_norm(x, model_dim, "final_ln")
    logits = sym.FullyConnected(sym.Reshape(x, shape=(-1, model_dim)),
                                num_hidden=vocab_size, name="lm_head")
    return sym.softmax(logits, axis=-1)


def decode_step(executor, tokens, position, max_len):
    """Advance the cached decoder one step and return next-token
    probabilities (numpy, (batch, vocab)).

    Keeps the two contract points a raw executor user can get wrong: the
    host-side ``max_len`` guard (in the graph an overflow is a dropped
    write and a NaN output, never a corrupted cache) and the training
    forward, the one that writes the KV caches back."""
    import numpy as _np

    if position >= max_len:
        raise ValueError(
            "decode position %d >= max_len %d: the KV cache is full — rebind "
            "with a larger seq_len" % (position, max_len))
    executor.arg_dict["data"][:] = _np.asarray(tokens, _np.float32).reshape(-1, 1)
    executor.arg_dict["position"][:] = _np.array([position], _np.float32)
    executor.forward(is_train=True)  # aux write-back persists the caches
    return executor.outputs[0].asnumpy()
