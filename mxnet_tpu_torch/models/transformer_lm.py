"""Decoder-only Transformer language model (counterpart of
``mxnet_tpu/models/transformer_lm.py``): pre-norm residual blocks around
the fused ``_contrib_MultiHeadAttention`` (causal flash attention, whose
forward and backward are the port's hand-written kernels on the card)
and a FullyConnected FFN, with a learned position table. The graph, its
parameter names and their initializers are the JAX package's, so its
JSON is the same byte for byte. ``get_decode_symbol`` needs
``_contrib_CachedMultiHeadAttention`` and waits for a later slice.
"""
from .. import symbol as sym
from ..initializer import Normal, One, Zero

__all__ = ["get_symbol", "block", "SERVING_DRAFT_PRESETS"]

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
