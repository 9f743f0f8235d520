"""LSTM language model of the port (counterpart of
``mxnet_tpu/models/lstm_lm.py``; reference: example/rnn/lstm_bucketing.py
and cudnn_lstm_bucketing.py, the PTB LSTM baseline).

``get_symbol`` returns the ``sym_gen(seq_len)`` a ``BucketingModule``
takes: Embedding, two stacked LSTM layers (the fused ``RNN`` op, or
``LSTMCell``s written out step by step), a per-step FullyConnected over
the vocabulary and SoftmaxOutput over the flattened time steps.
"""
from .. import rnn
from .. import symbol as sym


def get_symbol(num_embed=200, num_hidden=200, num_layers=2, vocab_size=10000,
               fused=True, dropout=0.0):
    """Return sym_gen(seq_len) for BucketingModule."""

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data=data, input_dim=vocab_size,
                              output_dim=num_embed, name="embed")
        if fused:
            cell = rnn.FusedRNNCell(num_hidden, num_layers=num_layers, mode="lstm",
                                    dropout=dropout, prefix="lstm_")
            outputs, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                                     merge_outputs=True)
        else:
            stack = rnn.SequentialRNNCell()
            for i in range(num_layers):
                stack.add(rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm_l%d_" % i))
                if dropout and i < num_layers - 1:
                    stack.add(rnn.DropoutCell(dropout, prefix="lstm_d%d_" % i))
            outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        # (N, T, H) -> (N*T, H)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(data=pred, num_hidden=vocab_size, name="pred")
        label_flat = sym.Reshape(label, shape=(-1,))
        out = sym.SoftmaxOutput(data=pred, label=label_flat, name="softmax")
        return out, ("data",), ("softmax_label",)

    return sym_gen
