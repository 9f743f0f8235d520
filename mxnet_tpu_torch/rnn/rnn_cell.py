"""RNN cells of the port (counterpart of ``mxnet_tpu/rnn/rnn_cell.py``;
reference: python/mxnet/rnn/rnn_cell.py).

A cell builds symbols: ``unroll`` writes the recurrence out step by step
into the graph (``RNNCell``, ``LSTMCell``, ``GRUCell`` and a
``SequentialRNNCell`` of them), or feeds the fused ``RNN`` op
(:mod:`..ops.rnn_ops`) with ``FusedRNNCell``, whose ``unfuse`` gives the
equivalent stack of written-out cells over the same packed parameters.
The graphs, names and attrs are the JAX package's, so a cell's symbol
JSON is the same in both packages.

``DropoutCell`` puts a ``Dropout`` node after each step. The modifier
cells wrap a base cell (``ModifierCell``): ``ZoneoutCell`` keeps each
output and state unit from the step before with probability
``zoneout_outputs``/``zoneout_states``, its masks ``Dropout`` nodes over
ones (drawn through :func:`..ops.sample.dropout_mask`, as every dropout
mask is, so a captured CUDA graph draws fresh ones on each replay);
``ResidualCell`` adds the input to the output. ``BidirectionalCell`` runs
one cell forward and one backward in time and concatenates their
outputs; ``FusedRNNCell.unfuse`` gives one per layer of a bidirectional
fused cell.
"""
from __future__ import annotations

import numpy as np

from .. import ndarray
from .. import symbol
from ..base import MXNetError, string_types

__all__ = [
    "RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
    "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
    "BidirectionalCell", "ModifierCell",
]


class RNNParams:
    """The Variables of a cell, made once per name (``prefix`` + name)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


# thread-confined: a cell is built and unrolled by one thread; the feed
# thread reaches it only through the analyzer's method-name matches
class BaseRNNCell:
    """Base class of the cells."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """The initial states: one ``func`` node per state (``_zeros`` of
        ``state_info``'s shape, with 0 for the batch)."""
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly. Call the modifier "
                             "cell instead.")
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is not None:
                kwargs.update(info)
            states.append(func(name="%sbegin_state_%d" % (self._prefix,
                                                          self._init_counter),
                               **kwargs))
        return states

    def unpack_weights(self, args):
        """Split each fused ``i2h``/``h2h`` weight and bias into one array
        per gate (``prefix + group + gate + _weight``)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            w, b = weight.asnumpy(), bias.asnumpy()
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = ndarray.array(w[j * h:(j + 1) * h], ctx=weight.context)
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = ndarray.array(b[j * h:(j + 1) * h], ctx=bias.context)
        return args

    def pack_weights(self, args):
        """The inverse of :meth:`unpack_weights`."""
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight, bias = [], []
            ctx = None
            for gate in self._gate_names:
                w = args.pop("%s%s%s_weight" % (self._prefix, group_name, gate))
                ctx = w.context
                weight.append(w.asnumpy())
                bias.append(args.pop("%s%s%s_bias" % (self._prefix, group_name,
                                                       gate)).asnumpy())
            args["%s%s_weight" % (self._prefix, group_name)] = ndarray.array(
                np.concatenate(weight), ctx=ctx)
            args["%s%s_bias" % (self._prefix, group_name)] = ndarray.array(
                np.concatenate(bias), ctx=ctx)
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Write ``length`` steps of the recurrence into the graph."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False, input_prefix)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout, merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, string_types):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _normalize_sequence(length, inputs, layout, merge, input_prefix=""):
    """``inputs`` as a list of ``length`` per-step symbols (``merge``
    False: a Symbol is split along T) or one Symbol (``merge`` True: a list
    is joined along T)."""
    if inputs is None and merge:
        raise MXNetError("unroll needs inputs to merge")
    if inputs is None:
        inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                  for i in range(length)]
    axis = layout.find("T")
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            if len(inputs.list_outputs()) != 1:
                raise MXNetError(
                    "unroll doesn't allow grouped symbol as input. Please "
                    "convert to list first or let unroll handle slicing")
            inputs = list(symbol.SliceChannel(inputs, axis=axis, num_outputs=length,
                                              squeeze_axis=1))
    else:
        if length is not None and len(inputs) != length:
            raise MXNetError("unroll: %d inputs for length %d"
                             % (len(inputs), length))
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """Elman RNN cell: ``act(i2h(x) + h2h(h))``."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden, name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden, name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation, name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order i, f, c, o; the i2h bias starts at
    ``forget_bias`` in the forget gate (``LSTMBias``)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None, forget_bias=1.0):
        from .. import initializer as init_mod

        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init=init_mod.LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 4, name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden * 4, name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4, name="%sslice" % name)
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid", name="%si" % name)
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh", name="%sc" % name)
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid", name="%so" % name)
        next_c = symbol._plus(forget_gate * states[1], in_gate * in_transform,
                              name="%sstate" % name)
        next_h = symbol._mul(out_gate, symbol.Activation(next_c, act_type="tanh"),
                             name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order r, z, n."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 3, name="%s_i2h" % name)
        h2h = symbol.FullyConnected(prev_state_h, self._hW, self._hB,
                                    num_hidden=self._num_hidden * 3, name="%s_h2h" % name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(i2h, num_outputs=3,
                                                name="%s_i2h_slice" % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(h2h, num_outputs=3,
                                                name="%s_h2h_slice" % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                       name="%s_r_act" % name)
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                        name="%s_z_act" % name)
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h, act_type="tanh",
                                       name="%s_h_act" % name)
        next_h = symbol._plus((1.0 - update_gate) * next_h_tmp,
                              update_gate * prev_state_h, name="%sout" % name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Several layers of one recurrence as one ``RNN`` op over a packed
    parameter vector (``prefix + "parameters"``, initialized by
    ``FusedRNN``)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm", bidirectional=False,
                 dropout=0.0, get_next_state=False, forget_bias=1.0,
                 prefix=None, params=None):
        from .. import initializer as init_mod

        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        initializer = init_mod.FusedRNN(None, num_hidden, num_layers, mode,
                                        bidirectional, forget_bias)
        self._parameter = self.params.get("parameters", init=initializer)

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"], "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def __call__(self, inputs, states):
        raise NotImplementedError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """One ``RNN`` node over the whole sequence (time-major inside: an
        NTC input is swapped to TNC and the output back)."""
        self.reset()
        axis = layout.find("T")
        inputs, _ = _normalize_sequence(length, inputs, layout, True, input_prefix)
        if axis == 1:
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        elif axis != 0:
            raise MXNetError("Unsupported layout %s" % layout)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        if self._mode == "lstm":
            states = {"state": states[0], "state_cell": states[1]}
        else:
            states = {"state": states[0]}
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden, num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state, mode=self._mode,
                         name=self._prefix + "rnn", **states)
        if not self._get_next_state:
            outputs, attr_states = rnn, []
        elif self._mode == "lstm":
            outputs, attr_states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, attr_states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(outputs, axis=axis, num_outputs=length,
                                               squeeze_axis=1))
        return outputs, attr_states

    def unfuse(self):
        """The same recurrence as a ``SequentialRNNCell`` of written-out
        cells (``prefix + "l%d_"`` per layer)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda cell_prefix: RNNCell(self._num_hidden, activation="relu",
                                                    prefix=cell_prefix),
            "rnn_tanh": lambda cell_prefix: RNNCell(self._num_hidden, activation="tanh",
                                                    prefix=cell_prefix),
            "lstm": lambda cell_prefix: LSTMCell(self._num_hidden, prefix=cell_prefix),
            "gru": lambda cell_prefix: GRUCell(self._num_hidden, prefix=cell_prefix),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_%s_%d" % (self._prefix, self._mode, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Cells stacked: each one's output is the next one's input."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            if not cell._own_params:
                raise MXNetError("Either specify params for SequentialRNNCell "
                                 "or child cells, not both.")
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Each cell unrolled over the previous one's outputs; only the last
        cell merges its outputs as asked."""
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, input_prefix=input_prefix,
                begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on the output (reference: rnn_cell.py DropoutCell): a
    ``Dropout`` node per step, no state."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


# thread-confined: a cell is built and unrolled by one thread; the feed
# thread reaches it only through the analyzer's method-name matches
class ModifierCell(BaseRNNCell):
    """A cell wrapped around a base cell, whose parameters and states it
    takes over (the base cell is marked modified and may not be called
    directly)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=symbol.zeros, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(init_sym, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al.): each output and state unit keeps its
    value from the step before with probability ``zoneout_outputs`` /
    ``zoneout_states`` in training."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, FusedRNNCell):
            raise MXNetError("FusedRNNCell doesn't support zoneout. Please "
                             "unfuse first.")
        if isinstance(base_cell, BidirectionalCell):
            raise MXNetError("BidirectionalCell doesn't support zoneout since "
                             "it doesn't support step. Please add ZoneoutCell "
                             "to the cells underneath instead.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = (self.prev_output if self.prev_output is not None
                       else symbol.zeros((0, 0)))
        output = (symbol.where(mask(p_outputs, next_output), next_output,
                               prev_output)
                  if p_outputs != 0.0 else next_output)
        states = ([symbol.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0.0 else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol._plus(output, inputs,  # noqa: F821 - a registered op
                              name="%s_plus_residual" % (output.name or "res"))
        return output, states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = (isinstance(outputs, symbol.Symbol)
                         if merge_outputs is None else merge_outputs)
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            outputs = symbol._plus(outputs, inputs)  # noqa: F821
        else:
            outputs = [symbol._plus(i, j)  # noqa: F821
                       for i, j in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed, their
    outputs concatenated per step (``output_prefix + "out%d"``; one
    ``output_prefix + "out"`` when merged). It has no single step."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            if not (l_cell._own_params and r_cell._own_params):
                raise MXNetError("Either specify params for BidirectionalCell "
                                 "or child cells, not both.")
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False, input_prefix)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)), begin_state=states[n_l:],
            layout=layout, merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = (isinstance(l_outputs, symbol.Symbol)
                             and isinstance(r_outputs, symbol.Symbol))
            if not merge_outputs:
                if isinstance(l_outputs, symbol.Symbol):
                    l_outputs = list(symbol.SliceChannel(
                        l_outputs, axis=axis, num_outputs=length, squeeze_axis=1))
                if isinstance(r_outputs, symbol.Symbol):
                    r_outputs = list(symbol.SliceChannel(
                        r_outputs, axis=axis, num_outputs=length, squeeze_axis=1))
        if merge_outputs:
            l_outputs = [l_outputs]
            r_outputs = [symbol.reverse(r_outputs, axis=axis)]
        else:
            r_outputs = list(reversed(r_outputs))
        outputs = [
            symbol.Concat(l_o, r_o, dim=1 + merge_outputs,
                          name=("%sout" % self._output_prefix if merge_outputs
                                else "%sout%d" % (self._output_prefix, i)))
            for i, (l_o, r_o) in enumerate(zip(l_outputs, r_outputs))]
        if merge_outputs:
            outputs = outputs[0]
        return outputs, l_states + r_states


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args
