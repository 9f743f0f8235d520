"""Model-parallel placement for ``group2ctx`` (counterpart of
``mxnet_tpu/placed.py``; reference: ``AssignContext`` and
``nnvm::pass::PlaceDevice`` inserting ``_CrossDeviceCopy`` nodes,
src/executor/graph_executor.cc:245-334).

The symbol's topological order is cut into maximal *segments* of nodes
on one context (a node takes its ``ctx_group``'s context, a node without
one or of an unmapped group the default context; a variable lives where
its first consumer computes). Each segment runs the graph's ops on its
context's device; a value that crosses a segment boundary into another
context moves by an explicit copy (the ``_CrossDeviceCopy`` analog),
counted in :attr:`PlacedGraph.transfer_count`.

Backward runs the segments in reverse order. As in the JAX package, a
segment keeps no residuals across its boundary: its backward recomputes
its forward from the inputs it received, under autograd, and hands the
cotangents of its inputs back across the same boundaries. A stochastic
op must draw the same mask in the recompute as in the forward: the
segment's generator state (:mod:`.random`) is saved before its forward
and restored for the recompute, then put back.

The executor builds a ``PlacedGraph`` when the group contexts name at
least two distinct torch devices (the card and the host); the segments
follow the contexts, so groups on ``cpu(1)`` and ``cpu(2)`` are two
segments with real copies between them when a ``PlacedGraph`` is built
over them directly.
"""
from __future__ import annotations

import torch

from . import random as _random
from .ops.registry import OpContext, get_op
from .symbol import _topo_order

__all__ = ["PlacedGraph"]


class _Segment:
    __slots__ = ("ctx", "device", "nodes", "in_keys", "out_keys", "stochastic")

    def __init__(self, ctx):
        self.ctx = ctx
        self.device = torch.device(ctx)
        self.nodes = []
        self.in_keys = []       # value keys consumed from outside
        self.out_keys = []      # value keys produced here and needed later
        self.stochastic = False


class PlacedGraph:
    """Per-context segmented execution of a bound symbol.

    Value keys: ``(id(node), k)`` for every node or variable output."""

    def __init__(self, symbol, group2ctx, default_ctx, arg_names, aux_names,
                 cast_compute):
        self._cast_compute = cast_compute  # fn(name, tensor) -> tensor
        self.transfer_count = 0  # cross-context copies (observability)

        order = _topo_order(symbol._entries)
        _, aux_vars = symbol._arg_aux_split()
        self._arg_index = {}
        self._aux_index = {}
        for node in order:
            if node.is_variable:
                if id(node) in aux_vars:
                    self._aux_index[id(node)] = len(self._aux_index)
                else:
                    self._arg_index[id(node)] = len(self._arg_index)
        self._arg_names = arg_names
        self._aux_names = aux_names

        def node_ctx(node):
            g = node.list_attr().get("ctx_group")
            if g and group2ctx and g in group2ctx:
                return group2ctx[g]
            return default_ctx

        compute_nodes = [n for n in order if not n.is_variable]
        node_ctxs = {id(n): node_ctx(n) for n in compute_nodes}

        # variables live where their first consumer computes
        self.var_ctx = {}
        for node in compute_nodes:
            for inp, _ in node.inputs:
                if inp.is_variable and id(inp) not in self.var_ctx:
                    self.var_ctx[id(inp)] = node_ctxs[id(node)]
        for node in order:
            if node.is_variable:
                self.var_ctx.setdefault(id(node), default_ctx)
        self.arg_ctx = {self._arg_names[i]: self.var_ctx[nid]
                        for nid, i in self._arg_index.items()}
        self.aux_ctx = {self._aux_names[j]: self.var_ctx[nid]
                        for nid, j in self._aux_index.items()}

        # maximal same-context segments in topological order
        self.segments = []
        cur = None
        for node in compute_nodes:
            ctx = node_ctxs[id(node)]
            if cur is None or cur.ctx != ctx:
                cur = _Segment(ctx)
                self.segments.append(cur)
            cur.nodes.append(node)
            cur.stochastic |= get_op(node.op).stochastic(node.attrs)

        produced_in = {}
        for s, seg in enumerate(self.segments):
            for node in seg.nodes:
                produced_in[id(node)] = s
        # the context each node's values are produced on
        self._node_ctx = {nid: self.segments[s].ctx
                          for nid, s in produced_in.items()}

        self._out_entries = [(id(n), k) for n, k in symbol._entries]
        needed = {}   # key -> consumer segments (or "out")
        for s, seg in enumerate(self.segments):
            for node in seg.nodes:
                for inp, k in node.inputs:
                    if produced_in.get(id(inp)) != s:
                        needed.setdefault((id(inp), k), set()).add(s)
        for key in self._out_entries:
            if produced_in.get(key[0]) is not None:
                needed.setdefault(key, set()).add("out")
        for s, seg in enumerate(self.segments):
            ids = {id(n) for n in seg.nodes}
            seen = set()
            for node in seg.nodes:
                for inp, k in node.inputs:
                    key = (id(inp), k)
                    if id(inp) not in ids and key not in seen:
                        seen.add(key)
                        seg.in_keys.append(key)
            seg.out_keys = [key for key, users in needed.items()
                            if key[0] in ids and users - {s}]
        self._saved = None

    # ------------------------------------------------------------------
    def _ctx_of(self, key):
        ctx = self._node_ctx.get(key[0])
        return self.var_ctx[key[0]] if ctx is None else ctx

    def _transfer(self, value, src_ctx, dst_ctx):
        """``value`` on ``dst_ctx``: itself within one context, else an
        explicit copy (counted)."""
        if src_ctx == dst_ctx:
            return value
        self.transfer_count += 1
        return value.to(torch.device(dst_ctx), copy=True)

    def _seed_env(self, args, auxs):
        env = {}
        for nid, i in self._arg_index.items():
            env[(nid, 0)] = self._cast_compute(self._arg_names[i], args[i])
        for nid, j in self._aux_index.items():
            env[(nid, 0)] = auxs[j]
        return env

    def _run(self, seg, in_vals, is_train):
        """The segment's ops over its inputs: (boundary outputs, {aux id:
        new value})."""
        vals = dict(zip(seg.in_keys, in_vals))
        octx = OpContext(is_train=is_train, device=seg.device,
                         rng=(_random.generator(seg.device)
                              if seg.stochastic else None))
        new_aux = {}
        for node in seg.nodes:
            op = get_op(node.op)
            n_args = len(op.arg_names(node.attrs))
            ins = [vals[(id(inp), k)] for inp, k in node.inputs]
            outs, updated = op.forward(octx, node.attrs, ins[:n_args],
                                       ins[n_args:])
            for k, o in enumerate(outs):
                vals[(id(node), k)] = o
            for (inp, _), new in zip(node.inputs[n_args:], updated):
                if id(inp) in self._aux_index:
                    new_aux[id(inp)] = new
        return [vals[k] for k in seg.out_keys], new_aux

    def _new_auxs(self, auxs, new_aux_env):
        out = []
        for nid, j in sorted(self._aux_index.items(), key=lambda kv: kv[1]):
            new = new_aux_env.get(nid)
            out.append(auxs[j] if new is None
                       else new.detach().to(auxs[j].device, auxs[j].dtype))
        return out

    def forward(self, args, auxs, is_train):
        """Run the segments in order: ``(outputs, new auxs)``. With
        ``is_train`` each segment's inputs and generator state are kept
        for :meth:`backward`."""
        env = self._seed_env(args, auxs)
        new_aux_env = {}
        saved = []
        with torch.no_grad():
            for seg in self.segments:
                ins = [self._transfer(env[k], self._ctx_of(k), seg.ctx)
                       for k in seg.in_keys]
                state = (_random.generator(seg.device).get_state()
                         if is_train and seg.stochastic else None)
                outs, new_aux = self._run(seg, ins, is_train)
                env.update(zip(seg.out_keys, outs))
                new_aux_env.update(new_aux)
                saved.append((ins, state))
        self._saved = (saved, env) if is_train else None
        outputs = [env[k] for k in self._out_entries]
        return outputs, self._new_auxs(auxs, new_aux_env)

    def backward(self, out_grads):
        """Cotangents of every argument, in argument order (None where the
        graph does not reach it), from the head gradients ``out_grads`` of
        the last training :meth:`forward`. Each segment recomputes its
        forward, last segment first."""
        saved, env = self._saved
        self._saved = None
        cts = {}

        def add_ct(key, g, ctx):
            cur = cts.get(key)
            if cur is None:
                cts[key] = (g, ctx)
            else:
                cts[key] = (cur[0] + self._transfer(g, ctx, cur[1]), cur[1])

        for key, og in zip(self._out_entries, out_grads):
            add_ct(key, og, self._ctx_of(key))
        for si in range(len(self.segments) - 1, -1, -1):
            seg = self.segments[si]
            ins, state = saved[si]
            out_cts = []
            for key in seg.out_keys:
                g = cts.get(key)
                out_cts.append(
                    torch.zeros_like(env[key]) if g is None
                    else self._transfer(g[0], g[1], seg.ctx))
            leaves = [x.detach().requires_grad_(x.is_floating_point())
                      for x in ins]
            gen = _random.generator(seg.device) if state is not None else None
            if gen is not None:
                after = gen.get_state()
                gen.set_state(state)
            try:
                with torch.enable_grad():
                    outs, _ = self._run(seg, leaves, True)
            finally:
                if gen is not None:
                    gen.set_state(after)
            pairs = [(o, g) for o, g in zip(outs, out_cts) if o.requires_grad]
            wrt = [(k, x) for k, x in zip(seg.in_keys, leaves) if x.requires_grad]
            if not pairs or not wrt:
                continue
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        [x for _, x in wrt],
                                        [g for _, g in pairs],
                                        allow_unused=True)
            for (key, _), g in zip(wrt, grads):
                if g is not None:
                    add_ct(key, g, seg.ctx)
        out = [None] * len(self._arg_index)
        for nid, i in self._arg_index.items():
            g = cts.get((nid, 0))
            if g is not None:
                out[i] = g[0]
        return out
