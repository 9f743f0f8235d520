"""The fused fit path behind Module (counterpart of
``mxnet_tpu/module/fused_path.py``), on one context.

``Module`` routes ``forward``/``backward``/``update`` here when the
configuration is one program per step (``Module._fused_veto``):
``forward`` stages the batch, ``update`` runs forward, backward and the
optimizer update as one step (:class:`~..parallel.spmd.SPMDTrainer`, a
captured CUDA graph on the card), and ``get_outputs``/``update_metric``
see this step's outputs, computed with the parameters before the update,
as on the classic path.

Coherence: while the path is active its float32 master parameters,
auxiliary states and optimizer slots on the device are the truth
(``device_dirty``); :meth:`FusedFitPath.sync_to_module` writes them back
into the Module's host dicts and its executor group whenever a
classic-path consumer (an eval forward, ``get_params``, a checkpoint)
needs them.

Bucketing: the buckets of a ``BucketingModule`` share one
:class:`_SharedFusedState` (``Module.borrow_optimizer``). Each bucket has
its own trainer, shape-specialized, with its own CUDA graph, and every
graph is captured on the shared state's tensors. Those tensors are
allocated once and only ever written in place (``set_params``, optimizer
states from a file, a rebind, a resume all ``copy_`` into them), so every
bucket's graph stays valid and a bucket switch moves nothing through the
host. The update count is the one optimizer's that the buckets share.

Optimizer states travel in the JAX package's ``.states`` format
(:meth:`FusedFitPath.get_states_bytes`/``set_states_bytes``): a pickled
``{index: numpy state}`` keyed by ``enumerate(param_names)``, what the
classic ``Updater`` reads, so either package's file, from either path,
loads here. The distributed hybrid step waits for ``ROADMAP.md`` A6.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from ..base import MXNetError
from ..io import DataDesc
from ..ndarray import NDArray

__all__ = ["FusedFitPath", "batch_axes_standard"]


def _tensor(x):
    """A state leaf (NDArray, tensor or numpy array) as a tensor."""
    if isinstance(x, NDArray):
        return x.data
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x


class _SharedFusedState:
    """The device-resident training state of the fused paths bound to one
    set of parameters (one, or every bucket of a BucketingModule)."""

    __slots__ = ("params", "auxs", "states", "host_states", "device_dirty",
                 "fresh")

    def __init__(self):
        self.params = None    # name -> float32 master tensor
        self.auxs = None      # name -> float32 tensor
        self.states = None    # name -> tuple of optimizer slot tensors
        self.host_states = None  # name -> serial state awaiting upload
        self.device_dirty = False
        self.fresh = False    # params/auxs hold the Module's values


class FusedFitPath:
    def __init__(self, module, share_state=None):
        from ..parallel.spmd import SPMDTrainer

        self._mod = module
        self.state = share_state if share_state is not None else _SharedFusedState()
        self._data_shapes = [(d.name, tuple(d.shape))
                             for d in module._data_shapes]
        self._label_shapes = [(d.name, tuple(d.shape))
                              for d in (module._label_shapes or [])]
        # raises ValueError on an optimizer without a fused rule
        self.trainer = SPMDTrainer(
            module._symbol, module._context[0], self._data_shapes,
            module._optimizer, label_shapes=self._label_shapes,
            compute_dtype=module._compute_dtype)
        self._pending = False     # a batch is staged for the next step()
        self.staged_batch = None  # the DataBatch behind it (for replay)
        self._outs = None         # the last step's outputs

    @property
    def device_dirty(self):
        return self.state.device_dirty

    # ---- state movement --------------------------------------------------
    def _allocate(self):
        """Device tensors for every parameter, auxiliary state and slot of
        this trainer that the shared state lacks (once per name)."""
        st, tr = self.state, self.trainer
        dev = tr.device
        if st.params is None:
            st.params, st.auxs, st.states = {}, {}, {}
        for n in tr.param_names:
            if n not in st.params:
                st.params[n] = torch.empty(tr.arg_shapes[n], dtype=torch.float32,
                                           device=dev)
                st.states[n] = tr.rule.init_state(tr.arg_shapes[n], dev)
        for n in tr.aux_names:
            if n not in st.auxs:
                st.auxs[n] = torch.empty(tr.aux_shapes[n], dtype=torch.float32,
                                         device=dev)

    def _upload_states(self):
        """Copy the staged serial states into the slots that exist."""
        st, rule = self.state, self.trainer.rule
        if st.host_states is None:
            return
        with torch.no_grad():
            for n in [n for n in st.host_states if n in st.states]:
                for dst, src in zip(st.states[n],
                                    rule.from_serial(st.host_states.pop(n))):
                    dst.copy_(_tensor(src))
        if not st.host_states:
            st.host_states = None

    def _ensure_device_state(self):
        """Bring the shared device state up to date for this trainer's
        step: every name it needs allocated, the parameters refreshed
        from the Module's copies when those are the truth (all of them)
        or new (a bucket whose symbol adds names), staged optimizer
        states uploaded."""
        st, mod, tr = self.state, self._mod, self.trainer
        if st.fresh:
            params = [n for n in tr.param_names if n not in (st.params or {})]
            auxs = [n for n in tr.aux_names if n not in (st.auxs or {})]
        else:
            if mod._params_dirty:
                # the executor group's copies are newer (a classic update ran)
                mod._sync_params_from_devices()
            params = list(set(st.params or ()) | set(tr.param_names))
            auxs = list(set(st.auxs or ()) | set(tr.aux_names))
        self._allocate()
        with torch.no_grad():
            for n in params:
                if n in mod._arg_params:
                    st.params[n].copy_(mod._arg_params[n].data)
            for n in auxs:
                if n in mod._aux_params:
                    st.auxs[n].copy_(mod._aux_params[n].data)
        self._upload_states()
        st.fresh = True

    def invalidate(self):
        """The Module's copies became the truth (``set_params``, a classic
        update): the device parameters are refreshed from them, in place,
        before the next step. Optimizer slots stay on the device."""
        self.state.fresh = False
        self.state.device_dirty = False
        self.drop_batch()

    def drop_batch(self):
        """Forget the staged batch and the cached outputs (a classic-path
        consumer takes over)."""
        self._pending = False
        self.staged_batch = None
        self._outs = None

    def sync_to_module(self):
        """Write the device parameters and auxiliary states back into the
        Module's host dicts and its executor group."""
        mod = self._mod
        st = self.state
        if not st.device_dirty or st.params is None:
            return
        for n, t in st.params.items():
            if n in mod._arg_params:
                mod._arg_params[n][:] = t
        for n, t in st.auxs.items():
            if n in mod._aux_params:
                mod._aux_params[n][:] = t
        mod._exec_group.set_params(
            {n: mod._arg_params[n] for n in mod._exec_group.param_names},
            {n: mod._aux_params[n] for n in mod._exec_group.aux_names})
        st.device_dirty = False

    # ---- optimizer-state handover to and from the classic Updater --------
    def _serial_by_name(self):
        """``{name: serial state}`` for this trainer's parameters: the
        device slots, or the staged ones, or fresh zeros."""
        st, tr = self.state, self.trainer
        out = {}
        for n in tr.param_names:
            if st.host_states is not None and n in st.host_states:
                out[n] = st.host_states[n]
            elif st.states is not None and n in st.states:
                out[n] = tr.rule.to_serial(st.states[n])
            else:
                out[n] = tr.rule.to_serial(
                    tr.rule.init_state(tr.arg_shapes[n], "cpu"))
        return out

    def states_for_updater(self):
        """The optimizer slots in the classic ``Updater``'s layout
        (``{index: state}`` by ``param_names`` order), as NDArrays."""
        index = {n: i for i, n in enumerate(self._mod._exec_group.param_names)}
        out = {}
        for n, serial in self._serial_by_name().items():
            if isinstance(serial, tuple):
                serial = tuple(NDArray(_tensor(s).clone()) for s in serial)
            elif serial is not None:
                serial = NDArray(_tensor(serial).clone())
            out[index[n]] = serial
        return out

    def set_states_from_updater(self, states):
        """Stage the classic Updater's states for the next fused step."""
        names = self._mod._exec_group.param_names
        self._stage_states({names[i]: s for i, s in states.items()
                            if s is not None})

    def _stage_states(self, by_name):
        """Stage serial states; the next step's ``stage`` copies them into
        the slots."""
        st = self.state
        st.host_states = dict(st.host_states or {}, **by_name)

    def get_states_bytes(self):
        """The ``.states`` file payload: ``{i: numpy state}`` keyed by
        ``enumerate(param_names)``, the classic Updater's layout."""
        def host(s):
            if s is None:
                return None
            if isinstance(s, tuple):
                return tuple(host(x) for x in s)
            return _tensor(s).detach().cpu().numpy().copy()

        return pickle.dumps({i: host(s) for i, s in
                             enumerate(self._serial_by_name().values())})

    def set_states_bytes(self, data):
        """Adopt a ``.states`` payload of either package (one context's
        ``{i: state}``, or one replica per context: the first is taken).
        A file that does not fit these parameters raises."""
        serial = pickle.loads(data)
        tr = self.trainer
        names = tr.param_names
        P = len(names)
        keys = set(serial.keys())
        if keys == set(range(P)):
            canon = {names[i]: serial[i] for i in range(P)}
        elif P and len(serial) % P == 0 and keys == set(range(len(serial))):
            stride = len(serial) // P
            canon = {names[i]: serial[i * stride] for i in range(P)}
        else:
            raise MXNetError("optimizer states file does not match this "
                             "module's %d parameters (keys %s)"
                             % (P, sorted(keys)[:8]))
        for n, s in canon.items():
            leaves = s if isinstance(s, tuple) else (() if s is None else (s,))
            want = tr.rule.nslot
            if len(leaves) != want or any(
                    tuple(np.shape(x)) != tuple(tr.arg_shapes[n]) for x in leaves):
                raise MXNetError(
                    "optimizer states do not match this model: %s has %d "
                    "state(s) of shapes %s, the optimizer keeps %d of %s"
                    % (n, len(leaves), [tuple(np.shape(x)) for x in leaves],
                       want, tuple(tr.arg_shapes[n])))
        self._stage_states(canon)

    # ---- fit-loop hooks --------------------------------------------------
    def accepts(self, data_batch):
        """Fused only for a batch of the bound shapes (the trainer, and
        its graph, are shape-specialized) and, once its input buffers
        exist, of their format (a uint8 wire batch, or not)."""
        wire = getattr(data_batch, "wire", None)
        if self.trainer.started and wire != self.trainer.wire:
            return False
        try:
            shapes = [(n, tuple(wire.decoded_desc(n, a.shape).shape
                                if wire is not None else a.shape))
                      for (n, _), a in zip(self._data_shapes, data_batch.data)]
            if shapes != self._data_shapes:
                return False
            if self._label_shapes:
                labels = data_batch.label or []
                lshapes = [(n, tuple(a.shape)) for (n, _), a in
                           zip(self._label_shapes, labels)]
                if lshapes != self._label_shapes:
                    return False
        except (AttributeError, TypeError):
            return False
        return True

    def stage(self, data_batch):
        """Copy the batch into the step's input buffers (a uint8 wire
        batch into uint8 buffers: the step decodes it, inside its graph)."""
        self._ensure_device_state()
        if not self.trainer.started:
            self.trainer.set_wire(getattr(data_batch, "wire", None))
        buffers = self.trainer.input_buffers()
        pairs = list(zip(self._data_shapes, data_batch.data))
        pairs += list(zip(self._label_shapes, data_batch.label or []))
        with torch.no_grad():
            for (name, _), arr in pairs:
                src = arr.data if isinstance(arr, NDArray) else torch.as_tensor(arr)
                buffers[name].copy_(src, non_blocking=True)
        self._pending = True
        self.staged_batch = data_batch
        self._outs = None

    @property
    def pending(self):
        return self._pending

    def step(self):
        if not self._pending:
            raise RuntimeError("no staged batch: call forward first")
        st = self.state
        self._outs = self.trainer.step(st.params, st.auxs, st.states)
        self._pending = False
        self.staged_batch = None
        st.device_dirty = True

    @property
    def has_outputs(self):
        return self._outs is not None or self._pending

    def get_outputs(self):
        """This step's outputs as NDArrays. Before the step has run
        (forward without update), an inference forward of the staged batch
        with the current parameters."""
        if self._outs is None and self._pending:
            st = self.state
            self._outs = self.trainer.forward(st.params, st.auxs,
                                              self.trainer.input_buffers())
        return [NDArray(o) for o in self._outs]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(list(labels), self.get_outputs())

    def state_bytes(self):
        """Bytes of optimizer state on the device."""
        st = self.state
        if st.states is None:
            return 0
        return sum(s.numel() * s.element_size()
                   for slots in st.states.values() for s in slots)


def batch_axes_standard(descs):
    """True when every desc's batch axis is 0 (what the fused step takes)."""
    return all(DataDesc.get_batch_axis(getattr(d, "layout", None)) == 0
               for d in descs)
