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
needs them. The device tensors are allocated once and refreshed in place,
so a captured graph stays valid across :meth:`FusedFitPath.invalidate`.

Bucketing's shared fused state and the distributed hybrid step wait for
``ROADMAP.md`` A1 and A6.
"""
from __future__ import annotations

import torch

from ..io import DataDesc
from ..ndarray import NDArray

__all__ = ["FusedFitPath", "batch_axes_standard"]


class _FusedState:
    """The device-resident training state of one fused path."""

    __slots__ = ("params", "auxs", "states", "host_states", "device_dirty",
                 "fresh")

    def __init__(self):
        self.params = None    # name -> float32 master tensor
        self.auxs = None      # name -> float32 tensor
        self.states = None    # name -> tuple of optimizer slot tensors
        self.host_states = None  # classic Updater states awaiting upload
        self.device_dirty = False
        self.fresh = False    # params/auxs hold the Module's values


class FusedFitPath:
    def __init__(self, module):
        from ..parallel.spmd import SPMDTrainer

        self._mod = module
        self.state = _FusedState()
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
    def _ensure_device_state(self):
        st, tr = self.state, self.trainer
        if st.fresh:
            return
        mod = self._mod
        if mod._params_dirty:
            # the executor group's copies are newer (a classic update ran)
            mod._sync_params_from_devices()
        dev = tr.device
        if st.params is None:
            st.params = {n: torch.empty(tr.arg_shapes[n], dtype=torch.float32,
                                        device=dev) for n in tr.param_names}
            st.auxs = {n: torch.empty(tr.aux_shapes[n], dtype=torch.float32,
                                      device=dev) for n in tr.aux_names}
            st.states = tr.init_opt_state()
        with torch.no_grad():
            for n in tr.param_names:
                st.params[n].copy_(mod._arg_params[n].data)
            for n in tr.aux_names:
                st.auxs[n].copy_(mod._aux_params[n].data)
            if st.host_states is not None:
                for n, serial in st.host_states.items():
                    for dst, src in zip(st.states[n],
                                        tr.rule.from_serial(serial)):
                        dst.copy_(src.data if isinstance(src, NDArray)
                                  else src)
                st.host_states = None
        st.fresh = True

    def invalidate(self):
        """The Module's copies became the truth (``set_params``, a classic
        update): the device parameters are refreshed from them before the
        next step. Optimizer slots stay on the device."""
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
            mod._arg_params[n][:] = t
        for n, t in st.auxs.items():
            mod._aux_params[n][:] = t
        mod._exec_group.set_params(mod._arg_params, mod._aux_params)
        st.device_dirty = False

    # ---- optimizer-state handover to and from the classic Updater --------
    def states_for_updater(self):
        """The optimizer slots in the classic ``Updater``'s layout
        (``{index: state}`` by ``param_names`` order), as NDArrays on the
        device."""
        st, tr = self.state, self.trainer
        index = {n: i for i, n in enumerate(self._mod._exec_group.param_names)}
        out = {}
        for n in tr.param_names:
            if st.host_states is not None and n in st.host_states:
                out[index[n]] = st.host_states[n]
                continue
            serial = tr.rule.to_serial(st.states[n]) if st.states else None
            if isinstance(serial, tuple):
                serial = tuple(NDArray(s.clone()) for s in serial)
            elif serial is not None:
                serial = NDArray(serial.clone())
            out[index[n]] = serial
        return out

    def set_states_from_updater(self, states):
        """Stage the classic Updater's states for the next fused step."""
        names = self._mod._exec_group.param_names
        self.state.host_states = {names[i]: s for i, s in states.items()
                                  if s is not None}
        self.state.fresh = False

    # ---- fit-loop hooks --------------------------------------------------
    def accepts(self, data_batch):
        """Fused only for a batch of the bound shapes (the trainer, and
        its graph, are shape-specialized)."""
        try:
            shapes = [(n, tuple(a.shape)) for (n, _), a in
                      zip(self._data_shapes, data_batch.data)]
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
        """Copy the batch into the step's input buffers."""
        self._ensure_device_state()
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
