"""The fused fit path behind Module (counterpart of
``mxnet_tpu/module/fused_path.py``).

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

Several contexts (A6d): the trainer runs over a ``dp`` mesh with one
position per context, the JAX package's data-parallel step
(:class:`~..parallel.spmd.SPMDTrainer`). Distinct contexts that are one
torch device (``cpu(0)``, ``cpu(1)``: the CPU is one torch device) are
distinct positions on it (``ROADMAP.md`` C37). Every position keeps its
own replica of the masters, auxiliary states and slots
(:class:`_SharedFusedState` ``pos_params``, ``pos_auxs``,
``pos_states``; ``params``, ``auxs`` and ``states`` are position 0's);
a write from the Module's side reaches every replica, and a read
(``get_params``, a checkpoint, a ``.states`` file) takes position 0's,
once.

Bucketing: the buckets of a ``BucketingModule`` share one
:class:`_SharedFusedState` (``Module.borrow_optimizer``). Each bucket has
its own trainer, shape-specialized, with its own CUDA graph, and every
graph is captured on the shared state's tensors. Those tensors are
allocated once and only ever written in place (``set_params``, optimizer
states from a file, a rebind, a resume all ``copy_`` into them), so every
bucket's graph stays valid and a bucket switch moves nothing through the
host. The update count is the one optimizer's that the buckets share,
and the mesh is the shared state's.

Optimizer states travel in the JAX package's ``.states`` format
(:meth:`FusedFitPath.get_states_bytes`/``set_states_bytes``): a pickled
``{index: numpy state}`` keyed by ``enumerate(param_names)``, what the
classic ``Updater`` reads, so either package's file, from either path,
loads here.

Distributed (a ``dist*`` kvstore, :meth:`FusedFitPath._step_dist`): the
step runs as two CUDA graphs with the parameter-server exchange on the
host between them, the JAX package's hybrid step. The gradient graph
writes float32 gradients into static buffers; they are pushed by integer
key (the classic path's: the index in ``param_names``), bucketed
(``KVStoreDist.bucketed_push_pull``) where the store has it. When the
servers run the optimizer (``update_on_kvstore``, every dist type) the
pulled values are the new weights and are copied into the master tensors;
otherwise the pulled sums are copied into the gradient buffers and the
update graph applies the rule. Everything pulled is written in place
into the tensors the graphs captured (a rebind would leave every replay
reading the first step's). So is an elastic recovery's state: a
survivor's rollback (``Module.set_params``) and a rejoining worker's
pull reach the module's copies, which the next step copies into the
captured tensors; a step refused by a membership change leaves its batch
staged, and the rollback drops it.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from .. import compileobs as _compileobs
from ..base import MXNetError
from ..io import DataDesc
from ..ndarray import NDArray
from ..parallel import collectives as C

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

    __slots__ = ("mesh", "params", "auxs", "states", "pos_params",
                 "pos_auxs", "pos_states", "host_states", "device_dirty",
                 "fresh")

    def __init__(self, mesh):
        self.mesh = mesh      # the dp mesh: one position per context
        self.params = None    # name -> float32 master tensor (position 0)
        self.auxs = None      # name -> float32 tensor (position 0)
        self.states = None    # name -> tuple of optimizer slot tensors
        # the same, name -> [one per position] (entry 0 is position 0's)
        self.pos_params = None
        self.pos_auxs = None
        self.pos_states = None
        self.host_states = None  # name -> serial state awaiting upload
        self.device_dirty = False
        self.fresh = False    # params/auxs hold the Module's values

    def for_trainer(self, tr):
        """(params, auxs, states) as ``tr`` takes them: position 0's dicts
        on one position, else one list per name."""
        if self.mesh.size == 1:
            return self.params, self.auxs, self.states
        return ({n: self.pos_params[n] for n in tr.param_names},
                {n: self.pos_auxs[n] for n in tr.aux_names},
                {n: self.pos_states[n] for n in tr.param_names})


# thread-confined: a fused path is driven by its Module's thread; the feed thread's `slot.stage(...)` is _PinnedSlot.stage, which the
# analyzer's method-name match also ties to FusedFitPath.stage
class FusedFitPath:
    def __init__(self, module, share_state=None):
        from ..parallel import build_mesh
        from ..parallel.spmd import SPMDTrainer

        self._mod = module
        if share_state is None:
            share_state = _SharedFusedState(
                build_mesh({"dp": len(module._context)}, module._context))
        self.state = share_state
        self._data_shapes = [(d.name, tuple(d.shape))
                             for d in module._data_shapes]
        self._label_shapes = [(d.name, tuple(d.shape))
                              for d in (module._label_shapes or [])]
        # raises ValueError on an optimizer without a fused rule
        self.trainer = SPMDTrainer(
            module._symbol, share_state.mesh, self._data_shapes,
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
        devs = st.mesh.device_list
        if st.params is None:
            st.params, st.auxs, st.states = {}, {}, {}
            st.pos_params, st.pos_auxs, st.pos_states = {}, {}, {}
        for n in tr.param_names:
            if n not in st.params:
                st.pos_params[n] = [torch.empty(tr.arg_shapes[n],
                                                dtype=torch.float32, device=d)
                                    for d in devs]
                st.pos_states[n] = [tr.rule.init_state(tr.arg_shapes[n], d)
                                    for d in devs]
                st.params[n] = st.pos_params[n][0]
                st.states[n] = st.pos_states[n][0]
        for n in tr.aux_names:
            if n not in st.auxs:
                st.pos_auxs[n] = [torch.empty(tr.aux_shapes[n],
                                              dtype=torch.float32, device=d)
                                  for d in devs]
                st.auxs[n] = st.pos_auxs[n][0]

    def _upload_states(self):
        """Copy the staged serial states into the slots that exist."""
        st, rule = self.state, self.trainer.rule
        if st.host_states is None:
            return
        with torch.no_grad():
            for n in [n for n in st.host_states if n in st.states]:
                srcs = rule.from_serial(st.host_states.pop(n))
                for slots in st.pos_states[n]:
                    for dst, src in zip(slots, srcs):
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
                    for t in st.pos_params[n]:
                        t.copy_(mod._arg_params[n].data)
            for n in auxs:
                if n in mod._aux_params:
                    for t in st.pos_auxs[n]:
                        t.copy_(mod._aux_params[n].data)
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
        ``enumerate(param_names)``, the classic Updater's layout; over
        several contexts without ``update_on_kvstore``, one copy per
        context keyed ``i * num_device + k``, the classic multi-device
        Updater's (as the JAX package writes it)."""
        def host(s):
            if s is None:
                return None
            if isinstance(s, tuple):
                return tuple(host(x) for x in s)
            # fwlint: disable=host-sync — the .states file's payload: host egress by contract
            return _tensor(s).detach().cpu().numpy().copy()

        serial = {i: host(s) for i, s in
                  enumerate(self._serial_by_name().values())}
        ndev = len(self._mod._context)
        if ndev > 1 and not self._mod._update_on_kvstore:
            serial = {i * ndev + k: s for i, s in serial.items()
                      for k in range(ndev)}
        return pickle.dumps(serial)

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

    def _dist_kv(self):
        """The module's store when it trains distributed, else None."""
        kv = self._mod._kvstore
        if kv is not None and "dist" in getattr(kv, "type", ""):
            return kv
        return None

    def step(self):
        if not self._pending:
            raise RuntimeError("no staged batch: call forward first")
        st = self.state
        kv = self._dist_kv()
        # OOM forensics at the step's boundary: a device out-of-memory
        # logs the live tensors and the program table before it propagates
        with _compileobs.oom_guard("fused.step"):
            if kv is not None:
                self._step_dist(kv)
            else:
                self._outs = self.trainer.step(*st.for_trainer(self.trainer))
        self._pending = False
        self.staged_batch = None
        st.device_dirty = True

    def _step_dist(self, kv):
        """One distributed step (see the module docstring): the gradient
        graph, the push and pull on the host, the pulled weights written
        in place into the masters, or the pulled sums into the gradient
        buffers and then the update graph."""
        st, tr = self.state, self.trainer
        params, auxs, states = st.for_trainer(tr)
        self._outs = tr.grad_step(params, auxs)
        # position 0's buffers hold the gradient summed over the local
        # positions: it alone is pushed
        grads = tr.grad_buffers()
        update_on_kv = self._mod._update_on_kvstore
        # a pull writes into its out in place (NDArray[:] = value): these
        # outs are the tensors the graphs captured
        dst = st.params if update_on_kv else grads
        pairs = [(idx, NDArray(grads[name]), NDArray(dst[name]))
                 for idx, name in enumerate(self._mod._exec_group.param_names)
                 if name in grads]
        bucketed = getattr(kv, "bucketed_push_pull", None)
        if bucketed is None or not bucketed(pairs):
            # key by key (MXNET_KV_BUCKET_MB=0, or the single-process
            # store of a dist type without a launcher)
            for idx, grad, out in pairs:
                kv.push(idx, grad, priority=-idx)
                kv.pull(idx, out=out, priority=-idx)
        # what was pulled into position 0's tensors reaches the others
        with torch.no_grad():
            for p in range(1, st.mesh.size):
                peer = ({n: st.pos_params[n][p] for n in grads}
                        if update_on_kv else tr.grad_buffers(p))
                for n in grads:
                    peer[n].copy_(dst[n])
                C.count_transfers(len(grads), sum(
                    dst[n].numel() * dst[n].element_size() for n in grads))
        if not update_on_kv:
            tr.apply_grads(params, states)

    @property
    def has_outputs(self):
        return self._outs is not None or self._pending

    def get_outputs(self):
        """This step's outputs as NDArrays. Before the step has run
        (forward without update), an inference forward of the staged batch
        with the current parameters."""
        if self._outs is None and self._pending:
            params, auxs, _ = self.state.for_trainer(self.trainer)
            self._outs = self.trainer.forward(params, auxs,
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
                   for per_pos in st.pos_states.values()
                   for slots in per_pos for s in slots)


def batch_axes_standard(descs):
    """True when every desc's batch axis is 0 (what the fused step takes)."""
    return all(DataDesc.get_batch_axis(getattr(d, "layout", None)) == 0
               for d in descs)
