"""Trainer (the port of ``mxnet_tpu/gluon/trainer.py``; ref:
python/mxnet/gluon/trainer.py): applies an Optimizer to a set of
Parameters.

On one card it updates locally, as the JAX Trainer does for every type
that is not ``dist*``. A ``dist*`` type or a ``KVStore`` instance makes
a kvstore at the first step (:mod:`..kvstore`): with
``update_on_kvstore`` (the default there) each step pushes every
gradient and pulls the updated weight (the parameter server, or the
collective plane's replicated update); without it, each step allreduces
the gradients through the kvstore (push, then pull into the gradient)
and updates locally. Rank 0's values seed every worker at init. Each
step runs under a ``trainer_step`` span (``step`` the step's index from
0) and ends in a telemetry step boundary. Inside the span, the
model-health probe (``profiling.health.StepProbe``) counts the step's
nonfinite gradients and weights and computes its norms, and the health
boundary stamps the lagged health attrs on the span (a
``MXTPU_HEALTH=raise`` trip raises there); an allocation failure inside
the step leaves the OOM postmortem (``profiling.memory``) before it
propagates.
"""
from __future__ import annotations

from .. import optimizer as opt_mod
from .. import tracing as _tracing
from ..profiling import health as _health
from ..profiling import memory as _mem
from ..base import MXNetError
from ..telemetry import step as _tm_step
from .parameter import Parameter, ParameterDict


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a list/dict of Parameters")
        self._params = []
        self._param2idx = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p}")
            self._param2idx[p.name] = i
            self._params.append(p)
        optimizer_params = optimizer_params or {}
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._optimizer = opt_mod.create(optimizer, param_idx2name={
            i: p.name for i, p in enumerate(self._params)},
            **optimizer_params)
        self._updaters = opt_mod.get_updater(self._optimizer)
        self._kvstore_type = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._compression_params = compression_params
        self._kv_initialized = False
        self._shipped_rescale = None
        self._step_count = -1

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self):
        """The kvstore of a ``dist*`` type (on the parameters' device) or
        the ``KVStore`` given; none for the one-card types."""
        from ..kvstore import KVStore, create
        if isinstance(self._kvstore_type, KVStore):
            self._kvstore = self._kvstore_type
        elif self._kvstore_type and self._kvstore_type != "None" and \
                str(self._kvstore_type).startswith("dist"):
            ready = [p for p in self._params if p._data is not None]
            self._kvstore = create(
                self._kvstore_type,
                ready[0].data()._data.device if ready else None)
        if self._kvstore is not None:
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = True
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            for i, p in enumerate(self._params):
                if p._data is not None:
                    self._kvstore.init(i, p.data())
                    if not self._update_on_kvstore:
                        # worker-side updates never pull weights later, so
                        # rank 0's values land here (ref: trainer.py
                        # _init_params pulls after init)
                        self._kvstore.pull(i, out=p.data())
        self._kv_initialized = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size``, allreduce the gradients through
        the kvstore (when there is one and it does not update), update."""
        # before the kvstore's init: update_on_kvstore pickles the
        # optimizer to the server, which must see the batch scaling
        self._optimizer.rescale_grad = self._scale / batch_size
        # the root span of the step: the comm and compute spans under it
        # are what tools/trace_merge.py's straggler report groups by step
        n = self._step_count = self._step_count + 1
        with _tracing.span("trainer_step", cat="step", step=n) as sp:
            try:
                if not self._kv_initialized:
                    self._init_kvstore()
                self._sync_server_rescale()
                self._allreduce_grads()
                self._update(ignore_stale_grad)
            except Exception as e:
                # an allocation failure leaves the memory postmortem
                # (census, allocator statistics, flight dump) first
                _mem.maybe_oom_postmortem(e, source="trainer_step")
                raise
            # inside the step span: the lagged health attrs land on it,
            # and a MXTPU_HEALTH=raise trip surfaces here
            _health.step_boundary("trainer", span=sp)
        # one boundary a step: charges the data / comm / compile time
        # accrued since the previous boundary to this step (host time)
        _tm_step.step_boundary("trainer")

    def _sync_server_rescale(self):
        """Re-ship the optimizer when the batch scale changes after the
        first step (a short last batch): the server's updater would keep
        the stale ``rescale_grad``."""
        if self._kvstore is None or not self._update_on_kvstore:
            return
        if self._shipped_rescale is None:
            self._shipped_rescale = self._optimizer.rescale_grad
        elif self._shipped_rescale != self._optimizer.rescale_grad:
            self._kvstore.set_optimizer(self._optimizer)
            self._shipped_rescale = self._optimizer.rescale_grad

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is not None and not self._update_on_kvstore:
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.push(i, p.grad())
                    self._kvstore.pull(i, p.grad())

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        active = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if p._data is None:
                if not ignore_stale_grad:
                    raise MXNetError(f"parameter {p.name} not initialized "
                                     "before step()")
                continue
            active.append((i, p))
        # one probe a step over the gradients, the updated weights and
        # (for the update-to-weight ratios) the pre-update weights: the
        # optimizers update in place, so those are copied first, all at
        # once into a reused scratch, and only when the norms are on;
        # the per-call Updater check is suppressed underneath it
        probe = _health.step_probe()
        olds = [None] * len(active)
        if probe is not None and probe.wants_norms and active:
            olds = _health.pre_update_copy([p.data() for _, p in active])
        with _health.updater_covered():
            for (i, p), old in zip(active, olds):
                if self._kvstore is not None and self._update_on_kvstore:
                    self._kvstore.push(i, p.grad())
                    self._kvstore.pull(i, p.data())
                else:
                    self._updaters(i, p.grad(), p.data())
                if probe is not None:
                    probe.add(p.name, p.data(), p.grad(), weight_before=old)
        if probe is not None:
            probe.commit()

    def save_states(self, fname):
        """The optimizer states (ref: trainer.py save_states), written
        atomically with a CRC manifest entry; with the optimizer on the
        kvstore, the kvstore's states."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None and self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=False)
        else:
            from ..checkpoint import atomic_write
            with atomic_write(fname) as f:
                f.write(self._updaters.get_states())

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None and self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
            # the local updater mirrors the loaded states, so a later local
            # update does not resume from stale ones
            self._updaters.set_states(
                self._kvstore._updater.get_states(dump_optimizer=False))
            self._updaters.optimizer = self._optimizer
        else:
            from ..checkpoint import verify
            verify(fname)
            with open(fname, "rb") as f:
                self._updaters.set_states(f.read())
            # set_states may swap in a pickled optimizer
            self._optimizer = self._updaters.optimizer
