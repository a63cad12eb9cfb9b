"""Trainer (the port of ``mxnet_tpu/gluon/trainer.py``; ref:
python/mxnet/gluon/trainer.py): applies an Optimizer to a set of
Parameters on one card.

The JAX Trainer makes a kvstore only for ``dist*`` types (or a given
``KVStore``); single-device training updates locally, and that is the
path ported here. A ``dist*`` type or a ``KVStore`` instance raises
until the kvstore and its gradient allreduce are ported. The JAX step's
health probe, tracing span, telemetry boundary and out-of-memory
postmortem wait for the runtime planes; they are no-ops there unless
enabled.
"""
from __future__ import annotations

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a list/dict of Parameters")
        if not isinstance(kvstore, (str, type(None))) or \
                str(kvstore).startswith("dist"):
            raise MXNetError(f"Trainer: kvstore {kvstore!r} is not ported "
                             "yet; train on one card (kvstore='device')")
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
        self._update_on_kvstore = update_on_kvstore
        self._compression_params = compression_params

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size`` and update every parameter (one
        card: no allreduce)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce on one card."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if p._data is None:
                if not ignore_stale_grad:
                    raise MXNetError(f"parameter {p.name} not initialized "
                                     "before step()")
                continue
            self._updaters(i, p.grad(), p.data())

    def save_states(self, fname):
        """The optimizer states (ref: trainer.py save_states); the JAX
        package's CRC manifest entry waits for the checkpoint plane."""
        with open(fname, "wb") as f:
            f.write(self._updaters.get_states())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self._updaters.set_states(f.read())
        # set_states may swap in a pickled optimizer
        self._optimizer = self._updaters.optimizer
