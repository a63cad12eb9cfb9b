"""Module: symbol + executor + optimizer, the intermediate API (the port
of ``mxnet_tpu/module/module.py``; ref: python/mxnet/module/module.py).

``bind`` is ``Symbol.simple_bind``: on one device for ``context`` None
(the current context) or one context; over a one-axis ``"dp"`` mesh for
a list of contexts that ``context.dp_mesh`` makes one of (the JAX
package's ``_dp_mesh``): the data and label inputs split over ``dp``,
everything else replicated, the executor's dp path (``executor.py``)
summing the gradients across the positions. A list that repeats a
context binds its first device, with the JAX package's warning.
``update`` runs the optimizer class once a parameter on the summed
gradient (``update_multi_precision``), as the JAX package does, and the
next forward takes the result to every position;
optimizer-state files hold the same pickled numpy trees, so either
package loads the other's. ``install_monitor`` waits for the port of
``monitor.py``.
"""
from __future__ import annotations

import logging
import pickle

import numpy as np

from ..base import MXNetError
from ..checkpoint import atomic_write, verify
from ..context import cpu, dp_mesh, resolve_device
from .. import ndarray as nd
from .. import optimizer as opt_mod
from ..initializer import Uniform
from ..io.io import DataDesc
from ..model import load_checkpoint, save_checkpoint
from ..parallel.mesh import PartitionSpec as P
from ..random import generator as seeded_generator
from .base_module import BaseModule


def _placement(context, logger):
    """``(device, mesh)`` a Module binds: ``context`` None, a Context,
    device or string, or a list of them; the mesh (None on one device)
    is ``dp_mesh``'s over a list of several contexts."""
    if not isinstance(context, (list, tuple)):
        return resolve_device(context), None
    if len(context) <= 1:
        return resolve_device(context[0] if context else None), None
    mesh = dp_mesh(context)
    if mesh is None:
        logger.warning("context list %s does not map to distinct devices; "
                       "binding single-device", context)
        return resolve_device(context[0]), None
    return mesh.devices.flat[0], mesh


def _copy_to(src, device):
    """A fresh tensor of ``src`` (NDArray, tensor or array-like) on
    ``device``: updates run in place on the bound arrays, so the
    caller's arrays are never aliased."""
    if isinstance(src, nd.NDArray):
        return src._data.detach().to(device, copy=True)
    return nd.array(np.asarray(src), ctx=device)._data


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._context = context
        self._fixed_param_names = list(fixed_param_names or [])

        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._exec = None
        self._device = None
        self._optimizer = None
        self._preload_opt_states = None
        self._grad_req = None

    # -- introspection -----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        if self._exec.outputs:
            return [(n, o.shape) for n, o in zip(self._output_names,
                                                 self._exec.outputs)]
        # before the first forward: the shapes bind-time inference gives
        if self._cached_output_shapes is None:
            _, out_shapes, _ = self._symbol.infer_shape(**self._shape_hints)
            self._cached_output_shapes = list(
                zip(self._output_names, out_shapes))
        return self._cached_output_shapes

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._device, mesh = _placement(self._context, self.logger)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        self._data_shapes = [d if isinstance(d, DataDesc)
                             else DataDesc(*d) for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc)
                              else DataDesc(*d)
                              for d in (label_shapes or [])]
        shape_hints = {d.name: d.shape for d in self._data_shapes}
        shape_hints.update({d.name: d.shape for d in self._label_shapes})
        # inputs this iterator does not feed get inferred shapes
        known = set(self._symbol.list_inputs())
        self._shape_hints = {k: v for k, v in shape_hints.items()
                             if k in known}
        self._cached_output_shapes = None

        req = grad_req if for_training else "null"
        if isinstance(req, str):
            req_dict = {}
            for n in self._symbol.list_arguments():
                if n in self._data_names:
                    req_dict[n] = ("write" if inputs_need_grad and
                                   for_training else "null")
                elif n in self._label_names or \
                        n in self._fixed_param_names:
                    req_dict[n] = "null"
                else:
                    req_dict[n] = req
            req = req_dict
        self._grad_req = req
        arg_specs = None
        if mesh is not None:
            io_names = set(self._data_names) | set(self._label_names)
            arg_specs = {n: P("dp") if n in io_names else P()
                         for n in self._symbol.list_arguments()}
        self._exec = self._symbol.simple_bind(
            ctx=self._device, grad_req=req, mesh=mesh, arg_specs=arg_specs,
            **self._shape_hints)

        if shared_module is not None and shared_module.params_initialized:
            arg_p, aux_p = shared_module.get_params()
            self.set_params(arg_p, aux_p)
        elif self._arg_params is not None:
            # parameters survive a rebind (reshape)
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    # -- parameters --------------------------------------------------------
    _UNSET = object()  # tells "defaulted" from an explicit None

    def init_params(self, initializer=_UNSET, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Values from ``arg_params`` / ``aux_params`` (copied to the
        bound device), else from ``initializer`` (the reference's
        ``Uniform(0.01)`` by default; None keeps missing values unless
        ``allow_missing`` is False), which draws from a CPU generator
        seeded with 0, as gluon's ``initialize`` does by default."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        if initializer is Module._UNSET:
            initializer = Uniform(0.01)
        gen = seeded_generator(0)
        for names, target, given in (
                (self._param_names, self._exec.arg_dict, arg_params),
                (self._aux_names, self._exec.aux_dict, aux_params)):
            for name in names:
                arr = target[name]
                if given is not None and name in given:
                    arr._data = _copy_to(given[name], self._device)
                elif initializer is not None:
                    initializer(name, arr._data, gen)
                elif not allow_missing and target is self._exec.arg_dict:
                    raise MXNetError(
                        f"no initializer and no value for {name}")
        self.params_initialized = True
        self._params_dirty = False

    def share_params_from(self, src_module):
        """Adopt ``src_module``'s parameter and auxiliary NDArrays, so both
        executors see every (in-place) update without copies: buckets of
        a BucketingModule share one parameter set so."""
        assert self.binded and src_module.binded
        missing = [n for n in self._param_names
                   if n not in src_module._exec.arg_dict]
        if missing:
            raise MXNetError(
                f"share_params_from: {missing} not present in the source "
                "module; initialize them explicitly (bucket graphs must "
                "share one parameter set)")
        for n in self._param_names:
            self._exec.arg_dict[n] = src_module._exec.arg_dict[n]
        for n in self._aux_names:
            if n in src_module._exec.aux_dict:
                self._exec.aux_dict[n] = src_module._exec.aux_dict[n]
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        return ({n: self._exec.arg_dict[n].copy()
                 for n in self._param_names},
                {n: self._exec.aux_dict[n].copy()
                 for n in self._aux_names})

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """``kvstore`` is stored only, as in the JAX package: one device
        needs no gradient reduction."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        optimizer_params = dict(optimizer_params or {})
        if isinstance(optimizer, str):
            # the reference defaults rescale_grad to 1 / batch_size
            if "rescale_grad" not in optimizer_params:
                batch_size = self._data_shapes[0].shape[0]
                optimizer_params["rescale_grad"] = 1.0 / max(batch_size, 1)
            optimizer = opt_mod.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._kvstore_type = kvstore
        self._opt_states = {
            i: optimizer.create_state_multi_precision(
                i, self._exec.arg_dict[name])
            for i, name in enumerate(self._param_names)}
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share the optimizer and its states with another module (the
        bucketing contract): momenta and update counts stay one."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._opt_states = shared_module._opt_states
        self.optimizer_initialized = True

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip((d.name for d in self._data_shapes),
                         data_batch.data))
        if data_batch.label is not None:
            feeds.update(zip((d.name for d in self._label_shapes),
                             data_batch.label))
        self._exec.forward(is_train=is_train,
                           **{k: v for k, v in feeds.items()
                              if k in self._exec.arg_dict})

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """The optimizer on every parameter with a gradient, in place
        (ref: module.py update)."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            self._optimizer.update_multi_precision(
                i, self._exec.arg_dict[name], grad, self._opt_states[i])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self._exec.outputs)

    # -- checkpointing -----------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg_p, aux_p = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_p, aux_p)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of ``prefix``'s checkpoint; the parameters (read on
        the CPU) are installed at bind, on the bound device."""
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=cpu())
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        orig_bind = mod.bind

        def bind_then_set(*a, **kw):
            orig_bind(*a, **kw)
            mod.init_params(arg_params=args, aux_params=auxs,
                            allow_missing=False, force_init=True)

        mod.bind = bind_then_set
        return mod

    def save_optimizer_states(self, fname):
        with atomic_write(fname) as f:
            pickle.dump({i: _state_to_numpy(s)
                         for i, s in self._opt_states.items()}, f)

    def load_optimizer_states(self, fname):
        verify(fname)
        with open(fname, "rb") as f:
            states = pickle.load(f)
        self._opt_states = {i: _state_from_numpy(s, self._device)
                            for i, s in states.items()}

    def install_monitor(self, mon):
        """Tap the bound executor's node outputs with a ``Monitor`` (or a
        plain ``callback(name, NDArray)``)."""
        if hasattr(mon, "install"):
            mon.install(self._exec)
        else:
            self._exec.set_monitor_callback(mon)

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._params_dirty = False
        arg_p, aux_p = self.get_params()
        self._arg_params, self._aux_params = arg_p, aux_p
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)
        self.init_params(arg_params=arg_p, aux_params=aux_p,
                         force_init=True)


def _state_to_numpy(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_to_numpy(s) for s in state)
    if isinstance(state, nd.NDArray):
        return state.asnumpy()
    return state


def _state_from_numpy(state, device):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_from_numpy(s, device) for s in state)
    if isinstance(state, np.ndarray):
        return nd.array(state, ctx=device, dtype=state.dtype)
    return state
