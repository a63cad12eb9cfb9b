"""BaseModule: the high-level train/predict contract (the port of
``mxnet_tpu/module/base_module.py``; ref: python/mxnet/module/
base_module.py).

``fit`` is the reference's epoch loop: bind -> init_params ->
init_optimizer -> per batch forward_backward / update / update_metric,
with callbacks and checkpointing. The per-batch work runs eagerly on the
bound executor's device, and each step ends in a telemetry step boundary
(``telemetry.step``, source ``module_fit``) and a model-health boundary
(``profiling.health``, which folds the executor and updater sentry
counts of earlier steps). While ``fit`` runs, a NaN postmortem carries
the training iterator's ``state_dict`` (``iter_state``).
"""
from __future__ import annotations

import logging
import time

import torch

from ..base import MXNetError
from .. import metric as metric_mod
from ..profiling import health as _health
from ..telemetry import step as _tm_step
from ..model import BatchEndParam
from ..ndarray import NDArray


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- properties subclasses provide ------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    # -- derived conveniences ---------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0, sparse_row_id_fn=None):
        """Evaluate on a data iterator (ref: base_module.py score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - (pad or 0)]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """(ref: base_module.py predict)"""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise MXNetError(
                        "cannot merge batches: different number of outputs")
            output_list2 = [
                NDArray(torch.cat([o[i]._data for o in output_list]))
                for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """Train over a DataIter (ref: base_module.py:409 fit)."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..base import get_env
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)
        if get_env("MXTPU_IO_PREFETCH_DEVICE", False, bool):
            # batch k + 1 is copied to the device while step k runs
            from ..io.io import PrefetchingIter
            if not isinstance(train_data, PrefetchingIter):
                train_data = PrefetchingIter(train_data,
                                             prefetch_to_device=True)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params or {}))

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        # a NaN postmortem raised inside this fit carries the batch
        # position (the iterator's state_dict) while the loop runs; a
        # provider installed by the caller is put back on the way out.
        # The epoch loop stays inline: BatchEndParam(locals=locals())
        # exposes fit's scope to callbacks (the reference contract)
        registered_iter_ctx = hasattr(train_data, "state_dict")
        prev_iter_ctx = None
        if registered_iter_ctx:
            prev_iter_ctx = _health._context_providers.get("iter_state")
            _health.register_postmortem_context(
                "iter_state", train_data.state_dict)
        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                nbatch = 0
                # close any stale step interval: validation,
                # checkpoints or the time between fit calls are no step's
                _tm_step.reset()
                train_data.reset()
                for data_batch in train_data:
                    if monitor is not None:
                        monitor.tic()
                    self.forward_backward(data_batch)
                    self.update()
                    # charges the data / comm / compile time accrued
                    # since the previous boundary to the step that just
                    # finished
                    _tm_step.step_boundary("module_fit")
                    # health boundary: folds the executor / updater
                    # sentry counts of earlier steps
                    _health.step_boundary("module_fit")
                    self.update_metric(eval_metric, data_batch.label)
                    if monitor is not None:
                        monitor.toc_print()
                    if batch_end_callback is not None:
                        params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               locals=locals())
                        for cb in _as_list(batch_end_callback):
                            cb(params)
                    nbatch += 1

                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - tic)

                arg_p, aux_p = self.get_params()
                if epoch_end_callback is not None:
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_p, aux_p)

                if eval_data is not None:
                    res = self.score(eval_data, validation_metric,
                                     score_end_callback=eval_end_callback,
                                     batch_end_callback=eval_batch_end_callback,
                                     epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
        finally:
            if registered_iter_ctx:
                _health.register_postmortem_context(
                    "iter_state", prev_iter_ctx)

    def install_monitor(self, mon):
        raise NotImplementedError


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
