"""Model checkpoints and the legacy estimator (the port of
``mxnet_tpu/model.py``): ``prefix-symbol.json`` plus
``prefix-####.params``, an NDArray map whose keys carry ``arg:`` /
``aux:`` prefixes, which either package reads from the other;
``BatchEndParam``, the record the training callbacks get; and
``FeedForward``, the pre-Module API as an adapter over ``Module``."""
from __future__ import annotations

import collections

import numpy as np

from . import ndarray as nd
from . import symbol as sym_mod

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """(ref: model.py:383 save_checkpoint)"""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch, ctx=None):
    """(arg_params, aux_params) of ``prefix-####.params``, on ``ctx``
    (the current context when None)."""
    save_dict = nd.load(f"{prefix}-{epoch:04d}.params", ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "aux":
            aux_params[name] = v
        else:
            arg_params[name if tp == "arg" else k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    """(ref: model.py:413 load_checkpoint) -> (symbol, arg_params,
    aux_params)."""
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch, ctx=ctx)
    return symbol, arg_params, aux_params


def params_from_jax(arg, aux, ctx=None):
    """The JAX package's parameter dicts (values convertible with
    ``np.asarray``: its NDArrays' ``asnumpy()``, numpy arrays) as the
    port's NDArray dicts on ``ctx``:
    ``params_from_jax({k: v.asnumpy() ...}, {...})``."""
    def conv(d):
        return {k: nd.array(np.asarray(v), ctx=ctx) for k, v in d.items()}
    return conv(arg), conv(aux)


class FeedForward:
    """The pre-Module estimator API (ref: python/mxnet/model.py:451
    FeedForward) — kept as a thin adapter over Module so legacy scripts
    (`FeedForward.create(...)`, `.fit/.predict/.score/.save/.load`)
    run unmodified. New code should use Module or Gluon.
    """

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self._kwargs = dict(kwargs)
        self._module = None

    def _init_iter(self, X, y, is_train):
        from .io import NDArrayIter
        if hasattr(X, "provide_data"):
            return X
        X = np.asarray(X)
        if y is None:
            y = np.zeros(X.shape[0], np.float32)
        return NDArrayIter(X, np.asarray(y),
                           batch_size=min(self.numpy_batch_size,
                                          X.shape[0]),
                           shuffle=is_train)

    def _optimizer_params(self):
        """The reference passes optimizer hyperparams as loose ctor
        kwargs (learning_rate=..., momentum=...); accept both that and
        an explicit optimizer_params dict (model.py:488 **kwargs)."""
        params = dict(self._kwargs.get("optimizer_params") or {})
        for k, v in self._kwargs.items():
            if k != "optimizer_params":
                params.setdefault(k, v)
        params.setdefault("learning_rate", 0.01)
        return params

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        """Train (ref: model.py:793 FeedForward.fit)."""
        from .module import Module

        data = self._init_iter(X, y, is_train=True)
        self._module = Module(self.symbol, context=self.ctx)
        self._module.fit(
            data, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer,
            optimizer_params=self._optimizer_params(),
            initializer=self.initializer,
            arg_params=self.arg_params, aux_params=self.aux_params,
            begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
            monitor=monitor, eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def _ensure_module(self, data):
        """Lazy inference bind (load()ed models have no module yet)."""
        from .module import Module

        if self._module is None or not self._module.binded:
            self._module = Module(self.symbol, context=self.ctx)
            # loss-bearing graphs (SoftmaxOutput etc.) need the label
            # shape even at inference; _init_iter synthesizes one
            self._module.bind(data_shapes=data.provide_data,
                              label_shapes=data.provide_label,
                              for_training=False)
            self._module.set_params(self.arg_params or {},
                                    self.aux_params or {},
                                    allow_missing=False)
        return self._module

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Forward over X, concatenated to numpy
        (ref: model.py:673 predict)."""
        data = self._init_iter(X, None, is_train=False)
        mod = self._ensure_module(data)
        if not return_data:
            out = mod.predict(data, num_batch=num_batch, reset=reset)
            if isinstance(out, list):  # multi-output symbol / empty iter
                return [o.asnumpy() for o in out]
            return out.asnumpy()
        outs, datas, labels = [], [], []
        for outputs, _, batch in mod.iter_predict(data, num_batch=num_batch,
                                                  reset=reset):
            pad = batch.pad or 0
            end = batch.data[0].shape[0] - pad
            outs.append(outputs[0].asnumpy())
            datas.append(batch.data[0].asnumpy()[:end])
            labels.append(batch.label[0].asnumpy()[:end])
        return (np.concatenate(outs), np.concatenate(datas),
                np.concatenate(labels))

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """Evaluate (ref: model.py:742 score)."""
        from . import metric as metric_mod

        data = self._init_iter(X, None, is_train=False)
        mod = self._ensure_module(data)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        mod.score(data, eval_metric, num_batch=num_batch,
                  batch_end_callback=batch_end_callback, reset=reset)
        return eval_metric.get()[1]

    def save(self, prefix, epoch=None):
        """Checkpoint in the reference's format (ref: model.py:895)."""
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """(ref: model.py:918 load)."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", **kwargs):
        """Construct + fit in one call (ref: model.py:949 create)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            optimizer=optimizer, initializer=initializer,
                            **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore)
        return model
