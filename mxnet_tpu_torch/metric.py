"""Evaluation metrics (the port of ``mxnet_tpu/metric.py``; ref:
python/mxnet/metric.py).

The same global + local accumulator protocol and registry as the JAX
package, and the same hot path: ``update`` never syncs. Inputs become
torch tensors where they live (an NDArray's tensor on its device, numpy
and lists on the CPU); each batch's statistic stays a 0-d tensor, and a
bounded window of them is folded into exact host sums at read time
(``get()`` / ``get_global()``), as the JAX package folds its lazily
scheduled jax scalars.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import Registry
from .ndarray.ndarray import NDArray

_reg = Registry("metric")


# short aliases matching the reference's registered names
# (ref: metric.py — 'acc', 'ce', 'nll_loss', 'top_k_accuracy'...)
_ALIASES = {
    "Accuracy": ("acc",),
    "TopKAccuracy": ("top_k_accuracy", "top_k_acc"),
    "CrossEntropy": ("ce",),
    "NegativeLogLikelihood": ("nll_loss",),
    "PearsonCorrelation": ("pearsonr",),
}


def register(klass):
    _reg.register(klass, aliases=_ALIASES.get(klass.__name__, ()))
    return klass


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    return _reg.get(metric)(*args, **kwargs)


def _as_np(x):
    """Host copy: the user-callback path only (``CustomMetric``)."""
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def _raw(x):
    """A tensor without a host sync: an NDArray's own (on its device),
    else the host value as a CPU tensor."""
    if isinstance(x, NDArray):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))


# batches buffered on device before the oldest is folded to host. By
# then it was dispatched dozens of steps ago, so float() is a cheap
# ready-buffer read, not a pipeline stall
_PENDING_WINDOW = 64


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        # accumulators initialized here, not only in reset(): subclasses
        # (Composite, user metrics like ssd's MApMetric) override
        # reset() without super(), and _drain() reads all of these
        self._pending = []
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        self.reset()

    def reset(self):
        self._pending = []   # [(metric, count)] — possibly device scalars
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        # fold pending batches first: the global accumulators keep them
        self._drain()
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def _update(self, metric, count):
        """Accumulate one batch. ``metric``/``count`` may be lazy device
        scalars: they buffer in a bounded window and fold into exact
        python float64/int sums — device accumulation would cap exact
        integer counts at float32's 2^24."""
        self._pending.append((metric, count))
        if len(self._pending) > _PENDING_WINDOW:
            self._fold(len(self._pending) - _PENDING_WINDOW)

    def _fold(self, n):
        for metric, count in self._pending[:n]:
            m = float(metric)
            c = int(count)
            self.sum_metric += m
            self.num_inst += c
            self.global_sum_metric += m
            self.global_num_inst += c
        del self._pending[:n]

    def _drain(self):
        """The device→host sync point: fold every buffered batch into
        the host-precision sums at read time."""
        self._fold(len(self._pending))
        # subclasses may assign device scalars directly (micro-averaged
        # confusion metrics): collapse those too
        if not isinstance(self.sum_metric, float):
            self.sum_metric = float(self.sum_metric)
        if not isinstance(self.global_sum_metric, float):
            self.global_sum_metric = float(self.global_sum_metric)
        if not isinstance(self.num_inst, int):
            self.num_inst = int(self.num_inst)
        if not isinstance(self.global_num_inst, int):
            self.global_num_inst = int(self.global_num_inst)

    def get(self):
        self._drain()
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_global(self):
        self._drain()
        if self.global_num_inst == 0:
            return self.name, float("nan")
        return self.name, self.global_sum_metric / self.global_num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def _pair_lists(labels, preds):
    if isinstance(labels, NDArray):
        labels = [labels]
    if isinstance(preds, NDArray):
        preds = [preds]
    return labels, preds


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _raw(pred)
            label = _raw(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(dim=self.axis)
            correct = (pred.int().ravel() == label.int().ravel()).sum()
            self._update(correct, int(label.numel()))


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _raw(pred)
            label = _raw(label).int()
            topk = torch.argsort(-pred, dim=1, stable=True)[:, :self.top_k]
            correct = (topk == label.reshape(-1, 1)).any(dim=1).sum()
            self._update(correct, int(label.shape[0]))


class _ConfusionMatrixMetric(EvalMetric):
    """Shared local/global binary confusion-matrix accumulation for F1/MCC.
    average="macro": per-batch score averaged over batches (ref semantics);
    average="micro": score of the pooled counts."""

    def __init__(self, name, output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        if average not in ("macro", "micro"):
            # a typo'd mode silently became micro — same unvalidated-enum
            # bug class as lr_scheduler warmup_mode
            raise ValueError(f"average must be 'macro' or 'micro', got "
                             f"{average!r}")
        self.average = average
        # integer counts (tp, fp, fn, tn): int32 on device stays exact
        # to 2^31 where float32 accumulation would drop counts past 2^24
        self._local = torch.zeros(4, dtype=torch.int64)   # local window
        self._global = torch.zeros(4, dtype=torch.int64)  # since reset()

    def reset(self):
        super().reset()
        self._local = torch.zeros(4, dtype=torch.int64)
        self._global = torch.zeros(4, dtype=torch.int64)

    def reset_local(self):
        super().reset_local()
        self._local = torch.zeros(4, dtype=torch.int64)

    @staticmethod
    def _score(c):
        raise NotImplementedError

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            batch = _binary_confusion(label, pred)
            if self.average == "macro":
                # per-batch score averaged over batches (ref semantics)
                self._update(self._score(batch), 1)
            else:  # micro: pooled confusion counts
                self._local = self._local.to(batch.device) + batch
                self._global = self._global.to(batch.device) + batch
                self.sum_metric = self._score(self._local)
                self.num_inst = 1
                self.global_sum_metric = self._score(self._global)
                self.global_num_inst = 1


def _binary_confusion(label, pred):
    """tp/fp/fn/tn counts for a binary batch — on device for device
    inputs (a 4-vector, not a sync)."""
    pred = _raw(pred)
    label = _raw(label)
    label = label.ravel().int()
    if pred.ndim > 1:
        pred = pred.argmax(dim=1)
    pred = pred.ravel().int()
    return torch.stack([
        ((pred == 1) & (label == 1)).sum(),
        ((pred == 1) & (label == 0)).sum(),
        ((pred == 0) & (label == 1)).sum(),
        ((pred == 0) & (label == 0)).sum(),
    ])


@register
class F1(_ConfusionMatrixMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)

    @staticmethod
    def _score(c):
        tp, fp, fn, _ = c * 1.0   # float math; counts themselves stay int
        prec = tp / torch.clamp_min(tp + fp, 1e-12)
        rec = tp / torch.clamp_min(tp + fn, 1e-12)
        return 2 * prec * rec / torch.clamp_min(prec + rec, 1e-12)


@register
class MCC(_ConfusionMatrixMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)

    @staticmethod
    def _score(c):
        tp, fp, fn, tn = c * 1.0  # float math: count products overflow int32
        denom = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return (tp * tn - fp * fn) / torch.clamp_min(denom, 1e-12)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _raw(label)
            pred = _raw(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._update(torch.abs(label - pred).mean(), 1)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _raw(label)
            pred = _raw(pred)
            self._update(((label.reshape(pred.shape) - pred) ** 2).mean(), 1)


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        self._drain()
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _raw(label)
            pred = _raw(pred)
            label = label.ravel().long()
            prob = pred[torch.arange(label.shape[0], device=pred.device),
                        label]
            self._update(-torch.log(prob + self.eps).sum(),
                         int(label.shape[0]))


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _raw(label)
            pred = _raw(pred)
            label = label.ravel().long()
            pred = pred.reshape(-1, pred.shape[-1])
            # an ignored label may lie outside the classes: pick safely
            rows = torch.arange(label.shape[0], device=pred.device)
            probs = pred[rows, label.clamp(0, pred.shape[-1] - 1)]
            num = label.shape[0]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = torch.where(ignore, torch.ones_like(probs), probs)
                # count stays lazy alongside the loss — drained together
                num = num - ignore.sum()
            loss = -torch.log(torch.clamp_min(probs, 1e-10)).sum()
            self._update(loss, num)

    def get(self):
        self._drain()
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _raw(label).ravel()
            pred = _raw(pred).ravel()
            r = torch.corrcoef(torch.stack([label, pred.to(label.dtype)]))[
                0, 1]
            self._update(r, 1)


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            pred = _raw(pred)
            self._update(pred.sum(), int(pred.numel()))


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        super().__init__(name or getattr(feval, "__name__", "custom"),
                         output_names, label_names)
        self._feval = feval

    def update(self, labels, preds):
        labels, preds = _pair_lists(labels, preds)
        for label, pred in zip(labels, preds):
            # user fevals are written against host numpy (the reference
            # contract) — the sync is the API, not an accident
            res = self._feval(_as_np(label), _as_np(pred))
            if isinstance(res, tuple):
                metric, count = res
                self._update(metric, count)
            else:
                self._update(res, 1)


def np_metric(name=None, allow_extra_outputs=False):
    def deco(fn):
        return CustomMetric(fn, name, allow_extra_outputs)
    return deco


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values
