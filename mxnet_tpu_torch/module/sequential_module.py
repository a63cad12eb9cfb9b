"""SequentialModule: modules chained head to tail (the port of
``mxnet_tpu/module/sequential_module.py``; ref: python/mxnet/module/
sequential_module.py)."""
from __future__ import annotations

import logging

from ..io.io import DataDesc
from .base_module import BaseModule


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names

    @property
    def output_names(self):
        return self._modules[-1].output_names

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert shared_module is None
        self.for_training = for_training
        self.binded = True
        self._label_shapes = label_shapes

        cur_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False)
            last = i == len(self._modules) - 1
            module.bind(cur_shapes,
                        label_shapes if take_labels else None,
                        for_training=for_training,
                        inputs_need_grad=inputs_need_grad or i > 0,
                        force_rebind=force_rebind, grad_req=grad_req)
            if not last:
                out_shapes = module.output_shapes
                if meta.get(self.META_AUTO_WIRING, False):
                    names = self._modules[i + 1].data_names
                    cur_shapes = [DataDesc(n, s)
                                  for n, (_, s) in zip(names, out_shapes)]
                else:
                    cur_shapes = [DataDesc(n, s) for n, s in out_shapes]

    def init_params(self, **kwargs):
        for module in self._modules:
            module.init_params(**kwargs)
        self.params_initialized = True

    def get_params(self):
        arg_params, aux_params = {}, {}
        for module in self._modules:
            a, x = module.get_params()
            arg_params.update(a)
            aux_params.update(x)
        return arg_params, aux_params

    def init_optimizer(self, **kwargs):
        for module in self._modules:
            module.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        from ..io.io import DataBatch
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i < len(self._modules) - 1:
                batch = DataBatch(data=module.get_outputs(),
                                  label=data_batch.label,
                                  pad=data_batch.pad)

    def backward(self, out_grads=None):
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads)
            if i > 0:
                out_grads = module.get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
