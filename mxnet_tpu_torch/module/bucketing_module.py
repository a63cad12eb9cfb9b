"""BucketingModule: variable-length training through one executor per
bucket, all sharing one set of parameter arrays (the port of
``mxnet_tpu/module/bucketing_module.py``; ref: python/mxnet/module/
bucketing_module.py).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._group2ctxs = group2ctxs
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._bind_args = None
        self._opt_args = None

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    def _gen_module(self, bucket_key):
        if bucket_key in self._buckets:
            return self._buckets[bucket_key]
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names=data_names, label_names=label_names,
                     logger=self.logger, context=self._context,
                     group2ctxs=self._group2ctxs,
                     fixed_param_names=self._fixed_param_names)
        self._buckets[bucket_key] = mod
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._bind_args = dict(for_training=for_training,
                               inputs_need_grad=inputs_need_grad,
                               grad_req=grad_req)
        self.for_training = for_training
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, force_rebind=force_rebind,
                 **self._bind_args)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        assert self.binded, "call bind before switching buckets"
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, **self._bind_args)
            if self._curr_module.optimizer_initialized:
                mod.borrow_optimizer(self._curr_module)
        if self._curr_module.params_initialized and \
                not mod.params_initialized:
            # share the actual arrays — no O(model) copy per switch; also
            # catches buckets that were bound before init_params ran
            mod.share_params_from(self._curr_module)
        # once shared, all buckets see every update through the same
        # NDArray objects — switching needs no copy at all
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, **kwargs):
        if self.params_initialized and not kwargs.get("force_init"):
            return
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        self._opt_args = dict(kvstore=kvstore, optimizer=optimizer,
                              optimizer_params=optimizer_params,
                              force_init=force_init)
        self._curr_module.init_optimizer(**self._opt_args)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded
        if data_batch.bucket_key is not None and \
                data_batch.bucket_key != self._curr_bucket_key:
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        # optimizer state lives per-module; shared params are copied on
        # bucket switch, so updating the current module is sufficient
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
