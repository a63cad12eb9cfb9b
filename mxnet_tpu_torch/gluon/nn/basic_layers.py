"""Basic layers (the port of ``mxnet_tpu/gluon/nn/basic_layers.py``):
each layer's ``hybrid_forward`` calls the registry op by its MXNet name
through ``F`` (``nd`` eagerly, ``sym`` when traced), so the exported
graph is the JAX package's. ``InstanceNorm`` and ``SyncBatchNorm`` wait.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from ... import autograd
from ...ndarray.ndarray import NDArray
from ..block import Block, HybridBlock, defer_aux_update


class Sequential(Block):
    """Stack of blocks executed sequentially."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)
        return self

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        items = list(self._children.values())
        if isinstance(key, slice):
            net = self.__class__(prefix=self._prefix)
            net.add(*items[key])
            return net
        return items[key]

    def __iter__(self):
        return iter(self._children.values())

    def hybridize(self, active=True, **kwargs):
        # Sequential of HybridBlocks: children hybridize individually
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)
        return self

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        items = list(self._children.values())
        if isinstance(key, slice):
            net = self.__class__(prefix=self._prefix)
            net.add(*items[key])
            return net
        return items[key]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer (ref: basic_layers.py Dense)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation else None

    def infer_shape(self, x, *args):
        in_units = int(np.prod(x.shape[1:])) if self._flatten else x.shape[-1]
        self.weight.shape_inferred((self._units, in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation  # before super(): _alias() reads it
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type if isinstance(self._act_type, str) else "activation"

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class Dropout(HybridBlock):
    """Inverted dropout in training, the identity in predict mode. The
    layer owns its random stream: a seed drawn at construction from
    ``generator`` (else the CRC of the layer's prefix, so layers differ
    and a net repeats) seeds one ``torch.Generator`` per device the
    layer runs on."""

    def __init__(self, rate, axes=(), prefix=None, params=None,
                 generator=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes
        self._seed = zlib.crc32(self.prefix.encode()) if generator is None \
            else int(torch.randint(2 ** 62, (1,), generator=generator))
        self._generators = {}

    def _generator(self, device):
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device=device)
            gen.manual_seed(self._seed)
        return gen

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        if isinstance(x, NDArray) and autograd.is_training():
            return F.Dropout(x, p=self._rate, axes=self._axes,
                             generator=self._generator(x._data.device))
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization (ref: basic_layers.py BatchNorm): moving
    statistics in predict mode, batch statistics (and a running-stat
    update) in training mode; a trace emits one neutral BatchNorm node
    whose mode the executor picks at run time."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if axis == 1:
            # inside an nn.layout_scope("NHWC") the default channel axis
            # follows the scope's channel-last convention
            from .conv_layers import active_layout
            if active_layout():
                axis = -1
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,), grad_req="null",
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,), grad_req="null",
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape_inferred((c,))

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        if not isinstance(x, NDArray):
            return F.BatchNorm(
                x, gamma, beta, running_mean, running_var,
                eps=self._epsilon, momentum=self._momentum,
                fix_gamma=not self._scale,
                use_global_stats=self._use_global_stats, axis=self._axis)
        training = autograd.is_training() and not self._use_global_stats
        if training:
            out, mean, var = F.BatchNorm(
                x, gamma, beta, running_mean, running_var,
                eps=self._epsilon, momentum=self._momentum,
                fix_gamma=not self._scale,
                use_global_stats=False, output_mean_var=True,
                axis=self._axis, training=True)
            m = self._momentum
            # the running statistics stay out of the recorded graph
            with autograd.pause(train_mode=True):
                defer_aux_update(self.running_mean,
                                 running_mean * m + mean * (1 - m))
                defer_aux_update(self.running_var,
                                 running_var * m + var * (1 - m))
            return out
        return F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=True, axis=self._axis, training=False)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape_inferred((c,))
        self.beta.shape_inferred((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(function, str):
            from ... import ndarray as F
            function = getattr(F, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._func_name = function if isinstance(function, str) else None
        self._func = function

    def hybrid_forward(self, F, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(*args)
        return self._func(F, *args)
