"""Optimizers (the port of ``mxnet_tpu/optimizer/optimizer.py``; ref:
python/mxnet/optimizer/optimizer.py).

Each class keeps its own update formula and order of operations, which
are not those of the update ops (``SGD`` adds ``wd * w`` to the rescaled
gradient and then takes ``mu * mom - lr * g``; ``sgd_mom_update`` folds
``lr * wd`` first), so the Trainer's SGD never reaches the fused K2
kernels, as in the JAX package. The registry, the lr / wd multipliers,
``num_update``-driven schedules and multi-precision (fp32 master copies
of fp16 / bf16 weights) are the JAX package's.

Numbers: the JAX classes run eager ``jnp`` ops, one rounding each, and
the port runs the same ops in the same order. Two exceptions:

- ``SGD``'s steps (and ``LBSGD``'s) are jitted there, and XLA on the CPU
  contracts ``g + wd*w`` into one fused multiply-add, ``mu*mom - lr*g``
  into another (with ``lr*g`` rounded first) and the plain step's
  ``w - lr*g`` too. :func:`_fma` computes those as one rounding: on the
  CPU with ``fused_opt.fma32`` (bitwise the XLA program), on the card
  with ``torch.add(c, a, alpha=b)``, whose CUDA kernel is compiled with
  the contraction to one FMA.
- PyTorch's vectorised f32 square root on the CPU is not correctly
  rounded; ``fused_opt.sqrt32`` takes it in f64 there and rounds once
  (on the card ``sqrtf`` is correctly rounded).

Updates write into the weight's tensor in place under
``torch.no_grad()``: a parameter keeps its leaf and ``p.data()`` its
object. Row-sparse gradients (the lazy ``_step_rows`` updates) wait for
sparse NDArray and raise.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from ..base import MXNetError, Registry
from ..ndarray.ndarray import NDArray
from ..profiling import health as _health
from ..profiling import memory as _mem
from ..ops.fused_opt import f32, fma32, sqrt32

_reg = Registry("optimizer")


def register(klass):
    _reg.register(klass)
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _reg.get(name)(**kwargs)


def _fma(a, b, c, out=None):
    """``a * b + c`` rounded once, into ``out`` when given; ``b`` a
    Python float, rounded to f32 as the jitted program holds it."""
    if a.is_cuda:
        return torch.add(c, a, alpha=f32(b), out=out)
    res = fma32(a, f32(b), c)
    return res if out is None else out.copy_(res)


def _zeros(weight):
    return NDArray(torch.zeros_like(weight._data))


def _write(dst, value):
    """Write ``value`` into the array's tensor in place (the weight keeps
    its leaf, a state its buffer)."""
    with torch.no_grad():
        dst._data.copy_(value)


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.multi_precision = multi_precision
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- lr / wd bookkeeping ----------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set lr directly")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """An fp32 master copy beside the state for fp16 / bf16 weights
        (ref: optimizer.py:208)."""
        if self.multi_precision and weight._data.dtype in (torch.float16,
                                                           torch.bfloat16):
            master = NDArray(weight._data.detach().float())
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and isinstance(state, tuple) and \
                isinstance(state[0], NDArray) and \
                state[0]._data.dtype == torch.float32 and \
                weight._data.dtype != torch.float32:
            master, inner = state
            self.update(index, master, NDArray(grad._data.float()), inner)
            _write(weight, master._data)
        else:
            self.update(index, weight, grad, state)

    def _dense(self, grad):
        if getattr(grad, "stype", "default") != "default":
            raise MXNetError("row-sparse gradients wait for sparse NDArray "
                             "(lazy updates are not ported)")
        return grad._data

    def _preprocess(self, weight, grad, wd):
        g = self._dense(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g + wd * weight._data


@register
class SGD(Optimizer):
    """SGD with momentum and optional multi-precision (ref: optimizer.py
    SGD): ``g = clip(rescale*grad) + wd*w``; ``mom = mu*mom - lr*g``;
    ``w += mom`` (``w -= lr*g`` without momentum)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = self._dense(grad) * f32(self.rescale_grad)
            if self.clip_gradient is not None:
                c = f32(self.clip_gradient)
                g = torch.clamp(g, -c, c)
            g = _fma(w, wd, g)
            if state is None:
                w.copy_(_fma(g, -f32(lr), w))
                return
            lr_g = g.mul_(-f32(lr))          # -(lr*g): one rounding
            mom = state._data
            _fma(mom, self.momentum, lr_g, out=mom)
            w.add_(mom)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            w = weight._data
            if state is not None:
                _write(state, self.momentum * state._data
                       - (1 - self.momentum) * g)
                _write(weight, (1 - lr * self.wd_lh) * w
                       + lr * torch.sign(state._data))
            else:
                _write(weight, (1 - lr * self.wd_lh) * w
                       - lr * torch.sign(g))


@register
class NAG(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            if state is None:
                _write(weight, weight._data - lr * g)
            else:
                _write(state, self.momentum * state._data + g)
                _write(weight, weight._data
                       - lr * (g + self.momentum * state._data))


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            m, v = state
            _write(m, self.beta1 * m._data + (1 - self.beta1) * g)
            _write(v, self.beta2 * v._data + (1 - self.beta2) * g * g)
            _write(weight, weight._data - lr_t * m._data / (
                sqrt32(v._data) + self.epsilon))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            _write(state, state._data + g * g)
            _write(weight, weight._data - lr * g / (
                sqrt32(state._data) + self.float_stable_eps))


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            if self.centered:
                n, gmean, delta = state
                _write(n, (1 - self.gamma1) * g * g
                       + self.gamma1 * n._data)
                _write(gmean, (1 - self.gamma1) * g
                       + self.gamma1 * gmean._data)
                _write(delta, self.gamma2 * delta._data - lr * g / sqrt32(
                    n._data - gmean._data * gmean._data + self.epsilon))
                _write(weight, weight._data + delta._data)
            else:
                n = state
                _write(n, (1 - self.gamma1) * g * g
                       + self.gamma1 * n._data)
                _write(weight, weight._data - lr * g / sqrt32(
                    n._data + self.epsilon))
            if self.clip_weights:
                _write(weight, torch.clamp(weight._data, -self.clip_weights,
                                           self.clip_weights))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            acc_g, acc_delta = state
            _write(acc_g, self.rho * acc_g._data + (1 - self.rho) * g * g)
            delta = sqrt32(acc_delta._data + self.epsilon) / sqrt32(
                acc_g._data + self.epsilon) * g
            _write(acc_delta, self.rho * acc_delta._data
                   + (1 - self.rho) * delta * delta)
            _write(weight, weight._data - delta)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))    # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._dense(grad) * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            z, n = state
            sigma = (sqrt32(n._data + g * g) - sqrt32(n._data)) / lr
            _write(z, z._data + g - sigma * weight._data)
            _write(n, n._data + g * g)
            zd = z._data
            _write(weight, torch.where(
                torch.abs(zd) > self.lamda1,
                -(zd - torch.sign(zd) * self.lamda1)
                / ((self.beta + sqrt32(n._data)) / lr + wd),
                torch.zeros_like(zd)))


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr / (1 - self.beta1 ** t)
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            m, u = state
            _write(m, self.beta1 * m._data + (1 - self.beta1) * g)
            _write(u, torch.maximum(self.beta2 * u._data, torch.abs(g)))
            _write(weight, weight._data - lr_t * m._data / (u._data + 1e-8))


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        mu_t = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mu_tp1 = self.beta1 * (1 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * mu_t
        m_sched_next = self.m_schedule * mu_tp1
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            m, v = state
            _write(m, self.beta1 * m._data + (1 - self.beta1) * g)
            _write(v, self.beta2 * v._data + (1 - self.beta2) * g * g)
            g_prime = g / (1 - self.m_schedule)
            m_prime = m._data / (1 - m_sched_next)
            v_prime = v._data / (1 - self.beta2 ** t)
            m_bar = (1 - mu_t) * g_prime + mu_tp1 * m_prime
            _write(weight, weight._data - lr * m_bar / (
                sqrt32(v_prime) + self.epsilon))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics. The noise comes from the
    optimizer's own ``torch.Generator`` (seeded by ``seed``) on the
    weight's device: the port has no global stream of random draws."""

    def __init__(self, seed=0, **kwargs):
        super().__init__(**kwargs)
        self.seed = seed
        self._generators = {}

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        gen = self._generators.get(w.device)
        if gen is None:
            gen = torch.Generator(device=w.device)
            gen.manual_seed(self.seed)
            self._generators[w.device] = gen
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            noise = torch.randn(w.shape, generator=gen, device=w.device,
                                dtype=w.dtype) * math.sqrt(lr)
            _write(weight, w - lr / 2 * g + noise)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_generators"] = {}
        return state


@register
class FTML(Optimizer):
    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            d, v, z = state
            _write(v, self.beta2 * v._data + (1 - self.beta2) * g * g)
            d_t = (1 - self.beta1 ** t) / lr * (
                sqrt32(v._data / (1 - self.beta2 ** t)) + self.epsilon)
            sigma = d_t - self.beta1 * d._data
            _write(z, self.beta1 * z._data + (1 - self.beta1) * g
                   - sigma * weight._data)
            _write(d, d_t)
            _write(weight, -z._data / d_t)


@register
class DCASGD(Optimizer):
    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros(weight) if self.momentum else None
        return (mom, NDArray(weight._data.detach().clone()))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._preprocess(weight, grad, wd)
            mom, prev = state
            w = weight._data
            comp = g + self.lamda * g * g * (w - prev._data)
            if mom is not None:
                _write(mom, self.momentum * mom._data - lr * comp)
                delta = mom._data
            else:
                delta = -lr * comp
            _write(prev, w)
            _write(weight, w + delta)


@register
class LBSGD(SGD):
    """Large-batch SGD with LARS-style layer-wise scaling (ref:
    optimizer.py LBSGD). Its step is jitted in the JAX package, where
    XLA sums the two norms in its own order: the port agrees to
    rounding, not bitwise."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        if warmup_strategy not in ("linear", "power2", "sqrt", "lars"):
            raise ValueError(f"unknown warmup_strategy {warmup_strategy!r}")
        self.warmup_strategy = warmup_strategy
        self.warmup_updates = int(warmup_epochs * updates_per_epoch)
        self.batch_scale = batch_scale
        self.init_updates = int(begin_epoch * updates_per_epoch)

    def _get_lr(self, index):
        """Warm the lr up over the first warmup_epochs toward
        batch_scale x base lr (ref: optimizer.py LBSGD._get_lr)."""
        lr = super()._get_lr(index)
        nup = max(self.num_update - self.init_updates, 0)
        target = lr * self.batch_scale
        if nup >= self.warmup_updates or self.warmup_updates == 0:
            return target
        frac = nup / self.warmup_updates
        if self.warmup_strategy == "linear":
            return lr + (target - lr) * frac
        if self.warmup_strategy == "power2":
            return lr + (target - lr) * frac * frac
        if self.warmup_strategy == "sqrt":
            return lr + (target - lr) * (frac ** 0.5)
        return lr  # "lars": constant base lr during warmup

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = self._dense(grad) * f32(self.rescale_grad)
            wnorm = torch.linalg.vector_norm(w)
            gnorm = torch.linalg.vector_norm(g)
            ratio = torch.where((wnorm > 0) & (gnorm > 0),
                                wnorm / (gnorm + f32(wd) * wnorm + 1e-9),
                                torch.ones_like(wnorm))
            g = _fma(w, wd, g)
            lr_g = g * -(f32(lr) * ratio)
            mom = state._data
            _fma(mom, self.momentum, lr_g, out=mom)
            w.add_(mom)


@register
class Test(Optimizer):
    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        _write(weight, weight._data - self.rescale_grad * grad._data)


_MISSING = object()


class Updater:
    """Apply an optimizer, holding a state per index (ref: optimizer.py
    get_updater). States loaded by ``set_states`` stay numpy until the
    first update of their index puts them on its weight's device."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        state = self.states.get(index, _MISSING)
        if state is _MISSING:
            state = self.optimizer.create_state_multi_precision(index,
                                                                weight)
        else:
            state = _state_on(state, weight._data.device)
        self.states[index] = state
        self.optimizer.update_multi_precision(index, weight, grad, state)
        if _health.enabled() and not _health.updater_is_covered():
            # the optimizer's in / out sentry: the incoming gradient and
            # the updated weight in one count a call, so kvstore servers
            # and Module.update are covered as a Trainer is (whose probe
            # covers its whole loop and suppresses this check)
            name = self.optimizer.idx2name.get(index, str(index))
            _health.check("optimizer/%s" % name, [grad, weight])
        if _mem.census_enabled():
            # census roles, re-stamped each update: a backward may have
            # rebound the gradient (weak side-table writes only)
            _mem.tag_tree(state, "optimizer_state")
            _mem.tag_role(weight, "parameter")
            _mem.tag_role(grad, "gradient")

    def get_states(self, dump_optimizer=False):
        payload = {"states": {k: _state_to_np(v)
                              for k, v in self.states.items()}}
        if dump_optimizer:
            payload["optimizer"] = self.optimizer
        return pickle.dumps(payload)

    def set_states(self, states):
        loaded = pickle.loads(states)
        if "optimizer" in loaded:
            self.optimizer = loaded["optimizer"]
        self.states = dict(loaded["states"])



def _state_to_np(state):
    """A state tree as numpy (bf16 as fp32: numpy has no bf16)."""
    if state is None or isinstance(state, np.ndarray):
        return state
    if isinstance(state, tuple):
        return tuple(_state_to_np(s) for s in state)
    t = state._data.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _state_on(state, device):
    """A state tree of NDArrays on ``device`` (numpy leaves converted)."""
    if state is None or isinstance(state, NDArray):
        return state
    if isinstance(state, tuple):
        return tuple(_state_on(s, device) for s in state)
    return NDArray(torch.from_numpy(np.array(state)).to(device))


def get_updater(optimizer):
    return Updater(optimizer)
