"""bf16 decoder-LM training through gluon, the port against the JAX
package on the CPU: the decoder block of ``serving/generate/model.py``
on the same weights (carried through numpy), ``cast("bfloat16")`` on
both sides, ``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` on
next-token labels -> ``backward`` -> ``gluon.Trainer("adam",
multi_precision)``: three steps, each started from the JAX package's
state after the step before (bf16 weights, f32 masters and Adam
moments).

Bounds, derived rather than guessed. The two packages round to bf16 at
the same ops but their sums run in other orders, so they part by more
than a rounding; each step is therefore held to the JAX package's own
f32 run of that step on the same bf16-rounded weights (the JAX block
uncast, its weights set to the bf16 values): the port's bf16 result no
further from it than ``RATIO`` times the JAX bf16 result is, per
parameter (relative L2) for the gradients and, for the f32 masters
after the update, relative to the f32 step's update (the masters the
same Adam update gives from the f32 gradient). The loss is one bf16
value: held the same way, with half an ulp of it as the least distance
a bf16 loss can have. The multi-precision update itself, given the
JAX package's bf16 gradients, is bitwise the JAX Updater's.

The JAX bf16 block runs eagerly, op by op, as the port does. Hybridized,
XLA fuses its bf16 elementwise ops and keeps their intermediates in f32,
so it rounds at fewer places, and against that run the port's
gradients sit about twice as far from f32 on whole layers in some
steps: the bound compares runs that round where the port does.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.serving.generate import GenerativeDecoder as JaxDecoder
from mxnet_tpu_torch.gluon.utils import updater_states_from_jax
from mxnet_tpu_torch.ndarray import NDArray
from mxnet_tpu_torch.optimizer.optimizer import Updater
from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                              params_from_jax)

CPU = tmx.cpu()
CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4)
BATCH, T = 2, 32
STEPS = 3
ADAM = {"learning_rate": 1e-3, "multi_precision": True}
RATIO = 2.0
INIT_SEED = 0


def _f32(a):
    return np.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a,
                      np.float32)


def _rel(a, b, norm=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b if norm is None
                                                  else norm)


def _jax_tree(jdec):
    return jax.tree_util.tree_map(np.asarray, jdec.param_tree())


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _load_port_state(tdec, trainer, snap):
    """The JAX package's state after a step: bf16 weights by structure,
    f32 masters and moments, update counts."""
    tdec.load_state_dict(params_from_jax(snap["tree"]))
    trainer._updaters.states = dict(snap["states"])
    trainer._optimizer._index_update_count = dict(snap["counts"])


def _seed_weights(block, seed):
    """gluon's initial values from a numpy seed (weights Uniform(0.07),
    biases 0, LayerNorm gamma 1 and beta 0): the JAX initializer's draws
    depend on the parameters' names, which depend on what the process
    built before."""
    rng = np.random.default_rng(seed)
    for p in block.collect_params().values():
        kind = p.name.rsplit("_", 1)[-1]
        value = rng.uniform(-0.07, 0.07, p.shape) if kind == "weight" \
            else np.full(p.shape, 1.0 if kind == "gamma" else 0.0)
        p.set_data(mx.nd.array(value.astype(np.float32)))


@pytest.fixture(scope="module")
def lm_steps():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, CFG["vocab_size"], (BATCH, T + 1))
    x, y = tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(np.float32)

    jdec = JaxDecoder(**CFG)
    jnet = jdec.block
    _seed_weights(jnet, INIT_SEED)
    init = _jax_tree(jdec)
    jnet.cast("bfloat16")
    jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "adam", dict(ADAM))
    # the JAX package's f32 run of each step, on the step's bf16 weights
    ref = JaxDecoder(**CFG).block
    ref.hybridize()
    jps, rps = (list(n.collect_params().values()) for n in (jnet, ref))
    jax_steps = []
    for _ in range(STEPS):
        for rp, jp in zip(rps, jps):
            rp.set_data(jp.data().astype("float32"))
        with mx.autograd.record():
            rloss = jloss(ref(mx.nd.array(x)), mx.nd.array(y))
        rloss.backward()
        snap = {"tree": _jax_tree(jdec),
                "states": updater_states_from_jax(jtrainer._updaters),
                "counts": dict(jtrainer._optimizer._index_update_count),
                "f32_loss": _f32(rloss),
                "f32_grads": [_f32(p.grad()) for p in rps]}
        with mx.autograd.record():
            loss = jloss(jnet(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        assert str(loss.dtype) == "bfloat16"
        snap["loss"] = _f32(loss)
        snap["grads"] = [p.grad().asnumpy() for p in jps]
        jtrainer.step(BATCH)
        snap["after"] = {"params": [p.data().asnumpy() for p in jps],
                         "states": updater_states_from_jax(
                             jtrainer._updaters)}
        jax_steps.append(snap)

    tdec = GenerativeDecoder(**CFG, device="cpu")
    tnet = tdec.block
    tdec.load_state_dict(params_from_jax(init))
    tnet.cast("bfloat16")
    tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    ttrainer = tmx.gluon.Trainer(tnet.collect_params(), "adam", dict(ADAM))
    tps = list(tnet.collect_params().values())
    port_steps = []
    with CPU:
        for t in range(STEPS):
            # the JAX package's state before its step t
            before = {"tree": jax_steps[t]["tree"],
                      "states": jax_steps[t]["states"],
                      "counts": jax_steps[t]["counts"]}
            _load_port_state(tdec, ttrainer, before)
            dtypes = [str(p.data().dtype) for p in tps]
            with tmx.autograd.record():
                loss = tloss(tnet(tmx.nd.array(x)), tmx.nd.array(y))
            loss.backward()
            snap = {"loss": _f32(loss), "loss_dtype": str(loss.dtype),
                    "dtypes": dtypes,
                    "grads": [p.grad().asnumpy() for p in tps]}
            ttrainer.step(BATCH)
            snap["masters"] = [_f32(ttrainer._updaters.states[i][0])
                               for i in range(len(tps))]
            # the masters the same update gives from the f32 gradient
            opt = tmx.optimizer.create("adam", rescale_grad=1.0 / BATCH,
                                       **ADAM)
            opt._index_update_count = dict(before["counts"])
            upd = Updater(opt)
            upd.states = dict(before["states"])
            _load_port_state(tdec, ttrainer, before)
            snap["start_masters"] = [
                _f32(before["states"][i][0]) if i in before["states"]
                else _f32(p.data()) for i, p in enumerate(tps)]
            for i, (p, g) in enumerate(zip(tps, jax_steps[t]["f32_grads"])):
                upd(i, NDArray(torch.from_numpy(g.copy())), p.data())
            snap["f32_masters"] = [_f32(upd.states[i][0])
                                   for i in range(len(tps))]
            # the update alone: the JAX package's bf16 gradients in
            _load_port_state(tdec, ttrainer, before)
            for p, g in zip(tps, jax_steps[t]["grads"]):
                p.grad()._data.copy_(tmx.nd.array(g, ctx=CPU)._data)
            ttrainer.step(BATCH)
            snap["given_jax_grads"] = {
                "params": [p.data().asnumpy() for p in tps],
                "states": {k: (v[0].asnumpy(), tuple(s.asnumpy()
                                                     for s in v[1]))
                           for k, v in ttrainer._updaters.states.items()}}
            port_steps.append(snap)
    assert [(p.name.rsplit("_", 1)[-1], p.shape) for p in jps] == \
        [(p.name.rsplit("_", 1)[-1], p.shape) for p in tps]
    return jax_steps, port_steps


def test_block_and_step_types_match_jax(lm_steps):
    """After ``cast``: every parameter and gradient bf16, the loss bf16,
    f32 masters in the updater."""
    jax_steps, port_steps = lm_steps
    for j, t in zip(jax_steps, port_steps):
        assert set(t["dtypes"]) == {"bfloat16"} and t["loss_dtype"] == \
            "bfloat16"
        assert [g.dtype for g in t["grads"]] == [g.dtype for g in j["grads"]]
        assert all(m.dtype == np.float32 for m in t["masters"])


def test_loss_within_twice_the_jax_bf16_distance_from_f32(lm_steps):
    jax_steps, port_steps = lm_steps
    assert jax_steps[-1]["loss"].mean() < jax_steps[0]["loss"].mean()
    for j, t in zip(jax_steps, port_steps):
        # half an ulp of a bf16 value near the loss: 2^-9 of its power of 2
        half_ulp = 2.0 ** (np.floor(np.log2(np.abs(j["f32_loss"]))) - 8)
        bound = RATIO * np.maximum(np.abs(j["loss"] - j["f32_loss"]),
                                   half_ulp)
        assert (np.abs(t["loss"] - j["f32_loss"]) <= bound).all()


def test_gradients_within_twice_the_jax_bf16_distance_from_f32(lm_steps):
    jax_steps, port_steps = lm_steps
    for j, t in zip(jax_steps, port_steps):
        for tg, jg, fg in zip(t["grads"], j["grads"], j["f32_grads"]):
            assert _rel(_f32(tg), fg) <= RATIO * _rel(_f32(jg), fg)


def test_masters_within_twice_the_jax_bf16_distance_from_f32(lm_steps):
    """Over all masters of a step, relative to the f32 step's update.
    Per parameter this would not hold: Adam's early steps are close to
    lr * sign(g), so where an f32 gradient element lies within the bf16
    gradients' error of zero either bf16 run may flip that element's
    step by 2 lr, and a 32-value LayerNorm parameter's ratio then swings
    by 100x on one element. Over the step's 29,568 masters one element
    weighs nothing."""
    jax_steps, port_steps = lm_steps
    for j, t in zip(jax_steps, port_steps):
        tm, fm, m0 = (np.concatenate([a.ravel() for a in t[key]])
                      for key in ("masters", "f32_masters", "start_masters"))
        jm = np.concatenate([j["after"]["states"][i][0].ravel()
                             for i in range(len(t["masters"]))])
        assert _rel(tm, fm, fm - m0) <= RATIO * _rel(jm, fm, fm - m0)


def test_multi_precision_update_given_jax_grads_is_bitwise(lm_steps):
    jax_steps, port_steps = lm_steps
    for j, t in zip(jax_steps, port_steps):
        got, want = t["given_jax_grads"], j["after"]
        for a, b in zip(got["params"], want["params"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert set(got["states"]) == set(want["states"])
        for k, (master, moments) in got["states"].items():
            np.testing.assert_array_equal(master, want["states"][k][0])
            for a, b in zip(moments, want["states"][k][1]):
                np.testing.assert_array_equal(a, b)


