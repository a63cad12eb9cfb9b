"""Decoder-LM training through gluon, the port against the JAX package on
the CPU: the decoder block of ``serving/generate/model.py`` on the same
weights (carried through numpy), ``autograd.record`` ->
``SoftmaxCrossEntropyLoss`` on next-token labels -> ``backward`` ->
``gluon.Trainer("adam")``, three steps, each started from the JAX
package's state after the step before; then the trained decoder served
by the port's ``register_generator`` against its ``reference_generate``.
Also the two ops the block reaches that came with it,
``_contrib_flash_attention`` and ``slice_axis``, forward and gradient.

Tolerances: the loss rtol 1e-5; gradients, updated weights and Adam
states rtol 1e-4 / atol 1e-5 (the JAX package's fp32 attention bound).
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import jax
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.serving.generate import GenerativeDecoder as JaxDecoder
from mxnet_tpu_torch.gluon.utils import updater_states_from_jax
from mxnet_tpu_torch.serving import Gateway
from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                              params_from_jax,
                                              reference_generate)

F32 = np.float32
CPU = tmx.cpu()
CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4)
BATCH, T = 2, 32
STEPS = 3
ADAM = {"learning_rate": 1e-3}
RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


def _snapshot(block, loss, grads, tree):
    """Gradients and parameters in ``collect_params()`` order (the two
    blocks register the same children in the same order; their names
    follow each package's counters)."""
    return {"loss": loss.asnumpy(), "grads": grads,
            "params": [p.data().asnumpy()
                       for p in block.collect_params().values()],
            "tree": tree}


def _jax_tree(jdec):
    return jax.tree_util.tree_map(np.asarray, jdec.param_tree())


@pytest.fixture(scope="module")
def lm_steps():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, CFG["vocab_size"], (BATCH, T + 1))
    x, y = tokens[:, :-1].astype(np.int32), tokens[:, 1:].astype(F32)

    mx.random.seed(0)
    jdec = JaxDecoder(**CFG)
    jnet = jdec.block
    init = _jax_tree(jdec)
    jnet.hybridize()        # one jitted training step
    jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "adam", dict(ADAM))
    jax_steps = []
    for _ in range(STEPS):
        with mx.autograd.record():
            loss = jloss(jnet(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        grads = [p.grad().asnumpy() for p in jnet.collect_params().values()]
        jtrainer.step(BATCH)
        snap = _snapshot(jnet, loss, grads, _jax_tree(jdec))
        snap["states"] = updater_states_from_jax(jtrainer._updaters)
        snap["counts"] = dict(jtrainer._optimizer._index_update_count)
        jax_steps.append(snap)

    # the JAX decoder's weights through its param_tree(), by structure
    tdec = GenerativeDecoder(**CFG, device="cpu")
    tnet = tdec.block
    tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    ttrainer = tmx.gluon.Trainer(tnet.collect_params(), "adam", dict(ADAM))
    port_steps = []
    with CPU:
        for t in range(STEPS):
            if t == 0:
                tdec.load_state_dict(params_from_jax(init))
            else:
                prev = jax_steps[t - 1]
                tdec.load_state_dict(params_from_jax(prev["tree"]))
                ttrainer._updaters.states = dict(prev["states"])
                ttrainer._optimizer._index_update_count = dict(
                    prev["counts"])
            with tmx.autograd.record():
                loss = tloss(tnet(tmx.nd.array(x)), tmx.nd.array(y))
            loss.backward()
            grads = [p.grad().asnumpy()
                     for p in tnet.collect_params().values()]
            ttrainer.step(BATCH)
            snap = _snapshot(tnet, loss, grads, tdec.param_tree())
            snap["states"] = {k: tuple(s.asnumpy() for s in v)
                              for k, v in ttrainer._updaters.states.items()}
            port_steps.append(snap)
    jps, tps = (list(n.collect_params().values()) for n in (jnet, tnet))
    assert [(p.name.rsplit("_", 1)[-1], p.shape) for p in jps] == \
        [(p.name.rsplit("_", 1)[-1], p.shape) for p in tps]
    return jdec, tdec, jax_steps, port_steps


def test_adam_steps_match_jax(lm_steps):
    _, _, jax_steps, port_steps = lm_steps
    # random init at this width: the first loss is near ln(vocab)
    assert abs(jax_steps[0]["loss"].mean() - np.log(CFG["vocab_size"])) < 0.1
    assert jax_steps[-1]["loss"].mean() < jax_steps[0]["loss"].mean()
    for j, t in zip(jax_steps, port_steps):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        for i in range(len(j["params"])):
            _close(t["grads"][i], j["grads"][i])
            _close(t["params"][i], j["params"][i])
            for ts, js in zip(t["states"][i], j["states"][i]):
                _close(ts, js)


def test_param_tree_matches_jax_after_the_steps(lm_steps):
    _, _, jax_steps, port_steps = lm_steps
    want, got = jax_steps[-1]["tree"], port_steps[-1]["tree"]
    assert set(got) == set(want)
    leaves = [(got[k], want[k]) for k in ("embed_w", "lnf_g", "lnf_b",
                                          "head_w")]
    assert len(got["layers"]) == len(want["layers"])
    for gl, wl in zip(got["layers"], want["layers"]):
        assert set(gl) == set(wl)
        leaves += [(gl[k], wl[k]) for k in wl]
    for g, w in leaves:
        _close(g.detach().numpy(), w)


def test_trained_decoder_serves_what_it_holds(lm_steps):
    """The serving steps read the block's parameters: what the Trainer
    wrote is what ``register_generator`` serves."""
    _, tdec, _, _ = lm_steps
    prompt = [3, 7, 11, 2, 9]
    gw = Gateway(device="cpu")
    try:
        gw.register_generator("lm", tdec, block_tokens=4, max_blocks=64,
                              max_new_tokens=8, max_decode_batch=2)
        assert gw.generate("lm", prompt, max_new_tokens=8) == \
            reference_generate(tdec, prompt, 8)
    finally:
        gw.close()


def test_serving_reads_parameters_set_after_registration():
    """A lane made before the weights change serves the new ones: no
    second copy of the weights goes stale."""
    dec = GenerativeDecoder(**CFG, device="cpu", seed=1)
    other = GenerativeDecoder(**CFG, device="cpu", seed=2)
    prompt = [1, 5, 9]
    gw = Gateway(device="cpu")
    try:
        gw.register_generator("lm", dec, block_tokens=4, max_blocks=64,
                              max_new_tokens=6, max_decode_batch=1,
                              warmup=False)
        before = gw.generate("lm", prompt, max_new_tokens=6)
        assert before == reference_generate(dec, prompt, 6)
        dec.load_state_dict(other.state_dict())
        after = gw.generate("lm", prompt, max_new_tokens=6)
        assert after == reference_generate(other, prompt, 6)
        assert after != before
    finally:
        gw.close()


# -- the ops the block reaches -----------------------------------------------
def _op_grads(pkg, op, arrays, head, **attrs):
    ctx = {"ctx": CPU} if pkg is tmx else {}
    xs = [pkg.nd.array(a, **ctx) for a in arrays]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, op)(*xs, **attrs)
    out.backward(pkg.nd.array(head, **ctx))
    return out.asnumpy(), [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("op,shapes,attrs", [
    ("slice_axis", [(2, 5, 3, 4)], {"axis": 2, "begin": 1, "end": 2}),
    ("slice_axis", [(6, 7)], {"axis": 1, "begin": 2, "end": None}),
    ("slice_axis", [(6, 7)], {"axis": -1, "begin": -3, "end": -1}),
    ("_contrib_flash_attention", [(2, 3, 20, 8)] * 3, {"causal": True}),
    ("flash_attention", [(2, 3, 20, 8), (2, 3, 24, 8), (2, 3, 24, 8)],
     {"causal": False, "scale": 0.3}),
])
def test_block_ops_forward_and_gradient_match_jax(op, shapes, attrs):
    rng = np.random.default_rng(len(shapes) * 10 + shapes[0][-1])
    arrays = [rng.standard_normal(s).astype(F32) for s in shapes]
    want = getattr(mx.nd, op)(*[mx.nd.array(a) for a in arrays],
                              **attrs).asnumpy()
    head = rng.standard_normal(want.shape).astype(F32)
    jout, jgrads = _op_grads(mx, op, arrays, head, **attrs)
    tout, tgrads = _op_grads(tmx, op, arrays, head, **attrs)
    _close(tout, jout)
    for g, w in zip(tgrads, jgrads):
        _close(g, w)


def test_ndarray_transpose_and_reshape_forms_match_jax():
    """The block's ``transpose(axes=...)`` and ``reshape`` with -1 on
    the NDArray, as the JAX package takes them."""
    x = np.arange(2 * 3 * 4 * 5, dtype=F32).reshape(2, 3, 4, 5)
    jx, tx = mx.nd.array(x), tmx.nd.array(x, ctx=CPU)
    for axes in ((0, 2, 1, 3), (3, 1, 0, 2)):
        np.testing.assert_array_equal(
            tmx.nd.transpose(tx, axes=axes).asnumpy(),
            mx.nd.transpose(jx, axes=axes).asnumpy())
    for shape in ((2, 3, -1), (6, -1, 5), (-1,)):
        np.testing.assert_array_equal(tx.reshape(*shape).asnumpy(),
                                      jx.reshape(*shape).asnumpy())
