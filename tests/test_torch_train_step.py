"""The port's sharded training steps held to the JAX package on the CPU
(``mxnet_tpu_torch/parallel/train_step.py`` against
``mxnet_tpu/parallel/train_step.py``): ``sgd_update``, the replicated
dp 8 step and ZeRO stages 1-3 on the JAX ZeRO tests' regression
(``tests/test_parallel.py``: w (16, 4), b (4,), batch 32 x 16), four
steps from the same numpy seed, each within rtol 1e-5 / atol 1e-6 of
the JAX step's loss and parameters (that file's bound); the stages
equal to the port's replicated step bit for bit (they change the
layout, not the arithmetic); the state and parameter specs the JAX
package returns; each position's stored bytes the JAX census's
(w (512, 60) sharded eight ways, b (60,) replicated); the collectives a
step runs by kind, the port's counterpart of the JAX HLO test (stage 2
reduce-scatters, stage 3 gathers on use, the replicated step does
neither); parameters laid out over a tp axis, gathered on use; and the
JAX package's stage and momentum errors. The port's mesh names the CPU
eight times; the JAX steps are jitted over the conftest's eight virtual
CPU devices."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.parallel import mesh as mesh_mod
from mxnet_tpu_torch.parallel.mesh import PartitionSpec as P

RTOL, ATOL = 1e-5, 1e-6
STEPS = 4
STAGES = ("replicated", 1, 2, 3)


def _problem(seed, shape=(16, 4), batch=32, std=0.3):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(0, std, shape).astype(np.float32),
              "b": np.zeros(shape[1:], np.float32)}
    x = rng.normal(0, 1, (batch, shape[0])).astype(np.float32)
    y = rng.normal(0, 1, (batch, shape[1])).astype(np.float32)
    return params, (x, y)


def _jax_loss(p, batch):
    data, lbl = batch
    return jnp.mean((data @ p["w"] + p["b"] - lbl) ** 2)


def _loss(p, batch):
    data, lbl = batch
    return ((data @ p["w"] + p["b"] - lbl) ** 2).mean()


def _make(pkg, mesh, stage, params, batch, spec):
    if stage == "replicated":
        return pkg.make_sharded_train_step(
            _jax_loss if pkg is jpar else _loss, mesh, params, batch,
            batch_specs=(spec, spec), lr=0.1, momentum=0.9)
    return pkg.make_zero_train_step(
        _jax_loss if pkg is jpar else _loss, mesh, params, batch,
        batch_specs=(spec, spec), lr=0.1, momentum=0.9, stage=stage)


@pytest.fixture(scope="module")
def mesh():
    m = par.create_mesh({"dp": 8}, devices=["cpu"] * 8)
    yield m
    m.close()


@pytest.fixture(scope="module")
def runs(mesh):
    """By stage: the port's and the JAX package's parameters, state and
    losses after STEPS steps of the ZeRO tests' problem, the port's
    placed initial state and its last step's collectives."""
    params, batch = _problem(1)
    jmesh = jpar.create_mesh({"dp": 8})
    jbatch = tuple(jnp.asarray(a) for a in batch)
    out = {}
    for stage in STAGES:
        step, p, s = _make(par, mesh, stage, params, batch, P("dp"))
        jstep, jp, js = _make(jpar, jmesh, stage,
                              {k: jnp.asarray(v) for k, v in params.items()},
                              jbatch, JP("dp"))
        p0, s0 = p, s
        losses, jlosses = [], []
        for _ in range(STEPS):
            p, s, loss = step(p, s, batch)
            jp, js, jloss = jstep(jp, js, jbatch)
            losses.append(float(loss))
            jlosses.append(float(jloss))
        out[stage] = {"p": p, "s": s, "losses": losses, "jp": jp, "js": js,
                      "jlosses": jlosses, "collectives": step.last_collectives,
                      "p0": p0, "s0": s0}
    return out


def test_sgd_update_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=5).astype(np.float32)]}
    grads = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": [rng.normal(size=5).astype(np.float32)]}
    state = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": [rng.normal(size=5).astype(np.float32)]}
    t = lambda tr: jax.tree_util.tree_map(torch.from_numpy, tr)  # noqa: E731
    j = lambda tr: jax.tree_util.tree_map(jnp.asarray, tr)       # noqa: E731
    for momentum, st in ((None, None), (0.9, None), (0.9, state)):
        got, got_s = par.sgd_update(t(tree), t(grads), 0.1, momentum,
                                    None if st is None else t(st))
        want, want_s = jpar.sgd_update(j(tree), j(grads), 0.1, momentum,
                                       None if st is None else j(st))
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
        assert (got_s is None) == (want_s is None)


@pytest.mark.parametrize("stage", STAGES)
def test_step_matches_jax_after_four_steps(runs, stage):
    r = runs[stage]
    np.testing.assert_allclose(r["losses"], r["jlosses"], rtol=RTOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(np.asarray(r["p"][k]),
                                   np.asarray(r["jp"][k]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(np.asarray(r["s"][k]),
                                   np.asarray(r["js"][k]), rtol=RTOL,
                                   atol=ATOL)
    # the stages change the layout, not the arithmetic
    rep = runs["replicated"]
    assert r["losses"] == rep["losses"]
    for k in ("w", "b"):
        assert np.array_equal(np.asarray(r["p"][k]), np.asarray(rep["p"][k]))


@pytest.mark.parametrize("stage", STAGES)
def test_state_and_param_specs_are_the_jax_packages(runs, stage):
    r = runs[stage]
    # the placed initial state and the state after the steps
    for tree, jtree in ((r["p0"], r["jp"]), (r["s0"], r["js"]),
                        (r["p"], r["jp"]), (r["s"], r["js"])):
        for k in ("w", "b"):
            assert tuple(tree[k].sharding.spec) == \
                tuple(jtree[k].sharding.spec), (stage, k)
            assert tree[k].shape == jtree[k].shape


def _per_position(tree):
    """Each position's stored bytes of a tree of Sharded leaves."""
    leaves = list(tree.values())
    n = leaves[0].shards.size
    return [sum(v.shards.flat[i].untyped_storage().nbytes() for v in leaves)
            for i in range(n)]


def test_per_position_bytes_are_the_jax_census(mesh):
    """The JAX census test's expectations (``test_zero_census_per_device_
    live_bytes``): the replicated step holds everything everywhere,
    stage 2 a 1/dp slice of the dominant leaf's momentum, stage 3 of its
    parameter and momentum too, and a real step keeps it so."""
    params, batch = _problem(7, shape=(512, 60), std=0.1)
    w_bytes, b_bytes, dp = 512 * 60 * 4, 60 * 4, 8
    full, sliced = [w_bytes + b_bytes] * dp, [w_bytes // dp + b_bytes] * dp
    want = {"replicated": (full, full), 2: (full, sliced),
            3: (sliced, sliced)}
    for stage, (p_bytes, s_bytes) in want.items():
        step, p, s = _make(par, mesh, stage, params, batch, P("dp"))
        assert _per_position(p) == p_bytes, stage
        assert _per_position(s) == s_bytes, stage
        if stage == 3:
            p, s, _ = step(p, s, batch)
            assert _per_position(p) == p_bytes
            assert _per_position(s) == s_bytes


@pytest.mark.parametrize("stage", STAGES)
def test_collectives_by_stage(runs, stage):
    """The HLO test's behaviour, counted: the replicated step only
    all-reduces; stage 1 all-reduces the gradients and gathers the
    updated slice; stage 2 reduce-scatters the sharded leaf's gradient;
    stage 3 gathers the parameter on use and reduce-scatters its
    gradient (one leaf of the two shards: b's 4 rows do not divide)."""
    want = {"replicated": {"allreduce": 3},
            1: {"allreduce": 3, "allgather": 1},
            2: {"allreduce": 2, "reduce_scatter": 1, "allgather": 1},
            3: {"allreduce": 2, "reduce_scatter": 1, "allgather": 1}}
    assert runs[stage]["collectives"] == want[stage]


def test_tp_param_specs_are_gathered_on_use():
    """Parameters laid out over a tp axis of a dp 4 x tp 2 mesh are held
    as given at rest, gathered on use, and give the replicated step's
    parameters and loss bit for bit."""
    params, batch = _problem(2)
    m = par.create_mesh({"dp": 4, "tp": 2}, devices=["cpu"] * 8)
    try:
        tp_step, p, s = par.make_sharded_train_step(
            _loss, m, params, batch, param_specs={"w": P(None, "tp"),
                                                  "b": P("tp")},
            batch_specs=(P("dp"), P("dp")), lr=0.1, momentum=0.9)
        assert [x.shape for x in p["w"].shards.flat] == [(16, 2)] * 8
        step, q, t = par.make_sharded_train_step(
            _loss, m, params, batch, batch_specs=(P("dp"), P("dp")),
            lr=0.1, momentum=0.9)
        for _ in range(2):
            p, s, loss = tp_step(p, s, batch)
            q, t, want = step(q, t, batch)
        assert float(loss) == float(want)
        assert np.array_equal(np.asarray(p["w"]), np.asarray(q["w"]))
        assert p["w"].spec == P(None, "tp") and s["w"].spec == P(None, "tp")
        # w and b gathered on use, by each of the 4 tp groups
        assert tp_step.last_collectives["allgather"] == 8
    finally:
        m.close()


def test_a_sharded_batch_is_taken_in_place(mesh):
    """A batch laid out by ``shard_batch`` reaches each position as its
    own block (no copy), and steps as the host batch does."""
    params, batch = _problem(3)
    placed = par.shard_batch(batch, mesh)
    coords = mesh.positions()[3]
    assert mesh_mod._local(placed[0], P("dp"), mesh, coords) \
        is placed[0].local(coords)
    step, p, s = _make(par, mesh, 1, params, batch, P("dp"))
    step2, q, t = _make(par, mesh, 1, params, batch, P("dp"))
    _, _, loss = step(p, s, placed)
    _, _, want = step2(q, t, batch)
    assert float(loss) == float(want)


def test_zero_stage_and_momentum_errors(mesh):
    params = {"w": np.zeros((8, 2), np.float32)}
    batch = (np.zeros((8, 8), np.float32), np.zeros((8, 2), np.float32))
    jmesh = jpar.create_mesh({"dp": 8})
    for pkg, m, spec in ((par, mesh, P("dp")), (jpar, jmesh, JP("dp"))):
        loss = _jax_loss if pkg is jpar else _loss
        with pytest.raises(ValueError, match="stage"):
            pkg.make_zero_train_step(loss, m, params, batch,
                                     batch_specs=(spec, spec), stage=4)
        with pytest.raises(ValueError, match="momentum"):
            pkg.make_zero_train_step(loss, m, params, batch,
                                     batch_specs=(spec, spec),
                                     momentum=None)
        with pytest.raises(ValueError, match="state_specs"):
            pkg.make_sharded_train_step(loss, m, params, batch,
                                        batch_specs=(spec, spec),
                                        state_specs={"w": spec})
