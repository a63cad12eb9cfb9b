"""The port's parallel layouts held to the JAX package on the CPU
(``mxnet_tpu_torch/parallel`` against ``mxnet_tpu/parallel``): the
in-process mesh of ``cpu`` shards (one device named once per position,
the counterpart of the conftest's eight virtual CPU devices) against
JAX's ``shard_map`` over those devices, on the same seeded numpy
inputs — mesh construction and placement, every collective, the layout
table (resolution, report, JSON both ways), ``tp_mlp``, Ulysses and
ring attention at sp 2 and 4, causal and not, the pipeline and the MoE
layer (with dropped tokens). Tolerances: the collectives and the
layout exact; attention fp32 rtol 1e-4 / atol 1e-5 (the JAX attention
tests'); products that reassociate (``tp_mlp``, the pipeline, MoE)
within ``DIVERGENCE_BOUND`` (5e-5) of the output's scale; and the
rendezvous' own rules (bitwise repeatable runs, a failing shard aborts
the others, a shard that skips a collective times the others out)."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import ast
import contextlib
import functools
import inspect
import json
import threading
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import layout as jlayout
from mxnet_tpu.parallel.ring_attention import (
    ring_attention_sharded as jax_ring)
from mxnet_tpu.parallel.pipeline import stack_stage_params as jax_stack
from mxnet_tpu.parallel.moe import moe_ffn as jax_moe
from mxnet_tpu.parallel.tensor_parallel import (
    tp_mlp_param_specs as jax_mlp_specs, tp_qkv_param_specs as jax_qkv_specs)
from mxnet_tpu.serving.sharded import DIVERGENCE_BOUND
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import layout as tlayout
from mxnet_tpu_torch.parallel import mesh as mesh_mod
from mxnet_tpu_torch.parallel.mesh import PartitionSpec as P

ATT_RTOL, ATT_ATOL = 1e-4, 1e-5


def _jp(spec):
    return None if spec is None else JP(*spec)


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh) pairs by axes, made once; the port's shard
    threads stop at the end of the module."""
    made = {}

    def get(**axes):
        key = tuple(axes.items())
        if key not in made:
            n = int(np.prod(list(axes.values())))
            made[key] = (jpar.create_mesh(axes, devices=jax.devices()[:n]),
                         par.create_mesh(axes, devices=["cpu"] * n))
        return made[key]
    yield get
    for _, tm in made.values():
        tm.close()


def _both(meshes, axes, fn_jax, fn_port, in_specs, out_specs, *arrays):
    jm, tm = meshes(**axes)
    jin = tuple(_jp(s) for s in in_specs)
    jout = jax.tree_util.tree_map(_jp, out_specs, is_leaf=lambda s:
                                  isinstance(s, P) or s is None)
    # jitted: an eager shard_map dispatches op by op, some 10x slower
    got_j = jax.jit(jpar.shard_map(fn_jax, mesh=jm, in_specs=jin,
                                   out_specs=jout, check_vma=False))(*arrays)
    got_t = par.shard_map(fn_port, tm, in_specs=in_specs,
                          out_specs=out_specs)(
        *[torch.from_numpy(np.asarray(a)) for a in arrays])
    return got_j, got_t


def _rng(seed):
    return np.random.default_rng(seed)


# -- meshes and placement ----------------------------------------------------
def test_create_mesh_auto_shape_and_errors_match_jax():
    jdevs = jax.devices()[:8]
    for axes in (None, {"dp": 2, "tp": -1}, {"a": 2, "b": 2, "c": 2},
                 {"tp": 8}):
        jm = jpar.create_mesh(axes, devices=jdevs)
        tm = par.create_mesh(axes, devices=["cpu"] * 8)
        assert tm.axis_names == jm.axis_names
        assert tm.shape == dict(jm.shape)
        assert tm.devices.shape == jm.devices.shape
    for bad in ({"dp": 3}, {"a": -1, "b": -1}, {"a": 3, "b": -1}):
        with pytest.raises(ValueError):
            jpar.create_mesh(bad, devices=jdevs)
        with pytest.raises(ValueError):
            par.create_mesh(bad, devices=["cpu"] * 8)
    for n in range(1, 13):
        assert par.auto_mesh_shape(n) == jpar.auto_mesh_shape(n)
    assert par.auto_mesh_shape(8, ("x", "y")) == \
        jpar.auto_mesh_shape(8, ("x", "y"))
    # one card may hold every shard, when the caller lists it
    assert par.create_mesh({"tp": 2}, devices=["cpu", "cpu"]).size == 2
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            par.create_mesh({"tp": 2})     # the default: every card


def test_replica_slices_and_free_pool_match_jax_on_name_lists():
    names = [f"d{i}" for i in range(8)]
    cases = [(3, 2, names, ()), (5, 2, names, ()), (2, 2, names, names[:4]),
             (1, 4, names, names[:6]), (2, 3, names[:5], ()),
             (4, 1, names[:2], names[:1]), (1, 2, names[:2], names)]
    for n, tp, devs, exclude in cases:
        assert par.replica_slices(n, tp, devices=devs, exclude=exclude) \
            == jpar.replica_slices(n, tp, devices=devs, exclude=exclude), \
            (n, tp, devs, exclude)
    for bad in ((1, 3, names[:2]), (0, 2, names), (1, 0, names)):
        with pytest.raises(ValueError):
            jpar.replica_slices(*bad[:2], devices=bad[2])
        with pytest.raises(ValueError):
            par.replica_slices(*bad[:2], devices=bad[2])
    from mxnet_tpu.parallel.mesh import free_pool as jax_free
    assert par.free_pool(names, held=names[2:5]) == \
        jax_free(names, held=names[2:5])
    # the port's own rule: a slice holding one device twice is degraded
    slices, degraded = par.replica_slices(1, 2, devices=["cpu", "cpu"])
    assert slices == [("cpu", "cpu")] and degraded


def test_shard_batch_and_mesh_sharding_give_jax_shards(meshes):
    jm, tm = meshes(dp=2, tp=4)
    x = _rng(0).standard_normal((8, 16)).astype(np.float32)
    got = par.shard_batch({"x": x}, tm)["x"]
    want = jpar.shard_batch({"x": x}, jm)["x"]
    assert tuple(got.sharding.spec) == tuple(want.sharding.spec)
    for s in want.addressable_shards:
        pos = np.argwhere(jm.devices == s.device)[0]
        np.testing.assert_array_equal(got.shards[tuple(pos)].numpy(),
                                      np.asarray(s.data))
    np.testing.assert_array_equal(got.full().numpy(), x)
    sh = par.mesh_sharding(tm, None, ("dp", "tp")).shard(torch.from_numpy(x))
    jsh = jax.device_put(x, jpar.mesh_sharding(jm, None, ("dp", "tp")))
    for s in jsh.addressable_shards:
        pos = np.argwhere(jm.devices == s.device)[0]
        np.testing.assert_array_equal(sh.shards[tuple(pos)].numpy(),
                                      np.asarray(s.data))


# -- collectives ---------------------------------------------------------------
def _collective_bodies(lib):
    def body(x):
        idx = lib.axis_index(("a", "b"))
        return (lib.allreduce(x, "b"), lib.allreduce(x, ("a", "b"), "mean"),
                lib.allreduce(x, "b", "max"), lib.allreduce(x, "a", "min"),
                lib.allgather(x, "b", axis=1),
                lib.allgather(x, "a", axis=0, tiled=False),
                lib.reduce_scatter(x, "b", axis=1),
                lib.alltoall(x, "b", split_axis=1, concat_axis=0),
                lib.ppermute_next(x, "b"), lib.ppermute_next(x, "b", 3),
                x * 0 + idx * lib.axis_size("b"))
    return body


def test_collectives_match_jax_and_repeat_their_bits(meshes):
    x = _rng(1).standard_normal((4, 16)).astype(np.float32)
    spec = P("a", "b")
    out = (spec, spec, spec, spec, spec, P(None, "a", "b"), spec, spec,
           spec, spec, spec)
    got_j, got_t = _both(meshes, dict(a=2, b=4), _collective_bodies(jpar),
                         _collective_bodies(par), (spec,), out, x)
    for j, t in zip(got_j, got_t):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    again = par.shard_map(_collective_bodies(par), meshes(a=2, b=4)[1],
                          in_specs=(spec,), out_specs=out)(
        torch.from_numpy(x))
    for a, b in zip(got_t, again):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        par.shard_map(lambda v: par.allreduce(v, "b", "prod"),
                      meshes(a=2, b=4)[1], in_specs=(spec,),
                      out_specs=spec)(torch.from_numpy(x))


def test_failing_shard_aborts_and_skipped_collective_times_out(meshes,
                                                              monkeypatch):
    tm = meshes(a=2, b=4)[1]
    x = torch.zeros(8)
    seen = []

    def boom(v):
        if par.axis_index("b") == 2:
            raise RuntimeError("shard 2 failed")
        try:
            return par.allreduce(v, "b")
        except MXNetError as e:
            seen.append(str(e))
            raise

    with pytest.raises(RuntimeError, match="shard 2 failed"):
        par.shard_map(boom, tm, in_specs=(P(("a", "b")),),
                      out_specs=P(("a", "b")))(x)
    # the other three shards of each group raised instead of hanging
    # (the group without the failing shard may finish first)
    assert len(seen) >= 3 and all("aborted" in s for s in seen)

    def skip(v):
        return v if par.axis_index("b") == 0 else par.allreduce(v, "b")

    monkeypatch.setattr(mesh_mod, "COLLECTIVE_TIMEOUT_S", 0.2)
    with pytest.raises(MXNetError, match="timed out"):
        par.shard_map(skip, tm, in_specs=(P(("a", "b")),),
                      out_specs=P(("a", "b")))(x)
    with pytest.raises(MXNetError):
        par.allreduce(x, "b")          # outside shard_map


# -- the layout table ----------------------------------------------------------
def _decoder_tree(vocab=50, d=32, layers=1):
    rng = _rng(0)

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)
    lt = [{"ln1_g": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
           "qkv_w": w(3 * d, d), "qkv_b": np.zeros(3 * d, np.float32),
           "proj_w": w(d, d), "proj_b": np.zeros(d, np.float32),
           "ln2_g": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
           "ff1_w": w(4 * d, d), "ff1_b": np.zeros(4 * d, np.float32),
           "ff2_w": w(d, 4 * d), "ff2_b": np.zeros(d, np.float32)}
          for _ in range(layers)]
    return {"embed_w": w(vocab, d), "layers": lt,
            "lnf_g": np.ones(d, np.float32), "lnf_b": np.zeros(d, np.float32),
            "head_w": w(vocab, d), "dense0_weight": w(6, 5),
            "batchnorm0_running_var": np.ones(4, np.float32)}


def _custom(lib, spec):
    return lib.SpecLayout(
        tp_axis="model", table={"expert": spec("model", None, None)},
        rules=[(r"experts?_w$", "expert")] + list(jlayout._DEFAULT_RULES),
        overrides=[(r"^head_w$", "norm"), (r"lnf_g", spec(None, "model"))])


def test_spec_layout_resolves_reports_and_round_trips_like_jax(meshes):
    tree = _decoder_tree()
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    for axes in (dict(fsdp=2, tp=4), dict(data=2, tp=2), dict(tp=8)):
        jm, tm = meshes(**axes)
        for jlay, tlay in ((jlayout.SpecLayout(), tlayout.SpecLayout()),
                           (_custom(jlayout, JP), _custom(tlayout, P))):
            js = jlay.resolve_specs(tree, jm)
            ts = tlay.resolve_specs(ttree, tm)
            assert list(_spec_items(ts)) == list(_spec_items(js))
            assert tlay.report(ttree, tm) == jlay.report(tree, jm)
            assert tlayout.dryrun_report(tlay, ttree, tm, extra={"x": 1}) \
                == jlayout.dryrun_report(jlay, tree, jm, extra={"x": 1})
            assert tlay.to_json() == jlay.to_json()
            doc = json.loads(json.dumps(jlay.to_json()))
            assert tlayout.SpecLayout.from_json(doc).to_json() == doc
            doc = json.loads(json.dumps(tlay.to_json()))
            assert jlayout.SpecLayout.from_json(doc).to_json() == doc
            shardings = tlay.resolve(ttree, tm)
            assert tuple(shardings["layers"][0]["qkv_w"].spec) == \
                tuple(js["layers"][0]["qkv_w"])
            for dp in (2, 4):
                base = tlay.resolve_specs(ttree, tm)
                jz = jlay.zero_specs(tree, dp, base=jlay.resolve_specs(
                    tree, jm))
                tz = tlay.zero_specs(ttree, dp, base=base)
                assert list(_spec_items(tz)) == list(_spec_items(jz))
    for path, shape in (("qkv_w", (96, 32)), ("embed_w", (50, 32)),
                        ("x", (7,)), ("ff1_w", (6, 5))):
        assert tlayout.SpecLayout().spec_for(path) == \
            tuple(jlayout.SpecLayout().spec_for(path))
    jm, tm = meshes(fsdp=2, tp=4)
    assert [tuple(s.spec) for s in tlayout.collective_shardings(tm)] == \
        [tuple(s.spec) for s in jlayout.collective_shardings(jm)]
    assert [tuple(s) for s in par.tp_mlp_param_specs()] == \
        [tuple(s) for s in jax_mlp_specs()]
    assert [tuple(s) for s in par.tp_qkv_param_specs()] == \
        [tuple(s) for s in jax_qkv_specs()]
    with pytest.raises(MXNetError):
        tlayout.SpecLayout.from_json({"version": 2})


def _spec_items(node, path=()):
    """(path, spec entries) of a dict / list tree of specs."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _spec_items(node[k], path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _spec_items(v, path + (str(i),))
    else:
        yield "/".join(path), tuple(node)


# -- the shard_map-level functions ---------------------------------------------
def _close(got, want, bound=DIVERGENCE_BOUND):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= bound * np.max(np.abs(want)), err


def test_tp_mlp_matches_jax(meshes):
    rng = _rng(4)
    x, w1, b1, w2, b2 = (rng.standard_normal(s).astype(np.float32)
                         for s in ((4, 16), (16, 32), (32,), (32, 16), (16,)))
    specs = par.tp_mlp_param_specs()
    got_j, got_t = _both(meshes, dict(tp=4),
                         functools.partial(jpar.tp_mlp, axis_name="tp"),
                         functools.partial(par.tp_mlp, axis_name="tp"),
                         (P(),) + tuple(specs), P(), x, w1, b1, w2, b2)
    _close(got_t.numpy(), got_j)


def _both_causal(fn, **kw):
    """``fn`` non-causal and causal in one program (one JAX compile)."""
    return lambda *xs: (fn(*xs, causal=False, **kw),
                        fn(*xs, causal=True, **kw))


@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_matches_jax(meshes, sp):
    rng = _rng(3)
    q, k, v = (rng.standard_normal((2, 16, 8, 4)).astype(np.float32)
               for _ in range(3))
    spec = P(None, "sp", None, None)
    got_j, got_t = _both(
        meshes, dict(sp=sp),
        _both_causal(jpar.ulysses_attention, axis_name="sp"),
        _both_causal(par.ulysses_attention, axis_name="sp"),
        (spec, spec, spec), (spec, spec), q, k, v)
    for j, t in zip(got_j, got_t):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=ATT_RTOL, atol=ATT_ATOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax(meshes, sp):
    rng = _rng(1)
    q, k, v = (rng.standard_normal((1, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    jm, tm = meshes(sp=sp)
    got_j = jax.jit(_both_causal(jax_ring, mesh=jm, axis="sp"))(q, k, v)
    got_t = _both_causal(par.ring_attention_sharded, mesh=tm, axis="sp")(
        *map(torch.from_numpy, (q, k, v)))
    for j, t in zip(got_j, got_t):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=ATT_RTOL, atol=ATT_ATOL)


def test_pipeline_matches_jax(meshes):
    rng = _rng(5)
    ws = [(rng.standard_normal((8, 8)) / np.sqrt(8)).astype(np.float32)
          for _ in range(4)]
    x = rng.standard_normal((4, 2, 8)).astype(np.float32)
    jm, tm = meshes(pp=4)
    jstack = jax_stack([{"w": w} for w in ws])
    tstack = par.stack_stage_params([{"w": torch.from_numpy(w)} for w in ws])
    got_j = jax.jit(jpar.shard_map(
        functools.partial(jpar.pipeline_apply,
                          lambda p, h: jax.numpy.tanh(h @ p["w"]),
                          axis_name="pp"),
        mesh=jm, in_specs=(JP("pp"), JP()), out_specs=JP(),
        check_vma=False))(jstack, x)
    got_t = par.shard_map(
        functools.partial(par.pipeline_apply,
                          lambda p, h: torch.tanh(h @ p["w"]),
                          axis_name="pp"),
        tm, in_specs=(P("pp"), P()), out_specs=P())(
        tstack, torch.from_numpy(x))
    _close(got_t.numpy(), got_j)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_ffn_matches_jax(meshes, capacity_factor):
    """Top-1 routing with ample capacity and with a capacity that drops
    tokens (their rows come back zero in both packages)."""
    rng = _rng(6)
    t, d, dh, e = 16, 8, 16, 8
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    w1 = (rng.standard_normal((e, d, dh)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((e, dh, d)) / np.sqrt(dh)).astype(np.float32)
    got_j, got_t = _both(
        meshes, dict(ep=4),
        functools.partial(jax_moe, axis_name="ep",
                          capacity_factor=capacity_factor),
        functools.partial(par.moe_ffn, axis_name="ep",
                          capacity_factor=capacity_factor),
        (P(), P(), P("ep"), P("ep")), P(), x, router, w1, w2)
    _close(got_t.numpy(), got_j)
    dropped = np.all(np.asarray(got_j) == 0, axis=1)
    assert (dropped.any()) == (capacity_factor < 1)
    np.testing.assert_array_equal(np.all(got_t.numpy() == 0, axis=1),
                                  dropped)


def test_shard_threads_stop_with_the_mesh():
    tm = par.create_mesh({"x": 2}, devices=["cpu", "cpu"])
    par.shard_map(lambda v: par.allreduce(v, "x"), tm, in_specs=(P("x"),),
                  out_specs=P("x"))(torch.ones(2))
    name = f"mxtorch-mesh{id(tm):x}-"
    assert sum(t.name.startswith(name) for t in threading.enumerate()) == 2
    tm.close()
    assert not any(t.name.startswith(name) for t in threading.enumerate())


def test_kernel_launches_run_under_the_inputs_device_guard(monkeypatch):
    """K3 forward, K3 backward and K4 launch through ``_launch``, which
    takes the device guard from the input's device (a shard thread on
    another card launches on its input's card) and restores it after."""
    from mxnet_tpu_torch.ops import attention as att
    seen = []

    @contextlib.contextmanager
    def guard(device):
        seen.append(("enter", device))
        yield
        seen.append(("exit", device))

    monkeypatch.setattr(att.torch.cuda, "device", guard)
    x = types.SimpleNamespace(device=torch.device("cuda", 1))
    assert att._launch(lambda *a: seen.append(("call", a)) or 7, x, 1, 2) \
        == 7
    assert seen == [("enter", torch.device("cuda", 1)), ("call", (1, 2)),
                    ("exit", torch.device("cuda", 1))]
    tree = ast.parse(inspect.getsource(att))
    funcs = {f.name: f for f in ast.walk(tree)
             if isinstance(f, ast.FunctionDef)}
    for name in ("_flash_fwd", "_flash_bwd_cuda", "paged_attention"):
        calls = [c for c in ast.walk(funcs[name]) if isinstance(c, ast.Call)
                 and isinstance(c.func, ast.Name)]
        launches = [c for c in calls if c.func.id == "_launch"]
        assert launches, name
        # the guard's device is q's, and no C entry point is called bare
        assert all(c.args[1].id == "q" for c in launches), name
        assert not [c for c in calls if c.func.id == "fn"], name
