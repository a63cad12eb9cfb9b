"""The port's live-tensor census and OOM postmortem
(``mxnet_tpu_torch.profiling.memory``) against the JAX package's
(tests/test_memory.py, its census and OOM cases): role tagging at the
framework seams, per-position bytes over a mesh, census role bytes of
the same flows (a gluon Trainer with Adam, ``Module.fit``, ZeRO-3 over a
dp 4 mesh, a generator's KV pool), the telemetry collector and its
backfill of the CPU's positions, the chrome-trace census track, OOM
classification, the postmortem's keys at the executor, Trainer and
sharded-step seams, and the liveness-ledger names that raise.

Whole-process ``activation`` is left out of every comparison: the JAX
census counts every live array of the process (``jax.live_arrays()``),
while torch lists no live tensors, and on the CPU no allocator counts
them; with ``arrays=`` both classify exactly the arrays given.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import gc
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.profiling import memory as jmemory
from mxnet_tpu_torch.profiling import memory

import observability_harness as oh


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_OOM_DUMP_PATH", str(tmp_path / "oom.json"))
    memory._LAST_POSTMORTEM[0] = -10.0
    jmemory._LAST_POSTMORTEM[0] = -10.0
    oh.reset_both()
    yield
    oh.reset_both()


def _roles(doc):
    """{role: (bytes, arrays)} of a census, activation left out."""
    return {r: (v["bytes"], v["arrays"]) for r, v in doc["by_role"].items()
            if r != "activation"}


def _devices(doc):
    return {d: {r: b for r, b in v["by_role"].items() if r != "activation"}
            for d, v in doc["by_device"].items()}


def test_tagging_and_explicit_census_equal_the_jax_packages():
    import jax.numpy as jnp
    a, b = torch.ones(64, 64), torch.ones(32, 32)
    ja, jb = jnp.ones((64, 64)), jnp.ones((32, 32))
    memory.tag_role(a, "parameter")
    jmemory.tag_role(ja, "parameter")
    assert memory.role_of(a) == "parameter" and memory.role_of(b) is None
    mine = memory.live_census(arrays=[a, b], top=1)
    theirs = jmemory.live_census(arrays=[ja, jb], top=1)
    for k in ("arrays", "total_bytes", "by_role", "by_device", "top"):
        assert mine[k] == theirs[k], k
    assert mine["by_role"]["activation"]["bytes"] == 32 * 32 * 4
    # a view and its base share their bytes: counted once
    doc = memory.live_census(arrays=[a, a[:8]])
    assert doc["total_bytes"] == 64 * 64 * 4


def test_per_position_bytes_on_a_mesh_equal_the_jax_packages():
    """Replicated: the whole leaf at every position; dp-sharded: 1/dp."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from mxnet_tpu.parallel import create_mesh as jmesh
    from mxnet_tpu_torch import parallel as par

    jm = jmesh({"dp": 8})
    jrepl = jax.device_put(jnp.ones((64, 32)), NamedSharding(jm, JP()))
    jshard = jax.device_put(jnp.ones((64, 32)), NamedSharding(jm, JP("dp")))
    jmemory.tag_role(jrepl, "parameter")
    jmemory.tag_role(jshard, "optimizer_state")
    mesh = par.create_mesh({"dp": 8}, devices=["cpu"] * 8)
    try:
        x = torch.ones(64, 32)
        repl = par.NamedSharding(mesh, par.PartitionSpec()).shard(x)
        shard = par.NamedSharding(mesh, par.PartitionSpec("dp")).shard(x)
        memory.tag_role(repl, "parameter")
        memory.tag_role(shard, "optimizer_state")
        mine = memory.live_census(arrays=[repl, shard])
        theirs = jmemory.live_census(arrays=[jrepl, jshard])
    finally:
        mesh.close()
    assert mine["by_device"] == theirs["by_device"]
    assert mine["by_role"] == theirs["by_role"]
    assert len(mine["by_device"]) == 8
    assert mine["by_device"]["cpu:3"]["by_role"] == {
        "parameter": 64 * 32 * 4, "optimizer_state": 64 * 32 * 4 // 8}


def test_framework_seams_tag_roles():
    """Parameter init, attach_grad, the optimizer Updater, DataIter
    batches and the executor's gradients stamp the census roles."""
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(4, in_units=8)
        net.initialize()
        assert memory.role_of(net.weight.data()) == "parameter"
        assert memory.role_of(net.weight.data().grad) == "gradient"
        w = tmx.nd.array(np.ones((4, 4), np.float32))
        g = tmx.nd.array(np.ones((4, 4), np.float32))
        upd = tmx.optimizer.get_updater(tmx.optimizer.SGD(
            momentum=0.9, learning_rate=0.1))
        upd(0, g, w)
        assert memory.role_of(upd.states[0]) == "optimizer_state"
        assert memory.role_of(w) == "parameter"
        assert memory.role_of(g) == "gradient"
        batch = next(tmx.io.NDArrayIter(np.zeros((8, 4), np.float32),
                                        np.zeros((8,), np.float32),
                                        batch_size=4))
        assert memory.role_of(batch.data[0]) == "io_buffer"
        assert memory.role_of(batch.label[0]) == "io_buffer"
        out = tmx.sym.FullyConnected(tmx.sym.var("data"), tmx.sym.var("w"),
                                     num_hidden=4, no_bias=True, name="fc")
        ex = out.simple_bind(tmx.cpu(), data=(2, 8), grad_req="write")
        assert all(memory.role_of(x) == "gradient"
                   for x in ex.grad_dict.values())
        ex.forward(is_train=True)
        ex.backward()
        assert all(memory.role_of(x) == "gradient"
                   for x in ex.grad_dict.values())


def test_census_disabled_skips_tagging(monkeypatch):
    monkeypatch.setattr(memory, "_census", [False])
    a = torch.ones(8, 8)
    memory.tag_role(a, "parameter")
    assert memory.role_of(a) is None
    doc = memory.live_census()
    assert doc.get("disabled") is True and doc["arrays"] == 0
    assert memory.live_census(arrays=[a])["arrays"] == 1
    reg = tmx.telemetry.registry()
    tmx.telemetry._memory_census_collector(reg)   # no crash, no series


def _trainer_arrays(mx, net, trainer):
    """The Trainer flow's parameters, gradients and optimizer states."""
    params = list(net.collect_params().values())
    states = trainer._updaters.states
    return ([p.data() for p in params] + [p.grad() for p in params]
            + [states[k] for k in sorted(states)])


def test_trainer_census_equals_the_jax_packages():
    docs = []
    for mx in (tmx, jmx):
        x, y = oh.data(16)
        with oh.scope(mx):
            net = mx.gluon.nn.Dense(4, in_units=8, prefix="census_")
            net.initialize(mx.initializer.Zero())
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": 0.01})
            with mx.autograd.record():
                loss = ((net(mx.nd.array(x)) - mx.nd.array(y)) ** 2).mean()
            loss.backward()
            trainer.step(16)
        lib = memory if mx is tmx else jmemory
        docs.append(lib.live_census(arrays=_trainer_arrays(mx, net,
                                                           trainer)))
    assert _roles(docs[0]) == _roles(docs[1]) == {
        "parameter": (36 * 4, 2), "gradient": (36 * 4, 2),
        "optimizer_state": (2 * 36 * 4, 4)}


def test_module_fit_census_equals_the_jax_packages():
    docs = []
    for mx in (tmx, jmx):
        mod = oh.module_fit(mx, epochs=1)
        ex = mod._exec
        arrays = ([ex.arg_dict[n] for n in ("fc_weight", "fc_bias")]
                  + [ex.grad_dict[n] for n in ("fc_weight", "fc_bias")]
                  + [s for s in mod._opt_states if s is not None])
        lib = memory if mx is tmx else jmemory
        docs.append(lib.live_census(arrays=arrays))
    # explicit arrays: both classify exactly these, activation included
    # (by bytes: the port's momentum-free SGD keeps empty states where
    # the JAX one keeps None)
    assert {r: v["bytes"] for r, v in docs[0]["by_role"].items()} == \
        {r: v["bytes"] for r, v in docs[1]["by_role"].items()}
    assert docs[0]["by_role"]["gradient"]["bytes"] == (4 * 8 + 4) * 4


def test_zero3_census_per_position_equals_the_jax_packages():
    import jax
    from jax.sharding import Mesh
    from mxnet_tpu.parallel import make_zero_train_step as jzero
    from mxnet_tpu_torch import parallel as par

    rs = np.random.RandomState(0)
    params = {"w": rs.normal(0, .3, (16, 8)).astype(np.float32),
              "b": np.zeros(8, np.float32)}
    x = rs.normal(size=(16, 16)).astype(np.float32)
    y = rs.normal(size=(16, 8)).astype(np.float32)

    def loss(p, b):
        return ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean()
    jmesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    tmesh = par.create_mesh({"dp": 4}, devices=["cpu"] * 4)
    try:
        docs = []
        for make, mesh, lib in ((par.make_zero_train_step, tmesh, memory),
                                (jzero, jmesh, jmemory)):
            step, p, s = make(loss, mesh, params, (x, y), stage=3,
                              batch_specs=(par.PartitionSpec("dp"),
                                           par.PartitionSpec("dp"))
                              if lib is memory else None)
            p, s, _ = step(p, s, (x, y))
            docs.append(lib.live_census(arrays=[p, s]))
    finally:
        tmesh.close()
    assert _devices(docs[0]) == _devices(docs[1])
    assert _roles(docs[0]) == _roles(docs[1])
    per = docs[0]["by_device"]["cpu:1"]["by_role"]
    assert per["parameter"] == (16 * 8 + 8) * 4 // 4


def test_kv_cache_census_equals_the_jax_packages():
    from mxnet_tpu.serving.generate import BlockPool as JPool
    from mxnet_tpu_torch.serving.generate import BlockPool
    pool = BlockPool(2, 2, 8, 4, 8, device="cpu")
    jpool = JPool(num_layers=2, num_heads=2, head_dim=8, block_tokens=4,
                  max_blocks=8)
    assert memory.role_of(pool.k) == memory.role_of(pool.v) == "kv_cache"
    mine = memory.live_census(arrays=[pool.k, pool.v])
    theirs = jmemory.live_census(arrays=[jpool.k, jpool.v])
    assert _roles(mine) == _roles(theirs) == {
        "kv_cache": (pool.bytes_total, 2)}
    assert pool.bytes_total == jpool.bytes_total


def test_generator_lane_census_and_oom_postmortem_name_the_kv_cache():
    """A registered generator's lane pool in the whole-process census and
    in an OOM postmortem's census, by its bytes."""
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder
    dec = GenerativeDecoder(vocab_size=32, d_model=16, num_layers=1,
                            num_heads=2, max_prompt_tokens=8, device="cpu")
    gw = Gateway(device="cpu")
    try:
        gen = gw.register_generator("lm", dec, block_tokens=4, max_blocks=8,
                                    max_new_tokens=4, max_decode_batch=2)
        pool = gen.lanes[0].pool
        doc = memory.live_census()
        assert doc["by_role"]["kv_cache"]["bytes"] >= pool.bytes_total
        err = RuntimeError("RESOURCE_EXHAUSTED: Out of memory")
        assert memory.maybe_oom_postmortem(err, source="decode_step")
        with open(os.environ["MXTPU_OOM_DUMP_PATH"]) as f:
            saved = json.load(f)
        assert saved["census"]["by_role"]["kv_cache"]["bytes"] >= \
            pool.bytes_total
    finally:
        gw.close()


def test_census_collector_and_cpu_backfill():
    """Per-position gauges for a tagged mesh value, each position's
    ``mx_device_mem_bytes_in_use`` backfilled from the census, and both
    back to 0 once the value is freed."""
    from mxnet_tpu_torch import parallel as par
    mesh = par.create_mesh({"dp": 8}, devices=["cpu"] * 8)
    try:
        big = par.NamedSharding(mesh, par.PartitionSpec("dp")).shard(
            torch.ones(1024, 64))
        memory.tag_role(big, "probe_shard")
        snap = tmx.telemetry.snapshot()["metrics"]
        shard_bytes = 1024 * 64 * 4 // 8
        probe = {s["labels"]["device"]: s["value"]
                 for s in snap["mx_memory_live_bytes"]["series"]
                 if s["labels"]["role"] == "probe_shard"}
        assert probe == {"cpu:%d" % i: shard_bytes for i in range(8)}
        used = {s["labels"]["device"]: s["value"]
                for s in snap["mx_device_mem_bytes_in_use"]["series"]}
        assert all(used["cpu:%d" % i] >= shard_bytes for i in range(8))
        counts = {s["labels"]["role"]: s["value"]
                  for s in snap["mx_memory_live_arrays"]["series"]}
        assert counts["probe_shard"] == 1
        del big
        gc.collect()
        snap = tmx.telemetry.snapshot()["metrics"]
        assert all(s["value"] == 0
                   for s in snap["mx_memory_live_bytes"]["series"]
                   if s["labels"]["role"] == "probe_shard")
    finally:
        mesh.close()


def test_chrome_trace_memory_counter_track():
    a = torch.ones(64, 64)
    memory.tag_role(a, "parameter")
    trace = tmx.telemetry.export.merge_chrome_trace(
        spans=[], memory=memory.live_census(arrays=[a]))
    stacked = [e for e in trace["traceEvents"]
               if e.get("name") == "mx_memory_live_bytes"]
    assert stacked[0]["args"]["parameter"] == 64 * 64 * 4
    assert trace["metadata"]["memory"]["total_bytes"] == 64 * 64 * 4
    assert [e for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("pid") == 91]
    assert tmx.telemetry.export.merge_chrome_trace(spans=[], memory=True)


def test_is_oom_error_classification_equals_the_jax_packages():
    cases = [RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating"),
             RuntimeError("Allocation failure"),
             RuntimeError("OOM when allocating"),
             RuntimeError("shape mismatch"),
             FileNotFoundError("no checkpoint at /models/BLOOM-7b/params"),
             RuntimeError("CUDA out of memory. Tried to allocate 2 GiB")]
    assert [memory.is_oom_error(e) for e in cases] == \
        [jmemory.is_oom_error(e) for e in cases] == \
        [True, True, True, False, False, True]
    assert not memory.is_oom_error(None)
    assert memory.is_oom_error(torch.cuda.OutOfMemoryError("x"))


def test_oom_postmortem_keys_equal_the_jax_packages(tmp_path):
    """The same keys as the JAX artifact, without a program and with
    one (the ranked peak-liveness table, ``memory_ledger``)."""
    import jax
    import jax.numpy as jnp
    a = torch.ones(64, 64)
    memory.tag_role(a, "parameter")
    ja = jnp.ones((64, 64))
    jmemory.tag_role(ja, "parameter")
    err = RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 9")
    mine = memory.oom_postmortem(err, source="seam",
                                 path=str(tmp_path / "a.json"))
    theirs = jmemory.oom_postmortem(err, source="seam",
                                    path=str(tmp_path / "b.json"))
    assert set(mine) == set(theirs)
    trace, _ = tmx.profiling.optrace.record(lambda t: (t * 2).sum(), a)
    mine_p = memory.oom_postmortem(err, source="seam", hlo_text=trace,
                                   path=str(tmp_path / "c.json"))
    theirs_p = jmemory.oom_postmortem(
        err, source="seam", path=str(tmp_path / "d.json"),
        hlo_text=jax.jit(lambda t: (t * 2).sum()).lower(ja).compile()
        .as_text())
    assert set(mine_p) == set(theirs_p) == set(theirs) | {"memory_ledger"}
    assert set(mine_p["memory_ledger"]) >= \
        set(theirs_p["memory_ledger"]) - {"xla_memory_analysis",
                                          "peak_vs_xla"}
    saved = json.loads((tmp_path / "a.json").read_text())
    assert saved["kind"] == "oom_postmortem" and saved["source"] == "seam"
    assert saved["census"]["by_role"]["parameter"]["bytes"] >= 64 * 64 * 4
    assert "flight" in saved
    # a non-OOM error writes nothing; a burst coalesces
    assert memory.maybe_oom_postmortem(RuntimeError("shape"), "x") is None
    assert memory.maybe_oom_postmortem(err, "x") is not None
    assert memory.maybe_oom_postmortem(err, "x") is None


def _raise_oom(*a, **k):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 1024.00 GiB")


@pytest.mark.parametrize("seam", ["executor_forward", "executor_backward",
                                  "trainer_step", "sharded_train_step"])
def test_oom_seams_write_the_postmortem_and_propagate(seam, monkeypatch):
    path = os.environ["MXTPU_OOM_DUMP_PATH"]
    with tmx.cpu():
        if seam.startswith("executor"):
            out = tmx.sym.FullyConnected(tmx.sym.var("data"),
                                         num_hidden=4, name="fc")
            ex = out.simple_bind(tmx.cpu(), data=(2, 8))
            if seam == "executor_backward":
                ex.forward(is_train=True)
                monkeypatch.setattr(ex, "_backward", _raise_oom)
                run = ex.backward
            else:
                monkeypatch.setattr(ex, "_forward", _raise_oom)
                run = ex.forward
        elif seam == "trainer_step":
            net = tmx.gluon.nn.Dense(4, in_units=8)
            net.initialize()
            trainer = tmx.gluon.Trainer(net.collect_params(), "sgd")
            monkeypatch.setattr(trainer, "_update", _raise_oom)

            def run():
                trainer.step(1)
        else:
            from mxnet_tpu_torch import parallel as par
            from mxnet_tpu_torch.parallel import train_step as ts
            mesh = par.create_mesh({"dp": 1}, devices=["cpu"])
            w = np.ones((4, 2), np.float32)
            step, p, o = par.make_sharded_train_step(
                lambda p, b: (b @ p["w"]).mean(), mesh, {"w": w},
                np.ones((2, 4), np.float32))
            monkeypatch.setattr(ts, "run_shards", _raise_oom)

            def run():
                try:
                    step(p, o, np.ones((2, 4), np.float32))
                finally:
                    mesh.close()
        with pytest.raises(torch.cuda.OutOfMemoryError):
            run()
    with open(path) as f:
        saved = json.load(f)
    assert saved["source"] == seam
    assert saved["error_type"] == "OutOfMemoryError"
    assert {"census", "device_stats", "flight"} <= set(saved)


def _chain(x):
    return torch.relu(x * 2) + 1


def _chain_x():
    return torch.ones(16, 16)


def _analyze_dir(trace, doc, path):
    run = tmx.profiling.attribution_run(
        _chain, (_chain_x(),), steps=1, profile_dir=os.path.dirname(path))
    return tmx.profiling.analyze_dir(run["profile_file"], compiled=_chain,
                                     args=(_chain_x(),), steps=1)


def _load(trace, doc, path):
    memory.dump(doc, path)
    return memory.load(path)


_LEDGER_CALLS = {
    "memory.buffer_intervals": lambda tr, d, p: memory.buffer_intervals(tr),
    "memory.build_memory_ledger":
        lambda tr, d, p: memory.build_memory_ledger(tr),
    "memory.from_compiled": lambda tr, d, p: memory.from_compiled(
        _chain, args=(_chain_x(),)),
    "memory.from_fn": lambda tr, d, p: memory.from_fn(_chain, _chain_x()),
    "memory.summarize": lambda tr, d, p: memory.summarize(d),
    "memory.diff": lambda tr, d, p: memory.diff(d, d),
    "memory.load": _load,
    "memory.dump": lambda tr, d, p: memory.dump(d, p),
    "profiling.analyze_dir": _analyze_dir,
    "profiling.attribution_run":
        lambda tr, d, p: tmx.profiling.attribution_run(
            _chain, (_chain_x(),), steps=1, profile_dir=os.path.dirname(p)),
    "profiling.build_ledger": lambda tr, d, p: tmx.profiling.build_ledger(tr),
    "profiling.from_compiled":
        lambda tr, d, p: tmx.profiling.from_compiled(_chain,
                                                     args=(_chain_x(),)),
    "profiling.from_fn": lambda tr, d, p: tmx.profiling.from_fn(
        _chain, _chain_x()),
    "profiling.mfu_estimate": lambda tr, d, p: tmx.profiling.mfu_estimate(
        tmx.profiling.build_ledger(tr)),
    "profiling.build_memory_ledger":
        lambda tr, d, p: tmx.profiling.build_memory_ledger(tr),
    "export.merge_chrome_trace": lambda tr, d, p:
        tmx.telemetry.export.merge_chrome_trace(
            spans=[], attribution=tmx.profiling.build_ledger(tr)),
}


@pytest.mark.parametrize("name", sorted(_LEDGER_CALLS))
def test_liveness_and_cost_ledger_names_work(name, tmp_path):
    """Every name that refused before the cost ledger's port (the
    liveness ledger, the cost ledger and its capture, the attribution
    strip) answers on a small chain: x * 2, relu, + 1 of a 16 x 16 f32
    input, whose peak holds the input, the product and the relu (3 x
    1 KiB)."""
    trace, _ = tmx.profiling.optrace.record(_chain, _chain_x())
    doc = memory.build_memory_ledger(trace)
    assert doc["peak_live_bytes"] == 3 * 16 * 16 * 4
    got = _LEDGER_CALLS[name](trace, doc, str(tmp_path / "doc.json"))
    assert got is not None
    if isinstance(got, dict) and "kind" in got:
        assert got["kind"] in ("memory_ledger", "cost_ledger",
                               "mfu_attribution", None) or \
            "traceEvents" in got
    if isinstance(got, dict) and got.get("kind") in ("cost_ledger",
                                                      "mfu_attribution"):
        assert got["totals"]["flops"] == 3 * 16 * 16
