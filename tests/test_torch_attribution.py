"""The port's measured side (``profiling.capture``, ``profiling.xplane``,
``profiler.set_config(xla_trace_dir=)`` / ``op_attribution``, the
attribution strip of ``merge_chrome_trace``) and
``parallel.collectives_summary``, on the CPU (tests/test_profiling.py
and tests/test_parallel.py are the JAX package's):

- ``attribution_run`` over a LeNet-sized training step: a measured row
  for every framework op of the step, forward and backward, the explicit
  ``_unattributed`` row, the JAX document's reconciliation fields, and no
  row claiming more than the step's busy window;
- a Kineto trace's kernels are named by the scope their launch ran in;
- the capture of ``profiler.set_config(xla_trace_dir=)`` joins through
  ``op_attribution``, and ``merge_chrome_trace(attribution=)`` folds the
  strip;
- ``collectives_summary`` of a dp 2 ZeRO-2 step's collectives, and of
  HLO text as the JAX package reads it.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import layout as jlayout
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.parallel.mesh import PartitionSpec as P
from mxnet_tpu_torch.profiling import capture, xplane


def _lenet_step():
    """LeNet (two conv / pool stages, two FC layers) bound for training
    at batch 4 on 28 x 28, with an SGD-momentum update of each weight:
    the step and its framework ops."""
    data = tmx.sym.var("data")
    net = tmx.sym.Convolution(data, kernel=(5, 5), num_filter=6, name="c1")
    net = tmx.sym.Activation(net, act_type="tanh")
    net = tmx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2))
    net = tmx.sym.Convolution(net, kernel=(5, 5), num_filter=16, name="c2")
    net = tmx.sym.Activation(net, act_type="tanh")
    net = tmx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2))
    net = tmx.sym.FullyConnected(tmx.sym.flatten(net), num_hidden=32,
                                 name="f1")
    net = tmx.sym.FullyConnected(net, num_hidden=10, name="f2")
    net = tmx.sym.SoftmaxOutput(net, name="softmax")
    ex = net.simple_bind(tmx.cpu(), data=(4, 1, 28, 28),
                         softmax_label=(4,), grad_req="write")
    rng = np.random.default_rng(0)
    for n, a in ex.arg_dict.items():
        a[:] = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
    ex.arg_dict["softmax_label"][:] = np.arange(4, dtype=np.float32)
    weights = [n for n in ex.arg_dict if n.endswith("weight")]
    moms = {n: tmx.nd.zeros(ex.arg_dict[n].shape, ctx=tmx.cpu())
            for n in weights}

    def step():
        ex.forward(is_train=True)
        ex.backward()
        for n in weights:
            tmx.nd.sgd_mom_update(ex.arg_dict[n], ex.grad_dict[n], moms[n],
                                  lr=0.01, momentum=0.9,
                                  out=ex.arg_dict[n])
        return ex.outputs[0]
    ops = {"Convolution", "Activation", "Pooling", "FullyConnected",
           "SoftmaxOutput", "flatten", "sgd_mom_update"}
    return step, ops


def test_attribution_run_lenet_step(tmp_path):
    step, ops = _lenet_step()
    doc = capture.attribution_run(step, steps=2, profile_dir=str(tmp_path))
    assert doc["kind"] == "mfu_attribution"
    measured = {g["op"]: g for g in doc["by_op"]}
    for op in ops - {"flatten"}:
        assert measured[op].get("measured_s", 0) > 0, op
    rows = {r["instr"]: r for r in doc["rows"]}
    for inst in ("Convolution#0", "Convolution#0.bwd", "Convolution#1.bwd",
                 "FullyConnected#1.bwd", "SoftmaxOutput#0.bwd",
                 "sgd_mom_update#3/fused_sgd_mom"):
        assert rows[inst].get("measured_s", 0) > 0, inst
        assert rows[inst]["measured_count"] >= 2, inst  # its CPU ops
    assert measured["sgd_mom_update"]["flops"] == 7 * sum(
        r["flops"] // 7 for r in doc["rows"]
        if r["hlo_op"] == "fused_sgd_mom")
    assert "_unattributed" in measured
    assert measured["_unattributed"]["flops"] == 0
    rec = doc["reconciliation"]
    assert set(rec) == {"step_wall_s", "attributed_s", "named_s", "ratio",
                        "idle_s"}
    assert rec["named_s"] <= rec["attributed_s"] + 1e-6
    assert doc["reconciled"] == (rec["ratio"] >= 0.9)
    window = doc["measured"]["device_window_s_per_step"]
    assert all(r.get("measured_s", 0) <= window + 1e-6 for r in doc["rows"])
    assert sum(g.get("measured_s", 0) for g in doc["by_op"]) <= \
        window + 1e-5
    assert doc["mfu"] >= 0 and doc["lost"] == {}
    json.dumps(doc, allow_nan=False)


def test_kineto_kernels_named_by_their_launch_scope():
    """A card's capture: each kernel takes the innermost scope around its
    runtime launch (the hand kernel's region inside it), else the aten op
    that launched it, else its own name; memcpy / memset count in the
    window."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "mx.FC#0",
         "pid": 1, "tid": 7, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "mx:flash_attention",
         "pid": 1, "tid": 7, "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
         "pid": 1, "tid": 7, "ts": 40.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add_",
         "pid": 1, "tid": 7, "ts": 200.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 12.0, "dur": 2.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 41.0, "dur": 2.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 201.0, "dur": 2.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "flash_attention_kernel<64>",
         "pid": 0, "tid": 7, "ts": 50.0, "dur": 30.0,
         "args": {"correlation": 1, "device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "sm90_gemm",
         "pid": 0, "tid": 7, "ts": 80.0, "dur": 10.0,
         "args": {"correlation": 2, "device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
         "pid": 0, "tid": 7, "ts": 210.0, "dur": 5.0,
         "args": {"correlation": 3, "device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "pid": 0, "tid": 8, "ts": 300.0, "dur": 4.0,
         "args": {"device": 0, "stream": 8}},
    ]
    planes = xplane.parse_kineto({"traceEvents": ev})
    (plane,) = planes
    assert plane["name"] == "/device:GPU:0"
    names = sorted(plane["event_metadata"].values())
    assert names == ["FC#0", "FC#0/flash_attention", "Memcpy HtoD", "add_"]
    m = xplane.measure_ops(planes, {"FC#0/flash_attention", "FC#0",
                                    "add_"})
    assert m["ops"]["FC#0/flash_attention"]["self_s"] == pytest.approx(
        30e-6)
    assert m["ops"]["FC#0"]["self_s"] == pytest.approx(10e-6)
    assert m["covered_s"] == pytest.approx(45e-6)
    assert m["window_s"] == pytest.approx(49e-6)
    lost = capture.lost_records(planes, {"flash_attention": 2,
                                         "flash_attention_bwd": 0})
    assert lost == {"flash_attention": {"launches": 2, "events": 1,
                                        "lost": 1}}


def test_profiler_capture_joins_through_op_attribution(tmp_path):
    step, ops = _lenet_step()
    step()
    profiler.set_config(xla_trace_dir=str(tmp_path))
    try:
        profiler.set_state("run")
        tmx.telemetry.step.step_boundary("attribution_test")
        step()
    finally:
        profiler.set_state("stop")
        profiler.set_config(xla_trace_dir=None)
    assert profiler.last_xplane_dir() == str(tmp_path)
    doc = profiler.op_attribution(compiled=step, steps=1)
    got = {g["op"] for g in doc["by_op"] if g.get("measured_s", 0) > 0}
    assert ops - {"flatten"} <= got
    trace = tmx.telemetry.export.merge_chrome_trace(
        events=[], spans=[], attribution=doc)
    strip = [e for e in trace["traceEvents"] if e.get("pid") == 90
             and e["ph"] == "X"]
    assert [e["name"] for e in strip] == [
        g["op"] for g in doc["by_op"]
        if (g.get("measured_s") or g.get("est_s") or 0) > 0]
    assert trace["metadata"]["attribution"]["kind"] == "mfu_attribution"
    assert "reconciliation" not in trace["metadata"]["attribution"]


def test_card_ledger_with_a_host_only_capture_raises(tmp_path):
    """A ledger whose program ran on the card, joined with a capture that
    holds only host events (no ``/device:GPU`` plane), is refused by
    ``join``, ``analyze_dir`` and ``op_attribution`` alike: host op times
    are never reported as the card's."""
    x = tmx.nd.array(np.ones((4, 4), np.float32), ctx=tmx.cpu())
    doc = tmx.profiling.from_fn(lambda: tmx.nd.dot(x, x))
    assert doc["device"] == "cpu"
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
           "tid": 7, "ts": 0.0, "dur": 10.0}]
    path = tmp_path / "host.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    planes = xplane.load_xspace(str(path))
    assert [p["name"] for p in planes] == ["/device:CPU:0"]
    capture.join(doc, planes, step_wall_s=1e-3, steps=1)   # a host program
    card = dict(doc, device="cuda")
    with pytest.raises(tmx.base.MXNetError, match="/device:GPU"):
        capture.join(card, planes, step_wall_s=1e-3, steps=1)
    with pytest.raises(tmx.base.MXNetError, match="/device:GPU"):
        capture.analyze_dir(str(tmp_path), compiled=card, steps=1)
    with pytest.raises(tmx.base.MXNetError, match="/device:GPU"):
        profiler.op_attribution(compiled=card, profile_dir=str(tmp_path),
                                steps=1)


def test_idle_seams_enter_no_scope_and_price_nothing(monkeypatch):
    """With no recorder or capture active, an eager op, an executor node
    and a hand kernel's wrapper run straight through: no scope is opened
    and no call is priced."""
    from mxnet_tpu_torch.ops import attention, fused_opt
    from mxnet_tpu_torch.profiling import optrace

    def refuse(*args, **kwargs):
        raise AssertionError("the idle path reached the op trace")
    monkeypatch.setattr(optrace, "scoped", refuse)
    monkeypatch.setattr(optrace, "pricing", refuse)
    monkeypatch.setattr(optrace, "priced_call", refuse)
    assert optrace.ACTIVE[0] == 0
    step, _ = _lenet_step()
    step()
    q = torch.ones((1, 2, 8, 4))
    attention.flash_attention(q, q, q, causal=True)
    w = torch.ones(8)
    fused_opt.fused_sgd_mom(w, w.clone(), torch.zeros(8), lr=0.1,
                            momentum=0.9)


_COLLECTIVE_HLO = """\
HloModule zero, entry_computation_layout={(f32[16,4]{1,0})->f32[16,4]}

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main (g: f32[16,4]) -> f32[16,4] {
  %g = f32[16,4]{1,0} parameter(0)
  %rs = f32[8,4]{1,0} reduce-scatter(f32[16,4]{1,0} %g), dimensions={0}, to_apply=%add
  %ag = f32[16,4]{1,0} all-gather(f32[8,4]{1,0} %rs), dimensions={0}
  %ar = f32[16,4]{1,0} all-reduce-start(f32[16,4]{1,0} %ag), to_apply=%add
  ROOT %d = f32[16,4]{1,0} all-reduce-done(f32[16,4]{1,0} %ar)
}
"""


def test_collectives_summary_of_hlo_text_is_the_jax_packages():
    assert par.collectives_summary(_COLLECTIVE_HLO) == \
        jlayout.collectives_summary(_COLLECTIVE_HLO)


def test_collectives_summary_of_a_zero2_step():
    """A dp 2 ZeRO-2 step: each gradient reduce-scattered and each
    updated slice all-gathered, counted and sized as the run moved
    them (one rank's output a collective)."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(0, 0.3, (16, 4)).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    batch = (rng.normal(0, 1, (8, 16)).astype(np.float32),
             rng.normal(0, 1, (8, 4)).astype(np.float32))

    def loss(p, b):
        return ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean()
    mesh = par.create_mesh({"dp": 2}, devices=["cpu"] * 2)
    try:
        step, p, s = par.make_zero_train_step(
            loss, mesh, params, batch, batch_specs=(P("dp"), P("dp")),
            lr=0.1, momentum=0.9, stage=2)
        p, s, _ = step(p, s, batch)
        summary = par.collectives_summary(step)
        assert summary == par.collectives_summary(mesh)
    finally:
        mesh.close()
    kinds = {"allreduce": "all-reduce", "allgather": "all-gather",
             "reduce_scatter": "reduce-scatter"}
    assert {kinds[k]: n for k, n in step.last_collectives.items()} == \
        {k: r["count"] for k, r in summary["by_op"].items()}
    assert summary["total"] == sum(step.last_collectives.values())
    assert summary["by_op"]["reduce-scatter"]["count"] >= 1
    assert summary["by_op"]["all-gather"]["count"] >= 1
    for row in summary["by_op"].values():
        assert row["bytes"] == sum(
            4 * int(np.prod([int(d) for d in s[4:-1].split(",") if d]))
            for s in row["shapes"])
        assert all(s.startswith("f32[") for s in row["shapes"])
