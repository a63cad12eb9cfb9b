"""The port's model-health plane (``mxnet_tpu_torch.profiling.health``)
against the JAX package's (tests/test_health.py): sentry counts by
source, the fold lag and the raise policy at the boundary, the first-op
localizer on forward-born NaNs and the seam of a backward-born one, a
poisoned-lr training run, the loss anomalies, the drift fingerprints
(byte-equal to the JAX package's for the same weights), the probe's
counts and norms against a plain numpy recomputation, the norm gate,
the sharded-step and ``Module.fit`` seams, the reports
(``tools/health_report.py`` table, ``--diff`` and ``--postmortem`` over
the port's documents), the chrome-trace health track, and equal host
reads (``Tensor.item`` / ``tolist`` / ``cpu``, ``torch.cuda.synchronize``)
with the plane on and off. The JAX package's overhead bound is left out
(ROADMAP queue 3 lists it as unsettled in the reference).
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.profiling import health as jhealth
from mxnet_tpu_torch.profiling import health

import observability_harness as oh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEALTH_REPORT = os.path.join(REPO, "tools", "health_report.py")
BOTH = (health, jhealth)


@pytest.fixture(autouse=True)
def _fresh_health(tmp_path, monkeypatch):
    """Both planes clean, warn policy, norms on, a private postmortem
    path; the policies put back after (a process runs other files)."""
    monkeypatch.setenv("MXTPU_HEALTH_DUMP_PATH", str(tmp_path / "pm.json"))
    saved = [(h, h._policy[0], h._norms[0]) for h in BOTH]
    for h in BOTH:
        h.reset()
        h.set_enabled(True)
        h.set_norms_enabled(True)
    oh.reset_both()
    yield
    for h, pol, norms in saved:
        h.reset()
        h._policy[0] = pol
        h._norms[0] = norms
    oh.reset_both()


def _pm():
    with open(os.environ["MXTPU_HEALTH_DUMP_PATH"]) as f:
        return json.load(f)


def _leaf(h, a):
    """``a`` as the package's device value."""
    if h is health:
        return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))
    import jax.numpy as jnp
    return jnp.asarray(a)


NAN, INF = float("nan"), float("inf")


# -- the sentry -------------------------------------------------------------
def test_sentry_counts_per_source_equal_the_jax_packages():
    docs = []
    for h in BOTH:
        h.check("a", [_leaf(h, np.array([1.0, NAN], np.float32))])
        h.check("b", [_leaf(h, np.array([INF, -INF], np.float32)),
                      _leaf(h, np.arange(4))])
        h.check("a", [_leaf(h, np.array([NAN], np.float32))])
        h.check("clean", [_leaf(h, np.ones((4,), np.float32))])
        h.check("ints", [_leaf(h, np.arange(4))])
        docs.append(h.flush()["sentry"])
    mine, theirs = docs
    assert mine["by_source"] == theirs["by_source"] == {"a": 2, "b": 2}
    assert mine["verdict"] == theirs["verdict"] == "nonfinite"
    assert mine["first_trip"]["source"] == theirs["first_trip"]["source"]
    assert _pm()["kind"] == "nan_postmortem"


def test_sentry_disabled_is_noop():
    health.set_enabled(False)
    health.check("unit", [torch.tensor([NAN])])
    health.observe_loss(NAN)
    assert health.step_boundary("t") is None
    doc = health.snapshot_doc()
    assert doc["sentry"]["verdict"] == "disabled"
    assert doc["sentry"]["nonfinite_total"] == 0


def test_fold_lag_equals_the_jax_packages():
    """A count folds _FOLD_LAG + 1 boundaries after its launch, in both
    packages (on the CPU every banked copy has landed)."""
    assert health._FOLD_LAG == jhealth._FOLD_LAG == 4
    seen = {}
    for h in BOTH:
        h.check("lagged", [_leaf(h, np.array([NAN], np.float32))])
        totals = []
        for _ in range(h._FOLD_LAG + 2):
            h.step_boundary("t")
            totals.append(h.snapshot_doc(fold=False)["sentry"][
                "nonfinite_total"])
        seen[h] = totals
    assert seen[health] == seen[jhealth] == [0, 0, 0, 0, 1, 1]


def test_fold_waits_for_a_copy_in_flight_and_never_blocks():
    """An entry old enough whose copy has not landed waits for a later
    boundary (its step is kept); flush() is the read point."""
    class InFlight:
        landed = False

        def ready(self):
            return self.landed

        def __float__(self):
            return 3.0

    entry = InFlight()
    health._state.pending.append((0, {"slow": entry}))
    for _ in range(health._FOLD_LAG + 3):
        health.step_boundary("t")
    assert health.snapshot_doc(fold=False)["sentry"]["nonfinite_total"] \
        == 0
    entry.landed = True
    health.step_boundary("t")
    doc = health.snapshot_doc(fold=False)["sentry"]
    assert doc["by_source"] == {"slow": 3}
    assert doc["first_trip"]["step"] == 0


@pytest.mark.parametrize("h", BOTH, ids=["port", "jax"])
def test_raise_policy_at_the_boundary_and_not_rearmed(h):
    h.set_enabled("raise")
    h.check("unit", [_leaf(h, np.array([NAN], np.float32))])  # no raise
    raised_at = None
    for i in range(h._FOLD_LAG + 1):
        try:
            h.step_boundary("t")
        except h.NonfiniteError as e:
            raised_at = i
            assert "unit" in str(e) and e.postmortem is not None
    assert raised_at == h._FOLD_LAG
    for _ in range(6):          # clean continuation: no re-raise
        h.step_boundary("t")
    h.check("unit", [_leaf(h, np.array([INF], np.float32))])
    with pytest.raises(h.NonfiniteError):
        for _ in range(h._FOLD_LAG + 1):
            h.step_boundary("t")


def test_trips_counter_counts_bursts():
    health.check("unit", [torch.tensor([NAN])])
    health.flush()
    health._state.last_postmortem = -10.0   # age out the burst window
    health.check("unit", [torch.tensor([NAN])])
    health.flush()
    assert tmx.telemetry.registry().value("mx_health_trips_total") == 2


# -- the first-op localizer -------------------------------------------------
def _poisoned(mx, grad_req="null"):
    """data -> fc -> log (NaN on fc's negative outputs) -> relu."""
    s = mx.sym
    out = s.Activation(s.log(s.FullyConnected(
        s.var("data"), name="fc", num_hidden=4), name="poison_log"),
        name="relu", act_type="relu")
    with oh.scope(mx):
        return out.bind(mx.cpu() if mx is tmx else None, args={
            "data": mx.nd.ones((2, 3)),
            "fc_weight": mx.nd.array(-np.ones((4, 3), np.float32)),
            "fc_bias": mx.nd.zeros((4,))}, grad_req=grad_req)


def _first_op(first):
    """The localization's structure (the statistics' values aside)."""
    return {k: first[k] for k in ("index", "tensor", "node", "op",
                                  "named_scope", "internals", "probes")}, \
        [(i["name"], i.get("nonfinite")) for i in first["inputs"]], \
        first["output"]["nonfinite"]


def test_forward_born_nan_names_the_jax_packages_first_op():
    got = {}
    for mx, h in ((tmx, health), (jmx, jhealth)):
        h.reset()
        ex = _poisoned(mx)
        with oh.scope(mx):
            ex.forward()
        doc = h.flush()
        assert doc["sentry"]["first_trip"]["source"] == "executor_forward"
        pm = _pm()
        got[mx] = _first_op(pm["first_op"])
        assert "mx_key" in pm["rng"] and "flight" in pm
    assert got[tmx] == got[jmx]
    first, inputs, bad = got[tmx]
    assert (first["node"], first["op"], first["named_scope"]) == \
        ("poison_log", "log", "mx.log")
    assert first["probes"] <= first["internals"].bit_length() + 1
    assert inputs[0] == ("fc", 0) and bad > 0


def test_localizer_finds_the_first_not_any():
    got = []
    for mx, h in ((tmx, health), (jmx, jhealth)):
        h.reset()
        d = mx.sym.var("data")
        out = mx.sym.log(mx.sym.log(d, name="first_bad"), name="second_bad")
        with oh.scope(mx):
            ex = out.bind(mx.cpu() if mx is tmx else None, args={
                "data": mx.nd.array(-np.ones((2, 2), np.float32))},
                grad_req="null")
            ex.forward()
        h.flush()
        got.append(_pm()["first_op"]["node"])
    assert got == ["first_bad", "first_bad"]


def test_backward_born_nan_lands_on_the_same_seam():
    """sqrt'(0) is inf: every forward internal is finite, so both
    packages record the backward seam and no first op."""
    got = []
    for mx, h in ((tmx, health), (jmx, jhealth)):
        h.reset()
        sq = mx.sym.sqrt(mx.sym.var("data"), name="sq")
        with oh.scope(mx):
            ex = sq.bind(mx.cpu() if mx is tmx else None,
                         args={"data": mx.nd.zeros((2, 2))},
                         grad_req="write")
            ex.forward(is_train=True)
            ex.backward()
        doc = h.flush()
        pm = _pm()
        got.append((pm["source"], pm.get("first_op"),
                    doc["sentry"]["by_source"]))
    assert got[0] == got[1]
    assert got[0][:2] == ("executor_backward", None)


def test_localizer_slot_is_bounded_to_the_latest_payload():
    ex = _poisoned(tmx)
    with tmx.cpu():
        for _ in range(6):
            ex.forward()
            health.step_boundary("t")
    with health._state.lock:
        assert len(health._state.latest_loc) == 1
        for entry in health._state.pending:
            assert len(entry) == 2
    health.flush()
    pm = _pm()
    assert pm["first_op"]["node"] == "poison_log"
    assert pm["captured_at_step"] >= pm["step"]


# -- training flows -----------------------------------------------------------
def _tiny_fit(mx, h, epochs=2, lr=0.05, feed_loss=False, optimizer="sgd"):
    """The JAX test's gluon Dense fit: 64 rows, batch 16."""
    rs = np.random.RandomState(7)
    x = rs.rand(64, 8).astype("float32")
    y = rs.rand(64, 4).astype("float32")
    w = rs.normal(0, 0.3, (4, 8)).astype("float32")
    with oh.scope(mx):
        net = mx.gluon.nn.Dense(4, in_units=8, prefix="health_")
        net.initialize(mx.initializer.Zero())
        net.weight.set_data(mx.nd.array(w))
        trainer = mx.gluon.Trainer(net.collect_params(), optimizer,
                                   {"learning_rate": lr})
        loss_fn = mx.gluon.loss.L2Loss()
        it = mx.io.NDArrayIter(x, y, batch_size=16)
        for _ in range(epochs):
            it.reset()
            for b in it:
                with mx.autograd.record():
                    loss = loss_fn(net(b.data[0]), b.label[0])
                loss.backward()
                if feed_loss:
                    h.observe_loss(loss.mean())
                trainer.step(16)
    return net, trainer


def test_poisoned_lr_run_trips_and_raises():
    for mx, h in ((tmx, health), (jmx, jhealth)):
        h.reset()
        h.set_enabled("raise")
        with pytest.raises(h.NonfiniteError):
            _tiny_fit(mx, h, epochs=30, lr=1e30)
        pm = _pm()
        assert pm["source"].startswith(("optimizer/", "trainer_grad",
                                        "trainer_param", "executor_"))
        assert "grad_norms" in pm


def test_trainer_health_telemetry_and_span_attrs():
    _tiny_fit(tmx, health, epochs=3, feed_loss=True)
    doc = health.flush()
    assert doc["sentry"]["verdict"] == "clean"
    assert doc["loss"]["ewma"] is not None
    (g,) = doc["norms"]["by_group"].values()
    assert g["weight_norm"] > 0 and g["grad_norm"] > 0
    assert 0 < g["update_ratio"] < 10
    snap = tmx.telemetry.snapshot()["metrics"]
    for fam in ("mx_health_grad_norm", "mx_health_weight_norm",
                "mx_health_grad_norm_group", "mx_health_update_ratio",
                "mx_health_loss_ewma", "mx_health_update_to_weight"):
        assert snap[fam]["series"], fam
    steps = [s for s in tmx.tracing.spans_snapshot()
             if s["name"] == "trainer_step"]
    attrs = steps[-1]["attrs"]
    assert attrs.get("health_nonfinite") == 0
    assert "loss_ewma" in attrs and "grad_norm" in attrs


def test_trainer_norms_and_losses_equal_the_jax_packages():
    """The same fit in both packages: folded losses (EWMA), the global
    and per-group norms and the update ratios within 1e-5 relative (an
    f32 sum in another order)."""
    docs = []
    for mx, h in ((tmx, health), (jmx, jhealth)):
        h.reset()
        _tiny_fit(mx, h, epochs=2, feed_loss=True, optimizer="adam")
        docs.append(h.flush())
    mine, theirs = docs
    assert mine["sentry"] == theirs["sentry"]
    assert mine["loss"]["observed"] == theirs["loss"]["observed"] == 8
    np.testing.assert_allclose(mine["loss"]["ewma"], theirs["loss"]["ewma"],
                               rtol=1e-5)
    np.testing.assert_allclose(mine["norms"]["grad_norm"],
                               theirs["norms"]["grad_norm"], rtol=1e-5)
    (g1, r1), = mine["norms"]["by_group"].items()
    (g2, r2), = theirs["norms"]["by_group"].items()
    assert g1 == g2 == "health"
    for k in ("weight_norm", "grad_norm", "update_ratio"):
        np.testing.assert_allclose(r1[k], r2[k], rtol=1e-5)


def test_probe_values_equal_a_plain_recomputation():
    """Counts exactly and norms within 1e-5 of numpy's f64, over mixed
    shapes, dtypes and nonfinites; the update taken in the scratch."""
    rs = np.random.RandomState(3)
    shapes = [(5, 3), (7,), (2, 2, 2), (1,), (4, 4)]
    ws = [torch.from_numpy(rs.normal(size=s).astype(np.float32))
          for s in shapes]
    gs = [torch.from_numpy(rs.normal(size=s).astype(np.float32))
          for s in shapes]
    ws[1] = ws[1].to(torch.bfloat16)
    gs[1] = gs[1].to(torch.bfloat16)
    gs[2].view(-1)[3] = NAN
    gs[4].view(-1)[0] = INF
    ws[0].view(-1)[1] = -INF
    olds = health.pre_update_copy(ws)
    before = [o.clone() for o in olds]
    with torch.no_grad():
        for w, g in zip(ws, gs):
            w.sub_(0.1 * torch.nan_to_num(g, posinf=0.0, neginf=0.0))
    group_idx = (0, 0, 1, 2, 1)
    counts, norms = health.probe_values(ws, gs, olds, group_idx, True)

    def bad(ts):
        return sum(int((~np.isfinite(t.float().numpy())).sum()) for t in ts)
    assert counts.tolist() == [bad(gs), bad(ws)] == [2, 1]
    f64 = [t.double().numpy() for t in ws]
    g64 = [t.double().numpy() for t in gs]
    u64 = [(b.double() - w.double()).numpy() for b, w in zip(before, ws)]
    want = [np.sqrt(sum((g ** 2).sum() for g in g64))]
    for gi in range(3):
        idx = [i for i, x in enumerate(group_idx) if x == gi]
        wn = np.sqrt(sum((f64[i] ** 2).sum() for i in idx))
        gn = np.sqrt(sum((g64[i] ** 2).sum() for i in idx))
        un = np.sqrt(sum((u64[i] ** 2).sum() for i in idx))
        want += [wn, gn, un / max(wn, 1e-12)]
    got = norms.numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], np.array(want)[finite],
                               rtol=1e-5)


def test_pre_update_copy_reuses_one_scratch():
    ws = [torch.ones(3, 2), torch.zeros(5)]
    a = health.pre_update_copy(ws)
    b = health.pre_update_copy(ws)
    assert a[0].untyped_storage().data_ptr() == \
        b[0].untyped_storage().data_ptr()
    assert a[1].untyped_storage().data_ptr() == \
        a[0].untyped_storage().data_ptr()


def test_norms_gate_takes_no_copy(monkeypatch):
    health.set_norms_enabled(False)
    calls = []
    monkeypatch.setattr(health, "pre_update_copy",
                        lambda ws: calls.append(ws))
    _tiny_fit(tmx, health, epochs=1)
    doc = health.flush()
    assert calls == []
    assert doc["norms"]["by_group"] == {}
    assert doc["sentry"]["verdict"] == "clean"


def test_sharded_step_seam_equals_the_jax_packages():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from mxnet_tpu.parallel import make_sharded_train_step as jstep
    from mxnet_tpu_torch import parallel as par

    w = np.ones((4, 2), np.float32)
    x = np.ones((2, 4), np.float32)
    bad = x.copy()
    bad[0, 0] = INF
    docs = []
    jmesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    tmesh = par.create_mesh({"dp": 1}, devices=["cpu"])
    try:
        for h, mesh, make, lib in ((health, tmesh, par.make_sharded_train_step,
                                    torch),
                                   (jhealth, jmesh, jstep, jnp)):
            h.reset()

            def loss_fn(p, b, lib=lib):
                return ((b @ p["w"]) ** 2).mean()
            step, p, o = make(loss_fn, mesh, {"w": w}, x, lr=0.1)
            p, o, _ = step(p, o, x)
            for _ in range(h._FOLD_LAG + 2):
                p, o, _ = step(p, o, bad)
            doc = h.flush()
            docs.append((doc["sentry"]["by_source"],
                         doc["loss"]["observed"]))
    finally:
        tmesh.close()
    assert docs[0] == docs[1]
    assert docs[0][0]["sharded_train_step"] > 0


def _nan_fit(mx, epochs):
    rs = np.random.RandomState(3)
    w = rs.normal(0, 0.1, (4, 8)).astype(np.float32)
    w[0, 0] = NAN
    with oh.scope(mx):
        mod = mx.mod.Module(oh.softmax_net(mx), context=mx.cpu())
        mod.fit(oh.module_iter(mx), num_epoch=epochs,
                arg_params={"fc_weight": mx.nd.array(w),
                            "fc_bias": mx.nd.zeros((4,))},
                optimizer_params={"learning_rate": 0.1})


def test_module_fit_seams_equal_the_jax_packages():
    """A NaN weight in ``Module.fit``: the executor and updater seams'
    counts at its boundaries, as the JAX package's (one epoch: four
    boundaries, so nothing folds inside the loop)."""
    docs = []
    for mx, h in ((tmx, health), (jmx, jhealth)):
        h.reset()
        _nan_fit(mx, 1)
        doc = h.flush()
        docs.append((doc["steps"], doc["sentry"]["by_source"]))
    assert docs[0] == docs[1]
    assert docs[0][0] == 4 and docs[0][1]["executor_forward"] > 0


def test_module_fit_trip_carries_the_iterator_state():
    """A trip inside ``fit`` writes the iterator's position (its
    ``state_dict``, numpy order included) into the postmortem."""
    _nan_fit(tmx, 2)
    pm = _pm()
    assert pm["source"] == "executor_forward"
    assert pm["iter_state"]["type"] == "NDArrayIter"
    assert len(pm["iter_state"]["order"]) == 32
    assert "iter_state" not in health._context_providers


# -- loss anomalies -----------------------------------------------------------
def _anomalies(h, losses):
    h.reset()
    for v in losses:
        h.observe_loss(v)
        h.step_boundary("t")
    return h.flush()["loss"]


@pytest.mark.parametrize("case", ["spike", "plateau", "z_override"])
def test_loss_anomalies_equal_the_jax_packages(case, monkeypatch):
    if case == "plateau":
        losses = [1.0] * 80
    else:
        losses = [2.0 - 0.01 * i + (80.0 if i == 35 else 0)
                  for i in range(40)]
    if case == "z_override":
        monkeypatch.setenv("MXTPU_HEALTH_ANOMALY_Z", "1000000")
    mine, theirs = (_anomalies(h, losses) for h in BOTH)
    assert mine == theirs
    kinds = [a["kind"] for a in mine["anomalies"]]
    assert kinds == {"spike": ["spike"], "plateau": ["plateau"],
                     "z_override": []}[case]


def test_loss_anomaly_counter():
    _anomalies(health, [2.0 - 0.01 * i + (80.0 if i == 35 else 0)
                        for i in range(40)])
    assert tmx.telemetry.registry().value(
        "mx_health_loss_anomalies_total", kind="spike") == 1


# -- fingerprints ---------------------------------------------------------------
def test_fingerprint_byte_equal_to_the_jax_packages():
    import jax.numpy as jnp
    import ml_dtypes
    rs = np.random.RandomState(0)
    tree = {"x": rs.normal(size=(2, 3)).astype(np.float32),
            "y": [rs.normal(size=4).astype(np.float32), None],
            "z": {"b": np.arange(5, dtype=np.int32)},
            "h": rs.normal(size=3).astype(ml_dtypes.bfloat16)}
    with tmx.cpu():
        mine = {"x": tmx.nd.array(tree["x"]),
                "y": [torch.from_numpy(tree["y"][0]), None],
                "z": {"b": torch.from_numpy(tree["z"]["b"])},
                "h": tmx.nd.array(tree["h"])}
    theirs = {"x": jmx.nd.array(tree["x"]), "y": [jnp.asarray(
        tree["y"][0]), None], "z": {"b": jnp.asarray(tree["z"]["b"])},
        "h": jnp.asarray(tree["h"])}
    fp = health.fingerprint_params(mine)
    assert fp == jhealth.fingerprint_params(theirs) == \
        jhealth.fingerprint_params(tree) == health.fingerprint_params(tree)
    # order-independent, and value / name / shape / dtype sensitive
    assert fp == health.fingerprint_params(dict(reversed(list(
        mine.items()))))
    base = {"x": np.zeros((2, 2), np.float32)}
    fps = {health.fingerprint_params(t) for t in (
        base, {"x": np.full((2, 2), 1e-8, np.float32)},
        {"z": np.zeros((2, 2), np.float32)},
        {"x": np.zeros((4,), np.float32)},
        {"x": np.zeros((2, 2), np.float64)})}
    assert len(fps) == 5
    assert [p for p, _ in health.iter_named_leaves(tree)] == \
        [p for p, _ in jhealth.iter_named_leaves(tree)]


def test_fingerprint_of_trained_weights_carried_across():
    """A port-trained model's weights, carried into the JAX package,
    fingerprint the same there."""
    net, _ = _tiny_fit(tmx, health, epochs=1)
    params = {n: p.data() for n, p in net.collect_params().items()}
    host = {n: p.asnumpy() for n, p in params.items()}
    carried = {n: jmx.nd.array(v) for n, v in host.items()}
    assert health.fingerprint_params(params) == \
        jhealth.fingerprint_params(carried)


# -- host reads -----------------------------------------------------------------
def test_trainer_step_host_reads_equal_on_and_off():
    """The counted host reads of Trainer steps (probe, boundaries, folds)
    and of an executor forward / backward are the same with the plane on
    and off (none: the plane launches and copies, never reads)."""
    counts = {}
    for on in (True, False):
        health.reset()
        health.set_enabled(on)
        net, trainer = _tiny_fit(tmx, health, epochs=1)
        x = tmx.nd.array(np.ones((16, 8), np.float32), ctx=tmx.cpu())
        with oh.SyncCounter() as sc:
            for _ in range(health._FOLD_LAG + 2):
                with tmx.autograd.record():
                    loss = (net(x) ** 2).mean()
                loss.backward()
                health.observe_loss(loss)
                trainer.step(16)
            ex = oh.executor_flow(tmx)
            del ex
        counts[on] = sc.count
    assert counts[True] == counts[False] == 0


# -- documents and tools --------------------------------------------------------
def test_health_report_reads_the_ports_documents(tmp_path):
    _tiny_fit(tmx, health, epochs=1, feed_loss=True)
    summary = tmp_path / "health.json"
    summary.write_text(json.dumps(health.flush()))
    out = subprocess.run([sys.executable, HEALTH_REPORT, str(summary)],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "verdict clean" in out.stdout
    out = subprocess.run([sys.executable, HEALTH_REPORT, "--diff",
                          str(summary), str(summary)],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    ex = _poisoned(tmx)
    with tmx.cpu(), tmx.tracing.span("trainer_step", cat="step"):
        ex.forward()
        health.flush()
    out = subprocess.run([sys.executable, HEALTH_REPORT, "--postmortem",
                          os.environ["MXTPU_HEALTH_DUMP_PATH"]],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "FIRST offending op: log" in out.stdout
    assert "trainer_step" in out.stdout


def test_chrome_trace_health_track_and_strict_json():
    health.observe_loss(1.5)
    health.observe_loss(NAN)
    for _ in range(health._FOLD_LAG + 2):
        health.step_boundary("t")
    with tmx.tracing.span("trainer_step", cat="step"):
        trace = tmx.telemetry.export.merge_chrome_trace(spans=[],
                                                        health=True)
    names = {e["name"] for e in trace["traceEvents"]}
    assert "mx_health_nonfinite_total" in names
    assert "health" in trace["metadata"]
    assert any(e.get("ph") == "M" and "model health" in str(
        e.get("args", {}).get("name", "")) for e in trace["traceEvents"])
    json.dumps(trace, allow_nan=False)
