"""The port's per-request tail attribution
(``mxnet_tpu_torch.profiling.tailpath``) against the JAX package's
(tests/test_tailpath.py): the joiner's bins on hand-built span trees and
on the JAX package's own ``Gateway.generate`` span documents, exactly
equal through both joiners; clipping, incomplete trees, the window
filter; the aggregator (window, slow cohort, conservation, the
``mx_tail_*`` families), ``summary`` and ``dump``; the port's own
generate and one-shot trees conserving; and ``tools/tail_report.py``
rendering and diffing the port's documents. The JAX package's committed
artifact and its ``perf_gate --tail`` cases read the JAX benchmark's
files and stay with the JAX tests.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import copy
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.profiling import tailpath as jtail
from mxnet_tpu_torch.profiling import tailpath

import observability_harness as oh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAIL_REPORT = os.path.join(REPO, "tools", "tail_report.py")


@pytest.fixture(autouse=True)
def _clean():
    oh.reset_both()
    yield
    oh.reset_both()


def _span(name, span, parent, start, dur, trace=7, **attrs):
    return {"name": name, "cat": "serving", "trace": trace, "span": span,
            "parent": parent, "start_ns": start, "dur_ns": dur,
            "attrs": attrs}


def _generate_tree():
    """Root, prefill, 3 tokens and 2 recoveries (the JAX test's tree):
    every generate bin nonzero, the bins summing to the e2e exactly."""
    root = _span("serving.generate", 10, None, 0, 640, model="lm",
                 new_tokens=3, queue_cause="kv_wait")
    prefill = _span("generate.prefill", 11, 10, 0, 400, prompt_tokens=6,
                    pad_tokens=8, queue_ns=200, kv_wait_ns=50, exec_ns=160)
    tok0 = _span("generate.token", 12, 10, 380, 20, index=0,
                 interleave_ns=0, rows=1, bucket=1)
    tok1 = _span("generate.token", 13, 10, 450, 50, index=1,
                 interleave_ns=30, rows=2, bucket=4)
    rec_a = _span("generate.recover", 14, 10, 500, 40, cause="lane_lost",
                  mode="replay")
    rec_b = _span("generate.recover", 15, 10, 540, 30, cause="reclaim",
                  mode="migrate")
    tok2 = _span("generate.token", 16, 10, 600, 40, index=2,
                 interleave_ns=0, rows=1, bucket=1)
    return root, [prefill, tok0, tok1, rec_a, rec_b, tok2]


GEN_EXPECT = {"kv_wait": 50, "queue_wait": 150, "prefill_compute": 120,
              "padding_tax": 65, "sched_overhead": 90,
              "decode_compute": 65, "prefill_interleave": 30,
              "recovery": 40, "reclaim_pause": 30, "batch_hold": 0,
              "execute": 0, "reply": 0, "requeue": 0, "_unattributed": 0}


def _oneshot_tree():
    root = _span("serving.request", 20, None, 0, 500, trace=8, model="mlp",
                 attempts=2)
    return root, [
        _span("serving.queue", 21, 20, 0, 200, trace=8, hold_ns=80,
              requeue_ns=50),
        _span("serving.batch", 22, 20, 200, 30, trace=8),
        _span("serving.execute", 23, 20, 230, 200, trace=8, rows=3,
              bucket=4),
        _span("serving.reply", 24, 20, 430, 20, trace=8)]


ONESHOT_EXPECT = {"batch_hold": 80, "requeue": 50, "queue_wait": 70,
                  "sched_overhead": 30, "execute": 150, "padding_tax": 50,
                  "reply": 20, "_unattributed": 50, "kv_wait": 0,
                  "prefill_compute": 0, "prefill_interleave": 0,
                  "decode_compute": 0, "recovery": 0, "reclaim_pause": 0}


def _both(fn):
    """fn(module) for the port's and the JAX package's tailpath."""
    return fn(tailpath), fn(jtail)


# -- the joiner -----------------------------------------------------------------
@pytest.mark.parametrize("tree, expect", [(_generate_tree, GEN_EXPECT),
                                          (_oneshot_tree, ONESHOT_EXPECT)],
                         ids=["generate", "oneshot"])
def test_tree_bins_exact_and_equal_the_jax_packages(tree, expect):
    mine, theirs = _both(lambda t: t.attribute_request(*tree()))
    assert mine == theirs
    assert mine["bins"] == expect
    assert set(mine["bins"]) == set(tailpath.BINS) == set(jtail.BINS)
    assert sum(mine["bins"].values()) == mine["e2e_ns"]


def test_overstamped_events_are_clipped_never_overbill():
    root, children = _generate_tree()
    for s in children:
        for k in ("queue_ns", "kv_wait_ns", "exec_ns", "interleave_ns"):
            if k in s["attrs"]:
                s["attrs"][k] = 10 ** 12
    oroot, ochildren = _oneshot_tree()
    ochildren[0]["attrs"].update(hold_ns=10 ** 12, requeue_ns=10 ** 12)
    for r, c in ((root, children), (oroot, ochildren)):
        mine, theirs = _both(lambda t: t.attribute_request(r, c))
        assert mine == theirs
        assert sum(v for b, v in mine["bins"].items()
                   if b != "_unattributed") <= mine["e2e_ns"]


def test_incomplete_trees_skipped_and_window_filter():
    root, children = _generate_tree()
    partial = [s for s in children if s["attrs"].get("index") != 1]
    assert _both(lambda t: t.attribute_request(root, partial)) == \
        (None, None)
    assert _both(lambda t: t.join_spans([root] + partial)) == \
        (([], 1), ([], 1))
    o_root, o_children = _oneshot_tree()
    o_root = dict(o_root, start_ns=10_000)
    o_children = [dict(s, start_ns=s["start_ns"] + 10_000)
                  for s in o_children]
    spans = [root] + children + [o_root] + o_children
    mine, theirs = _both(lambda t: t.join_spans(spans, t0_ns=0,
                                                t1_ns=5_000))
    assert mine == theirs
    assert [r["kind"] for r in mine[0]] == ["generate"]


# -- the aggregator ---------------------------------------------------------------
def _fake(e2e_ns, **bins):
    full = {b: 0 for b in tailpath.BINS}
    full.update(bins)
    full["_unattributed"] = max(e2e_ns - sum(
        v for b, v in full.items() if b != "_unattributed"), 0)
    return {"kind": "generate", "model": "lm", "trace": 1, "start_ns": 0,
            "e2e_ns": e2e_ns, "bins": full, "queue_cause": "backlog"}


def _collect(t, records, window=8, slow_frac=0.25, **kw):
    agg = t.TailAggregator(window=window, slow_frac=slow_frac)
    for rec in records:
        agg.add(copy.deepcopy(rec), stage="unit")
    doc = agg.collect(**kw)
    doc.pop("created")
    return doc


def test_aggregator_equals_the_jax_packages():
    records = [_fake(i * 1000, decode_compute=i * 900, queue_wait=i * 100)
               for i in range(1, 21)]
    mine, theirs = _both(lambda t: _collect(t, records))
    assert mine == theirs
    assert mine["window"]["requests"] == 8
    assert mine["window"]["slow_requests"] == 2
    assert mine["stages"]["unit"]["requests"] == 20
    assert mine["slow"]["drivers"][0]["bin"] == "decode_compute"
    assert mine["conservation"]["conserved"] is True
    half = [_fake(1000, decode_compute=500)] * 8
    mine, theirs = _both(lambda t: _collect(t, half, slow_frac=1.0))
    assert mine == theirs and mine["conservation"]["conserved"] is False


def test_collect_publishes_the_mx_tail_families():
    agg = tailpath.TailAggregator(window=8, slow_frac=0.5)
    for i in (1, 2):
        agg.add(_fake(i * 10 ** 6, decode_compute=i * 10 ** 6))
    agg.collect()
    reg = tmx.telemetry.registry()
    assert reg.value("mx_tail_requests", cohort="all") == 2
    assert reg.value("mx_tail_requests", cohort="slow") == 1
    assert reg.value("mx_tail_blame_seconds", bin="decode_compute",
                     cohort="slow") == pytest.approx(2e-3)
    assert reg.value("mx_tail_conservation_fraction",
                     cohort="slow") == pytest.approx(1.0)
    assert reg.find("mx_tail_e2e_seconds").labels(kind="generate").count \
        >= 2
    # the same families, help strings and labels as the JAX package's
    jagg = jtail.TailAggregator(window=8, slow_frac=0.5)
    jagg.add(_fake(10 ** 6, decode_compute=10 ** 6))
    jagg.collect()
    mine, theirs = oh.family_schemas(tmx.telemetry.snapshot(),
                                     jmx.telemetry.snapshot())
    tail = {k: v for k, v in mine.items() if k.startswith("mx_tail_")}
    assert tail == {k: theirs[k] for k in tail} and len(tail) == 4


def test_summary_dump_and_the_env(tmp_path, monkeypatch):
    records = [_fake((i + 1) * 10 ** 6, decode_compute=(i + 1) * 10 ** 6)
               for i in range(8)]
    doc = _collect(tailpath, records, slow_frac=0.5)
    jdoc = _collect(jtail, records, slow_frac=0.5)
    assert tailpath.summary(doc) == jtail.summary(jdoc)
    tight = tailpath.summary(doc, max_bytes=220)
    assert "bins" not in tight and tight["kind"] == "tail_summary"
    assert tailpath.summary({"kind": "nope"}) is None
    target = tmp_path / "tail_env.json"
    monkeypatch.setenv("MXTPU_TAIL_ARTIFACT", str(target))
    tailpath.dump(None, doc)
    assert json.loads(target.read_text())["kind"] == "tail/v1"
    monkeypatch.delenv("MXTPU_TAIL_ARTIFACT")
    tailpath.dump(None, doc)                 # both unset: no-op
    monkeypatch.setenv("MXTPU_TAIL_ENABLE", "0")
    assert tailpath.enabled() is False
    monkeypatch.setenv("MXTPU_TAIL_ENABLE", "1")
    assert tailpath.enabled() is True
    monkeypatch.setenv("MXTPU_TAIL_WINDOW", "16")
    monkeypatch.setenv("MXTPU_TAIL_SLOW_FRAC", "0.5")
    agg = tailpath.TailAggregator()
    assert (agg.window, agg.slow_frac) == (16, 0.5)


# -- real span trees ----------------------------------------------------------------
CFG = dict(vocab_size=50, d_model=32, num_layers=2, num_heads=4,
           max_prompt_tokens=12)
PROMPTS = ([5, 9, 13], [7, 1, 2, 3, 4, 8, 11], [2, 2])


def _generate_spans(mx, tree=None):
    if mx is jmx:
        from mxnet_tpu.serving import Gateway
        from mxnet_tpu.serving.generate import GenerativeDecoder
        jmx.random.seed(0)
        dec = GenerativeDecoder(**CFG)
        dec.block.hybridize()
        gw = Gateway()
    else:
        from mxnet_tpu_torch.serving import Gateway
        from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                                      params_from_jax)
        dec = GenerativeDecoder(**CFG, device="cpu")
        dec.load_state_dict(params_from_jax(tree))
        gw = Gateway(device="cpu")
    try:
        gw.register_generator("lm", dec, block_tokens=4, max_blocks=64,
                              max_new_tokens=6, max_decode_batch=4)
        oh.reset(mx)
        reqs = [gw.generate("lm", p, max_new_tokens=6, stream=True)
                for p in PROMPTS]
        tokens = [r.result(timeout=60) for r in reqs]
        spans = mx.tracing.spans_snapshot()
    finally:
        gw.close()
    tree = jax.tree_util.tree_map(np.asarray, dec.param_tree()) \
        if mx is jmx else None
    return tokens, spans, tree


@pytest.fixture(scope="module")
def generate_runs():
    jtokens, jspans, tree = _generate_spans(jmx)
    tokens, spans, _ = _generate_spans(tmx, tree)
    return {"jax": (jtokens, jspans), "port": (tokens, spans)}


def test_jax_span_documents_give_equal_bins_through_both_joiners(
        generate_runs):
    _, jspans = generate_runs["jax"]
    mine, theirs = _both(lambda t: t.join_spans(jspans))
    assert mine == theirs
    assert len(mine[0]) == len(PROMPTS) and mine[1] == 0


def _conserves(records, tolerance=0.10):
    for r in records:
        bins = r["bins"]
        attributed = sum(v for b, v in bins.items() if b != "_unattributed")
        assert attributed <= r["e2e_ns"]
        assert attributed + bins["_unattributed"] == r["e2e_ns"]
        assert bins["_unattributed"] <= tolerance * r["e2e_ns"]


def test_the_ports_generate_trees_conserve(generate_runs, tmp_path):
    tokens, spans = generate_runs["port"]
    jtokens, _ = generate_runs["jax"]
    assert [list(t) for t in tokens] == [list(t) for t in jtokens]
    records, skipped = tailpath.join_spans(spans)
    assert skipped == 0 and len(records) == len(PROMPTS)
    assert {r["kind"] for r in records} == {"generate"}
    _conserves(records)
    agg = tailpath.TailAggregator(window=8, slow_frac=1.0)
    assert agg.ingest_spans(spans, stage="burst") == len(PROMPTS)
    doc = agg.collect()
    assert doc["conservation"]["conserved"] is True
    path = tmp_path / "tail.json"
    tailpath.dump(str(path), doc)
    out = subprocess.run([sys.executable, TAIL_REPORT, str(path)],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "decode_compute" in out.stdout
    out = subprocess.run([sys.executable, TAIL_REPORT, "--diff", str(path),
                          str(path)], capture_output=True, text=True,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr


def test_the_ports_oneshot_trees_conserve():
    from mxnet_tpu_torch.serving import Gateway
    rng = np.random.default_rng(0)
    s = tmx.sym
    net = s.FullyConnected(s.var("data"), s.var("w"), s.var("b"),
                           num_hidden=4, name="fc")
    args = {"w": tmx.nd.array(rng.normal(size=(4, 8)).astype(np.float32),
                              ctx=tmx.cpu()),
            "b": tmx.nd.array(np.zeros(4, np.float32), ctx=tmx.cpu())}
    gw = Gateway(device="cpu")
    try:
        gw.register("mlp", net, args, {}, input_shapes={"data": (8,)},
                    buckets=(1, 2, 4), max_wait_ms=1.0)
        oh.reset(tmx)
        reqs = [gw.submit("mlp", rng.normal(size=(1, 8)).astype(np.float32))
                for _ in range(6)]
        for r in reqs:
            r.result(timeout=30)
        spans = tmx.tracing.spans_snapshot()
    finally:
        gw.close()
    records, skipped = tailpath.join_spans(spans)
    assert skipped == 0 and len(records) == 6
    assert {r["kind"] for r in records} == {"oneshot"}
    _conserves(records)
