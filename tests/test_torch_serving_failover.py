"""The port's decode failover held to the JAX package on the CPU
(counterparts of tests/test_serving_failover.py): ``KVMigrator`` lands
the same bytes into the same block ids as the JAX migrator, a wedged
landing leaves nothing half-landed, and streams that lose their lane —
killed mid-stream (KV blocks migrated), replayed (``replay_storm``, a
wedged migration), scaled in or out — continue token for token equal to
the JAX package's ``reference_generate`` on the same weights; an
exhausted recovery budget is a fast ``lane_lost`` reject, the last lane's
death fails its streams promptly, and a recovery into a full pool queues
without double-booking. Recovery telemetry of the JAX tests is read from
``stats()`` and the requests' ``recover_spans``.

The decoder is the JAX failover tests' (vocab 50, d_model 32, 2 layers
of 4 heads) with weights drawn from a numpy seed (larger than gluon's
initial values, so the greedy streams vary), carried to the port by
``params_from_jax``. The JAX references are computed once per module,
through the hybridized JAX block (one jitted shape, the same tokens as
its eager run). Lanes on the CPU are ``devices=["cpu", "cpu"]``; every
wait is bounded.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import threading
import time

import jax
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.serving.generate import BlockPool as JaxPool
from mxnet_tpu.serving.generate import GenerativeDecoder as JaxDecoder
from mxnet_tpu.serving.generate import KVMigrator as JaxMigrator
from mxnet_tpu.serving.generate import reference_generate as jax_reference
from mxnet_tpu_torch.serving import Gateway, RejectedError, ServingError
from mxnet_tpu_torch.serving.generate import (BlockPool, GenerativeDecoder,
                                              KVMigrator, MigrationError,
                                              params_from_jax)

CFG = dict(vocab_size=50, d_model=32, num_layers=2, num_heads=4,
           max_prompt_tokens=12)
LANE = dict(block_tokens=4, max_blocks=64, warmup=False)
CPUS = ["cpu", "cpu"]
NEW = 16
PROMPTS = [[3, 1, 4, 1], [5, 9, 2, 6], [6, 5, 3, 5], [9, 7, 9, 2],
           [2, 7, 1, 8], [1, 6, 1, 8]]
LONG = 28                       # the full-pool and scale tests' budget


@pytest.fixture(scope="module")
def jax_decoder():
    dec = JaxDecoder(**CFG)
    rng = np.random.default_rng(5)
    for p in dec.block.collect_params().values():
        kind = p.name.rsplit("_", 1)[-1]
        value = (rng.standard_normal(p.shape) * 0.4 if kind == "weight"
                 else rng.standard_normal(p.shape) * 0.1 if kind == "bias"
                 else np.full(p.shape, 1.0 if kind == "gamma" else 0.0))
        p.set_data(mx.nd.array(value.astype(np.float32)))
    return dec


@pytest.fixture(scope="module")
def decoder(jax_decoder):
    tree = jax.tree_util.tree_map(np.asarray, jax_decoder.param_tree())
    dec = GenerativeDecoder(**CFG, device="cpu")
    dec.load_state_dict(params_from_jax(tree))
    return dec


@pytest.fixture(scope="module")
def refs(jax_decoder):
    """{prompt: the JAX reference's LONG greedy tokens} (greedy: the
    first n of them are the n-token reference)."""
    jax_decoder.block.hybridize()
    return {tuple(p): jax_reference(jax_decoder, p, LONG) for p in PROMPTS}


def _ref(refs, prompt, n):
    return refs[tuple(prompt)][:n]


def _wait_mid_stream(reqs, deadline_s=20.0):
    """Until every stream is mid-decode: first token out (prefill
    done), or already complete."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if all(len(r.tokens) >= 2 or r.done() for r in reqs):
            return
        time.sleep(0)
    raise AssertionError("streams never reached mid-decode")


def _kill_mid_stream(gen, req=None, cause="test: killed mid-stream",
                     deadline_s=20.0):
    """Kill a lane while a stream on it is still mid-decode: marked
    retiring under the model's cond, which the lane loop takes between
    steps, while a running request has >= 2 tokens still to generate —
    at most ONE more token lands before the evacuation. Returns the
    killed lane."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        with gen.cond:
            for ln in gen.lanes:
                if ln.retiring:
                    continue
                for r in ln.running:
                    if (req is None or r is req) and r.tokens and \
                            len(r.tokens) <= r.max_new_tokens - 2:
                        ln.cause = cause
                        ln.retiring = True
                        gen.cond.notify_all()
                        return ln
        time.sleep(0)
    raise AssertionError("never caught a stream mid-decode")


def _wait_finalized(lane, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline and not lane.finalized:
        time.sleep(0.001)
    assert lane.finalized


# -- KVMigrator: byte-exact salvage + land, against the JAX migrator ---------
def _filled_pools(kw, ids_n, seed):
    """A port and a JAX source pool holding the same numpy K/V in the
    same ``ids_n`` freshly allocated blocks; their destination pools."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    shape = (kw["num_layers"], ids_n, kw["block_tokens"], kw["num_heads"],
             kw["head_dim"])
    k_ref = rng.standard_normal(shape).astype(np.float32)
    v_ref = rng.standard_normal(shape).astype(np.float32)
    src, dst = BlockPool(**kw, device="cpu"), BlockPool(**kw, device="cpu")
    jsrc, jdst = JaxPool(**kw), JaxPool(**kw)
    ids, jids = src.alloc(ids_n), jsrc.alloc(ids_n)
    assert ids == jids
    import torch
    src.k[:, ids] = torch.from_numpy(k_ref)
    src.v[:, ids] = torch.from_numpy(v_ref)
    rows = np.asarray(jids, np.int32)
    jsrc.swap(jsrc.k.at[:, rows].set(jnp.asarray(k_ref)),
              jsrc.v.at[:, rows].set(jnp.asarray(v_ref)))
    return (src, dst, ids), (jsrc, jdst, jids), (k_ref, v_ref)


def test_kvmigrator_moves_blocks_byte_exact():
    """The port's salvage and land move the blocks byte for byte into
    the same destination block ids as the JAX migrator's (the pad sink
    untouched), at the same bytes; the source pool can close the moment
    salvage returns; closed or empty sources are unsalvageable."""
    kw = dict(num_layers=2, num_heads=2, head_dim=8, block_tokens=4,
              max_blocks=8)
    (src, dst, ids), (jsrc, jdst, jids), (k_ref, v_ref) = \
        _filled_pools(kw, 3, seed=7)
    dst.alloc(1), jdst.alloc(1)       # destination ids differ from source
    mig, jmig = KVMigrator("t"), JaxMigrator("t")
    sal, jsal = mig.salvage(src, ids), jmig.salvage(jsrc, jids)
    assert sal["nblocks"] == jsal["nblocks"] == 3
    assert sal["bytes"] == jsal["bytes"] == 3 * src.bytes_per_block
    src.close()                       # the salvage owns its bytes
    table, handoff = mig.land(sal, dst, table_width=5)
    jtable, jhandoff = jmig.land(jsal, jdst, table_width=5)
    assert table.blocks == jtable.blocks and 0 not in table.blocks
    assert list(table.row) == list(jtable.row)
    got = np.asarray(table.blocks)
    for port_pool, jax_pool, ref in ((dst.k, jdst.k, k_ref),
                                     (dst.v, jdst.v, v_ref)):
        np.testing.assert_array_equal(port_pool[:, got].numpy(), ref)
        np.testing.assert_array_equal(port_pool.numpy(),
                                      np.asarray(jax_pool))
    assert handoff["bytes_moved"] == jhandoff["bytes_moved"] == sal["bytes"]
    assert handoff["blocks"] == 3 and handoff["est_s"] > 0
    st = mig.stats()
    assert st["migrations"] == 1 and st["bytes_moved"] == sal["bytes"]
    assert {k: v for k, v in st.items() if k != "est_s_total"} == \
        {k: v for k, v in jmig.stats().items() if k != "est_s_total"}
    with pytest.raises(MigrationError, match="closed"):
        mig.salvage(src, ids)
    with pytest.raises(MigrationError, match="empty"):
        mig.salvage(dst, [])
    table.release()
    assert dst.used_blocks() == 1
    dst.close()
    with pytest.raises(MigrationError, match="closed"):
        mig.land(sal, dst, table_width=5)


def test_migrate_wedge_fault_fails_the_landing():
    kw = dict(num_layers=1, num_heads=2, head_dim=8, block_tokens=4,
              max_blocks=8)
    for plan, wedged in (("migrate_wedge", (True, True)),
                         ("migrate_wedge@round=2", (False, True))):
        (src, dst, ids), (jsrc, jdst, jids), _ = _filled_pools(kw, 2, 1)
        mig, jmig = (KVMigrator("t", fault_plan=plan),
                     JaxMigrator("t", fault_plan=plan))
        for attempt, wedge in enumerate(wedged, 1):
            for m, s, d, i in ((mig, src, dst, ids),
                               (jmig, jsrc, jdst, jids)):
                sal = m.salvage(s, i)
                if wedge:
                    with pytest.raises(Exception, match="wedged"):
                        m.land(sal, d, table_width=4)
                else:
                    m.land(sal, d, table_width=4)[0].release()
                assert d.used_blocks() == 0   # nothing half-landed
        assert mig.stats() == {**jmig.stats(),
                               "est_s_total": mig.stats()["est_s_total"]}


# -- mid-stream lane kill: migrate + replay, token-exact ---------------------
def test_lane_kill_migrates_streams_token_exact(decoder, refs):
    gw = Gateway(devices=CPUS)
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=NEW,
                                    max_decode_batch=2, replicas=2, **LANE)
        assert not gen.degraded and len(gen.lanes) == 2
        prompts = PROMPTS[:4]
        reqs = [gw.generate("lm", p, max_new_tokens=NEW, stream=True)
                for p in prompts]
        _wait_mid_stream(reqs)
        victim = _kill_mid_stream(gen, cause="test: lane killed")
        outs = [r.result(30.0) for r in reqs]
        assert outs == [_ref(refs, p, NEW) for p in prompts]
        recovered = [r for r in reqs if r.recover_spans]
        assert recovered              # the kill crossed live streams
        spans = [a for r in recovered for (_, _, a) in r.recover_spans]
        assert all(a["mode"] == "migrate" and a["cause"] ==
                   "test: lane killed" for a in spans)
        st = gen.stats()["recovery"]
        assert st["migrations"] == len(spans) >= 1
        assert st["bytes_moved"] == sum(a["bytes_moved"] for a in spans) \
            == sum(a["blocks"] for a in spans) * victim.pool.bytes_per_block
        _wait_finalized(victim)
        assert victim.pool.closed and victim.pool.k is None
        with gen.cond:
            assert victim not in gen.lanes
        survivor, = gen.stats()["lanes"]
        assert survivor["migrations"] == len(spans)
        assert survivor["pool"]["used_blocks"] == 0
    finally:
        gw.close()


@pytest.mark.parametrize("plan", ["replay_storm", "migrate_wedge"])
def test_forced_replay_joins_token_exact(decoder, refs, plan):
    """``replay_storm`` (salvage never attempted) and ``migrate_wedge``
    (every landing wedges) force the fallback: the survivor replays
    prompt + accepted tokens, and a request submitted during the
    recovery joins seamlessly."""
    gw = Gateway(devices=CPUS)
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=NEW,
                                    max_decode_batch=2, replicas=2, **LANE)
        gen.fault_plan = gen.migrator.fault_plan = plan
        prompts = PROMPTS[:3]
        reqs = [gw.generate("lm", p, max_new_tokens=NEW, stream=True)
                for p in prompts]
        _kill_mid_stream(gen, cause="test: storm kill")
        late = gw.generate("lm", PROMPTS[4], max_new_tokens=NEW,
                           stream=True)
        assert [r.result(30.0) for r in reqs] == \
            [_ref(refs, p, NEW) for p in prompts]
        assert late.result(30.0) == _ref(refs, PROMPTS[4], NEW)
        recovered = [r for r in reqs if r.recover_spans]
        assert recovered
        modes = {a["mode"] for r in recovered
                 for (_, _, a) in r.recover_spans}
        assert modes == {"replay"}
        st = gen.stats()
        if plan == "replay_storm":
            assert st["recovery"]["attempts"] == 0
        else:
            assert st["recovery"]["wedged"] == \
                st["recovery"]["attempts"] >= 1
        assert st["recovery"]["migrations"] == 0
        assert st["recovery"]["max_recoveries"] == gen.max_recoveries
        assert st["recovery"]["lane_lost_rejections"] == 0
        lane, = st["lanes"]
        assert lane["replays"] == len(recovered)
        # a replay re-prefills once and re-decodes its accepted tokens
        # but the last at batch 1
        assert lane["replay_decodes"] == sum(
            a["replayed_tokens"] - 1 for r in recovered
            for (_, _, a) in r.recover_spans)
    finally:
        gw.close()


# -- recovery budget: exhaustion = fast lane_lost reject ---------------------
def test_recovery_budget_exhaustion_fast_rejects_lane_lost(decoder,
                                                          monkeypatch):
    monkeypatch.setenv("MXTPU_GEN_MAX_RECOVERIES", "0")
    gw = Gateway(devices=CPUS)
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=NEW,
                                    max_decode_batch=4, replicas=2, **LANE)
        assert gen.max_recoveries == 0
        reqs = [gw.generate("lm", p, max_new_tokens=NEW, stream=True)
                for p in PROMPTS[:2]]
        _kill_mid_stream(gen, cause="test: budget kill")
        lost = []
        for r in reqs:
            try:
                r.result(30.0)
            except RejectedError as e:
                lost.append(e)
        assert lost
        assert all(e.reason == "lane_lost" and "resubmit" in str(e)
                   for e in lost)
        assert gen.stats()["recovery"]["lane_lost_rejections"] == len(lost)
    finally:
        gw.close()


def test_last_lane_kill_fails_streams_promptly(decoder):
    """No surviving lane: a consumer blocked in stream() observes the
    terminal lane_lost error promptly, and so does a second reader."""
    gw = Gateway(device="cpu")
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=NEW,
                                    max_decode_batch=2, **LANE)
        req = gw.generate("lm", PROMPTS[0], max_new_tokens=NEW,
                          stream=True)
        seen, failure, done_at = [], [], []

        def consume():
            try:
                for tok in req.stream():
                    seen.append(tok)
            except Exception as e:  # noqa: BLE001 — the assertion
                failure.append(e)
            done_at.append(time.monotonic())

        th = threading.Thread(target=consume, daemon=True)
        th.start()
        _kill_mid_stream(gen, req, cause="test: last lane down")
        t_kill = time.monotonic()
        th.join(10.0)
        assert done_at and done_at[0] - t_kill < 5.0
        assert failure and isinstance(failure[0], RejectedError)
        assert failure[0].reason == "lane_lost"
        assert "no surviving decode lanes" in str(failure[0])
        with pytest.raises(RejectedError):
            for _ in req.stream():
                pass
        with pytest.raises(RejectedError):
            gw.submit_generate("lm", [1])     # no live lane admits
    finally:
        gw.close()


def test_stream_observes_gateway_close_promptly(decoder):
    gw = Gateway(devices=CPUS)
    gw.register_generator("lm", decoder, max_new_tokens=NEW,
                          max_decode_batch=2, replicas=2, **LANE)
    req = gw.submit_generate("lm", [1, 2, 3], max_new_tokens=NEW)
    outcome = []

    def consume():
        try:
            outcome.append(("ok", list(req.stream())))
        except ServingError as e:
            outcome.append(("err", e))

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    gw.close()
    th.join(10.0)
    assert outcome                    # finished or failed cleanly, no hang


# -- kv_cache_full during recovery: queue, never double-book -----------------
def test_recovery_queues_on_full_pool_no_double_booking(decoder, refs):
    """A recovery whose target pool cannot cover its budget QUEUES
    (unreserved) and re-reserves atomically once blocks free up — it
    neither fast-rejects nor oversubscribes the pool."""
    gw = Gateway(devices=CPUS)
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=LONG,
                                    max_decode_batch=2, replicas=2, **LANE)
        lane0, lane1 = gen.lanes
        prompt = PROMPTS[3]
        victim_req = gw.generate("lm", prompt, max_new_tokens=LONG,
                                 stream=True)
        # capture, budget-hold and kill under ONE hold of the cond: the
        # stream cannot finish before the kill lands, and the target's
        # whole budget is held before the evacuation reserves anything
        target = held = None
        deadline = time.monotonic() + 20.0
        while target is None and time.monotonic() < deadline:
            with gen.cond:
                vl = next((ln for ln in (lane0, lane1)
                           if victim_req in ln.running), None)
                if vl is not None and victim_req.tokens and \
                        len(victim_req.tokens) <= LONG - 8:
                    target = lane1 if vl is lane0 else lane0
                    held = target.pool.usable_blocks - \
                        target.pool.reserved_blocks()
                    assert target.pool.reserve(held)
                    vl.cause = "test: kill into a full pool"
                    vl.retiring = True
                    gen.cond.notify_all()
                elif victim_req.done():
                    victim_req = None
            if victim_req is None:
                victim_req = gw.generate("lm", prompt, max_new_tokens=LONG,
                                         stream=True)
            time.sleep(0)
        assert target is not None, "never caught the victim mid-decode"
        with pytest.raises(ServingError, match="timed out"):
            victim_req.result(0.5)    # queued, NOT rejected
        assert not victim_req.done()
        assert target.pool.reserved_blocks() == target.pool.usable_blocks
        target.pool.unreserve(held)   # budget frees -> admission
        with gen.cond:
            gen.cond.notify_all()
        assert victim_req.result(30.0) == _ref(refs, prompt, LONG)
        assert victim_req.recover_spans
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and \
                (target.pool.reserved_blocks()
                 or target.pool.used_blocks()):
            time.sleep(0.001)
        assert target.pool.reserved_blocks() == 0
        assert target.pool.used_blocks() == 0
    finally:
        gw.close()


# -- planned scale-in / scale-out ride the same recovery path ----------------
def test_scale_in_evacuates_in_flight_generations(decoder, refs):
    gw = Gateway(devices=CPUS)
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=LONG,
                                    max_decode_batch=2, replicas=2, **LANE)
        prompts = PROMPTS[:4]
        reqs = [gw.generate("lm", p, max_new_tokens=LONG, stream=True)
                for p in prompts]
        # scale-in retires the NEWEST lane: shrink the instant one of
        # its streams is provably mid-decode
        doomed = gen.lanes[1]
        pool_bytes = doomed.pool.bytes_total
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            with gen.cond:
                if any(r.tokens and len(r.tokens) <= LONG - 12
                       for r in doomed.running):
                    break
            time.sleep(0)
        else:
            raise AssertionError("retiring lane never seen mid-stream")
        report = gw.scale("lm", 1)
        assert report["retired"] == 1 and report["freed_bytes"] == pool_bytes
        assert [r.result(30.0) for r in reqs] == \
            [_ref(refs, p, LONG) for p in prompts]
        assert any(r.recover_spans for r in reqs)
        assert gw.replica_count("lm") == 1
        assert doomed.finalized and doomed.pool.k is None
    finally:
        gw.close()


def test_scale_out_then_in_while_streams_run(decoder, refs):
    """1 -> 3 lanes while streams decode (the new lanes take new work),
    then 3 -> 1 (two pools released, their streams evacuated), and a
    lane killed through ``GenLane.kill``: every stream token-exact."""
    gw = Gateway(devices=["cpu"])
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=LONG,
                                    max_decode_batch=2, **LANE)
        first = [gw.generate("lm", p, max_new_tokens=LONG, stream=True)
                 for p in PROMPTS[:2]]
        report = gw.scale("lm", 3)
        assert report["added"] == 2 and report["degraded"] is True
        assert gw.replica_count("lm") == 3
        more = [gw.generate("lm", p, max_new_tokens=LONG, stream=True)
                for p in PROMPTS[2:]]
        _wait_mid_stream(more)
        pools = sum(ln.pool.bytes_total for ln in gen.lanes[1:])
        report = gw.scale("lm", 1)
        assert report["retired"] == 2 and report["freed_bytes"] == pools
        late = gw.generate("lm", PROMPTS[0], max_new_tokens=LONG,
                           stream=True)
        gw.scale("lm", 2)
        # a kill through the lane's own seam, while `late` decodes
        _wait_mid_stream([late])
        with gen.cond:
            victim = next((ln for ln in gen.lanes if late in ln.running),
                          gen.lanes[0])
        victim.kill("test: kill()")
        reqs = first + more + [late]
        assert [r.result(30.0) for r in reqs] == \
            [_ref(refs, p, LONG) for p in PROMPTS + [PROMPTS[0]]]
        _wait_finalized(victim)
        assert victim.cause == "test: kill()" and victim.pool.closed
        assert gw.replica_count("lm") == 1
    finally:
        gw.close()
