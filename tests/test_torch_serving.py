"""The port's one-shot serving held against the JAX package on the CPU:
bucket helpers and padding, the gateway (coalescing under max_wait,
replies equal to a direct Predictor, admission fast-rejects, error
paths, close), the Predictor, every variant's reply against the JAX
gateway's on the same tiny CNN and weights (fp32 within 1e-5, bf16 to
a stated bound, int8 native bitwise given the JAX package's calibrated
graph) and ``quantize_net`` on resnet18_v1.

Inputs and weights are made with numpy from fixed seeds and handed to
both packages.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.serving import Gateway as JGateway
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.predictor import Predictor, compile_symbol_forward
from mxnet_tpu_torch.serving import (Gateway, RejectedError, Request,
                                     ServingError, default_buckets,
                                     pad_batch, pick_bucket)

F32 = np.float32
CPU = tmx.cpu()


def tiny_mlp(pkg, seed=0, din=8, hidden=16, dout=4):
    """A two-layer MLP in package ``pkg`` (``mx`` or ``tmx``): symbol,
    numpy weights, feature shape."""
    rng = np.random.default_rng(seed)
    sym = pkg.sym
    data = sym.var("data")
    h = sym.FullyConnected(data, sym.var("fc1_weight"), sym.var("fc1_bias"),
                           num_hidden=hidden, name="fc1")
    a = sym.Activation(h, act_type="relu", name="act1")
    out = sym.FullyConnected(a, sym.var("fc2_weight"), sym.var("fc2_bias"),
                             num_hidden=dout, name="fc2")
    args = {"fc1_weight": rng.normal(0, 0.5, (hidden, din)),
            "fc1_bias": rng.normal(0, 0.5, (hidden,)),
            "fc2_weight": rng.normal(0, 0.5, (dout, hidden)),
            "fc2_bias": rng.normal(0, 0.5, (dout,))}
    return out, {k: v.astype(F32) for k, v in args.items()}, {}, (din,)


def tiny_cnn(pkg, seed=0):
    """Conv + BatchNorm + relu + FC: BatchNorm folding and convolution
    quantization."""
    rng = np.random.default_rng(seed)
    sym = pkg.sym
    data = sym.var("data")
    c = sym.Convolution(data, name="conv0", kernel=(3, 3), num_filter=4,
                        pad=(1, 1))
    b = sym.BatchNorm(c, name="bn0")
    r = sym.Activation(b, act_type="relu", name="relu0")
    out = sym.FullyConnected(sym.Flatten(r, name="flat0"), name="fc",
                             num_hidden=3)
    args = {"conv0_weight": rng.normal(0, 0.3, (4, 2, 3, 3)),
            "conv0_bias": np.zeros(4), "bn0_gamma": np.ones(4),
            "bn0_beta": np.zeros(4),
            "fc_weight": rng.normal(0, 0.3, (3, 4 * 6 * 6)),
            "fc_bias": np.zeros(3)}
    aux = {"bn0_moving_mean": np.zeros(4), "bn0_moving_var": np.ones(4)}
    return (out, {k: v.astype(F32) for k, v in args.items()},
            {k: v.astype(F32) for k, v in aux.items()}, (2, 6, 6))


def _x(feature, rows=1, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (rows,) + tuple(feature)).astype(F32)


def _tnd(d):
    return {k: tmx.nd.array(v, ctx=CPU) for k, v in d.items()}


def _jnd(d):
    return {k: mx.nd.array(v) for k, v in d.items()}


@pytest.fixture
def gw():
    g = Gateway(device="cpu")
    yield g
    g.close()


def _register(gw, name, builder, **kwargs):
    symbol, args, aux, feature = builder(tmx)
    gw.register(name, symbol, _tnd(args), _tnd(aux),
                input_shapes={"data": feature}, **kwargs)
    return symbol, args, aux, feature


# -- bucket / padding units (test_serving.py:82, :92) ------------------------
def test_default_buckets_and_pick():
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(12) == (1, 2, 4, 8, 12)
    assert default_buckets(1) == (1,)
    assert pick_bucket((1, 2, 4, 8), 3) == 4
    assert pick_bucket((1, 2, 4, 8), 8) == 8
    with pytest.raises(tmx.MXNetError):
        pick_bucket((1, 2), 3)


def test_pad_batch_layout():
    r1 = Request("m", "fp32", np.full((2, 3), 1.0, F32))
    r2 = Request("m", "fp32", np.full((1, 3), 2.0, F32))
    padded, rows = pad_batch([r1, r2], 4, (3,), F32)
    assert rows == 3 and padded.shape == (4, 3)
    assert (padded[:2] == 1.0).all() and (padded[2] == 2.0).all()
    assert (padded[3] == 0.0).all()


def test_model_queue_coalesces_requeues_and_drains():
    from mxnet_tpu_torch.serving.batcher import ModelQueue
    q = ModelQueue(max_rows=4, max_wait_s=0.0)
    reqs = [Request("m", v, np.zeros((n, 2), F32))
            for v, n in (("fp32", 1), ("bf16", 2), ("fp32", 2),
                         ("fp32", 2))]
    for r in reqs:
        q.put(r)
    assert q.depth() == 4 and q.pending_rows() == 7
    # the oldest head request's variant first, filled up to max_rows
    variant, batch = q.take_batch()
    assert variant == "fp32" and batch == [reqs[0], reqs[2]]
    q.requeue(batch)                        # back at the front, in order
    assert q.take_batch() == ("fp32", [reqs[0], reqs[2]])
    assert q.take_batch() == ("bf16", [reqs[1]])
    assert q.drain() == [reqs[3]] and q.pending_rows() == 0
    q.close()
    assert q.take_batch() is None
    with pytest.raises(RejectedError) as ei:
        q.put(reqs[0])
    assert ei.value.reason == "closed"


# -- gateway core ------------------------------------------------------------
def test_gateway_matches_direct_predictor(gw):
    """Padding to a bucket must not perturb live rows: the port's
    gateway replies equal the port's direct Predictor at the natural
    shape bitwise on the CPU (every op here acts per row)."""
    symbol, args, aux, feature = _register(gw, "cnn", tiny_cnn,
                                           buckets=(1, 4), max_wait_ms=0.0)
    for rows in (1, 3):
        x = _x(feature, rows)
        got = gw.infer("cnn", x)
        want = Predictor(symbol, _tnd(args), _tnd(aux),
                         {"data": (rows,) + feature},
                         device="cpu").forward(data=x)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_coalescing_and_max_wait_bound(gw):
    _, _, _, feature = _register(gw, "mlp", tiny_mlp, buckets=(1, 2, 4, 8),
                                 max_wait_ms=100.0)
    gw.infer("mlp", _x(feature))
    b0 = gw.stats()["mlp"]["batches"]["fp32"]
    n = 6
    reqs = [gw.submit("mlp", _x(feature, seed=i)) for i in range(n)]
    outs = [r.result(10.0) for r in reqs]
    assert all(o[0].shape == (1, 4) for o in outs)
    batches = gw.stats()["mlp"]["batches"]["fp32"] - b0
    # six submissions against one lane: the hold window coalesces them
    assert 1 <= batches < n
    # max_wait bounds latency: a lone request does not wait for a bucket
    t0 = time.perf_counter()
    gw.infer("mlp", _x(feature), timeout=10.0)
    assert time.perf_counter() - t0 < 2.0, "lone request waited"
    _register(gw, "mlp0", tiny_mlp, buckets=(1, 8), max_wait_ms=0.0)
    gw.infer("mlp0", _x(feature))
    t0 = time.perf_counter()
    gw.infer("mlp0", _x(feature), timeout=10.0)
    assert time.perf_counter() - t0 < 1.0


def test_coalesced_results_match_individual(gw):
    symbol, args, aux, feature = _register(
        gw, "mlp", tiny_mlp, buckets=(1, 2, 4, 8), max_wait_ms=50.0)
    gw.infer("mlp", _x(feature))
    xs = [_x(feature, rows=1 + (i % 2), seed=10 + i) for i in range(5)]
    reqs = [gw.submit("mlp", x) for x in xs]
    for x, r in zip(xs, reqs):
        out = r.result(10.0)
        want = Predictor(symbol, _tnd(args), _tnd(aux), {"data": x.shape},
                         device="cpu").forward(data=x)
        # the JAX test's tolerance: a product kernel may differ per batch
        np.testing.assert_allclose(out[0], want[0], rtol=1e-5, atol=1e-6)
    st = gw.stats()["mlp"]
    assert st["requests"]["fp32"] == 6 and st["rows"] == 8
    assert st["padding_rows"] >= 0 and st["executables"] == 4


def test_variant_selection_bf16_and_int8_lowerings(gw):
    symbol, args, aux, feature = tiny_cnn(tmx)
    calib = _x(feature, rows=16, seed=3)
    gw.register("q", symbol, _tnd(args), _tnd(aux),
                input_shapes={"data": feature},
                variants=("fp32", "bf16", "int8"), calib_data=calib,
                buckets=(1, 2), max_wait_ms=0.0, int8_lowering="native")
    x = _x(feature, rows=2, seed=4)
    f32 = gw.infer("q", x)[0]
    bf = gw.infer("q", x, variant="bf16")[0]
    i8 = gw.infer("q", x, variant="int8")[0]
    assert bf.dtype == np.float32 and i8.dtype == np.float32
    assert not np.array_equal(bf, f32)
    np.testing.assert_allclose(bf, f32, atol=0.15, rtol=0.1)
    assert not np.array_equal(i8, f32)
    scale = max(np.abs(f32).max(), 1.0)
    assert np.abs(i8 - f32).max() < 0.2 * scale
    st = gw.stats()["q"]
    assert st["int8_lowering"] == "native"
    assert all(st["requests"][v] >= 1 for v in ("fp32", "bf16", "int8"))
    # auto on the CPU is the weight-only lowering
    gw.register("qd", symbol, _tnd(args), _tnd(aux),
                input_shapes={"data": feature}, variants=("int8",),
                calib_data=calib, buckets=(1, 2), max_wait_ms=0.0)
    dq = gw.infer("qd", x, variant="int8")[0]
    assert not np.array_equal(dq, f32)
    assert np.abs(dq - f32).max() < 0.2 * scale
    assert gw.stats()["qd"]["int8_lowering"] == "dequant"


def test_unknown_model_variant_and_shape_errors(gw):
    symbol, args, aux, feature = _register(gw, "m", tiny_mlp,
                                           buckets=(1, 2), max_wait_ms=0.0)
    with pytest.raises(ServingError):
        gw.infer("nope", _x(feature))
    with pytest.raises(ServingError):
        gw.infer("m", _x(feature), variant="int8")
    with pytest.raises(ServingError):
        gw.infer("m", np.zeros((1, 5), F32))
    with pytest.raises(ServingError):
        gw.infer("m", _x(feature, rows=3))      # > largest bucket
    with pytest.raises(ServingError):
        gw.register("m", symbol, _tnd(args), _tnd(aux),
                    input_shapes={"data": feature})
    with pytest.raises(ServingError):
        gw.register("two", symbol, _tnd(args), _tnd(aux),
                    input_shapes={"data": feature, "extra": (2,)})


# -- admission control -------------------------------------------------------
def _block_lane(gw, model, parked=None):
    """Test seam: park the lane's executions on an Event, for a
    deterministic overload. ``parked``, an Event, is set once the lane
    holds a batch."""
    vs = gw._get_model(model).replicas[0].variant_set
    release = threading.Event()
    orig = vs.run

    def blocked(variant, batch):
        if parked is not None:
            parked.set()
        release.wait(20.0)
        return orig(variant, batch)

    vs.run = blocked
    return release


def test_admission_queue_full_fast_reject(gw):
    _, _, _, feature = _register(gw, "m", tiny_mlp, buckets=(1,),
                                 max_wait_ms=0.0, max_queue=2)
    gw.infer("m", _x(feature))
    release = _block_lane(gw, "m")
    first = gw.submit("m", _x(feature))     # executing (parked)
    time.sleep(0.05)
    q1 = gw.submit("m", _x(feature))
    q2 = gw.submit("m", _x(feature))
    t0 = time.perf_counter()
    with pytest.raises(RejectedError) as ei:
        gw.submit("m", _x(feature))
    assert ei.value.reason == "queue_full"
    assert time.perf_counter() - t0 < 0.1, "fast-reject must not block"
    assert gw.stats()["m"]["rejected"]["queue_full"] >= 1
    release.set()
    for r in (first, q1, q2):
        assert r.result(10.0)[0].shape == (1, 4)


def test_admission_slo_budget_reject(gw):
    """The budget is set from the model's own estimate once the lane is
    parked (no execution then moves the EWMA): one request fits, and the
    queued rows push the estimate past the budget within a few submits,
    however long one execution of the tiny MLP takes on a loaded host."""
    _, _, _, feature = _register(gw, "m", tiny_mlp, buckets=(1,),
                                 max_wait_ms=0.0, max_queue=1000)
    for _ in range(3):                      # seed the EWMA estimates
        gw.infer("m", _x(feature))
    parked = threading.Event()
    release = _block_lane(gw, "m", parked)
    pending = [gw.submit("m", _x(feature))]
    assert parked.wait(10.0)
    m = gw._get_model("m")
    one = m.estimate_latency_s(1)
    assert one is not None and one > 0
    m.slo_s = 4.0 * one                     # room for a few queued rows
    rejected = None
    for _ in range(50):
        try:
            pending.append(gw.submit("m", _x(feature)))
        except RejectedError as e:
            rejected = e
            break
    assert rejected is not None and rejected.reason == "slo"
    assert len(pending) > 1                 # the budget admitted some
    release.set()
    for r in pending:
        r.result(10.0)


def test_register_rejects_zero_and_several_replicas_and_tp(gw):
    """Zero replicas raise, and so does a tensor-parallel slice (tp >= 2)
    that the gateway's one device cannot hold; several replicas
    register, each a lane of its own on the one device (degraded)."""
    symbol, args, aux, feature = tiny_mlp(tmx)
    for kwargs in ({"replicas": 0}, {"tp": 2}):
        with pytest.raises(ServingError):
            gw.register("m", symbol, _tnd(args), _tnd(aux),
                        input_shapes={"data": feature}, **kwargs)
    with pytest.raises(ServingError, match="cannot carve a tp=2 slice"):
        gw.register("m", symbol, _tnd(args), _tnd(aux),
                    input_shapes={"data": feature}, tp=2)
    gw.register("two", symbol, _tnd(args), _tnd(aux),
                input_shapes={"data": feature}, buckets=(1,), replicas=2)
    st = gw.stats()["two"]
    assert [r["idx"] for r in st["replicas"]] == [0, 1]
    assert st["degraded"] is True and st["executables"] == 2
    assert gw.infer("two", _x(feature))[0].shape == (1, 4)
    # a warmup that fails (a feature shape the graph cannot take) fails
    # the registration, on the caller's thread
    with pytest.raises(RuntimeError):
        gw.register("m", symbol, _tnd(args), _tnd(aux),
                    input_shapes={"data": (5,)}, buckets=(1,))
    # a failed registration leaves the name free
    gw.register("m", symbol, _tnd(args), _tnd(aux),
                input_shapes={"data": feature}, buckets=(1,), warmup=False)
    assert gw.stats()["m"]["executables"] == 0


def test_replicas_knob_raises_instead_of_serving_one(gw, monkeypatch):
    """MXTPU_SERVING_REPLICAS=2 asks for two replicas per model and per
    generator, and the port serves two, as the JAX package does;
    MXTPU_SERVING_TP=2 asks for tensor-parallel slices: a one-shot model
    has none in the port, and a one-device gateway cannot carve a
    2-device slice for a generator, so registration raises instead of
    serving one plain lane silently."""
    symbol, args, aux, feature = tiny_mlp(tmx)
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder
    dec = GenerativeDecoder(vocab_size=32, d_model=16, num_layers=1,
                            num_heads=2, max_prompt_tokens=16,
                            device="cpu")
    monkeypatch.setenv("MXTPU_SERVING_TP", "2")
    with pytest.raises(ServingError, match="tp"):
        gw.register("m", symbol, _tnd(args), _tnd(aux),
                    input_shapes={"data": feature}, warmup=False)
    with pytest.raises(ServingError, match="tp"):
        gw.register_generator("lm", dec, warmup=False)
    assert "m" not in gw.stats() and "lm" not in gw.stats()
    monkeypatch.delenv("MXTPU_SERVING_TP")
    monkeypatch.setenv("MXTPU_SERVING_REPLICAS", "2")
    gw.register("m", symbol, _tnd(args), _tnd(aux),
                input_shapes={"data": feature}, warmup=False)
    gw.register_generator("lm", dec, max_blocks=64, warmup=False)
    assert len(gw.stats()["m"]["replicas"]) == 2
    assert gw.replica_count("lm") == 2
    # the knob at 1, or an explicit replicas=1, registers one lane
    gw.register("m1", symbol, _tnd(args), _tnd(aux),
                input_shapes={"data": feature}, warmup=False, replicas=1)
    monkeypatch.setenv("MXTPU_SERVING_REPLICAS", "1")
    gw.register("m2", symbol, _tnd(args), _tnd(aux),
                input_shapes={"data": feature}, warmup=False)
    assert gw.replica_count("m1") == gw.replica_count("m2") == 1


def test_close_fails_pending_cleanly():
    gw = Gateway(device="cpu")
    symbol, args, aux, feature = _register(gw, "m", tiny_mlp, buckets=(1,),
                                           max_wait_ms=0.0)
    gw.infer("m", _x(feature))
    release = _block_lane(gw, "m")
    taken = gw.submit("m", _x(feature))
    time.sleep(0.05)
    queued = gw.submit("m", _x(feature))
    closer = threading.Thread(target=gw.close)
    closer.start()
    time.sleep(0.1)
    release.set()
    closer.join(15.0)
    assert not closer.is_alive()
    assert taken.result(5.0)[0].shape == (1, 4)
    with pytest.raises(ServingError):
        queued.result(5.0)
    with pytest.raises(ServingError):
        gw.register("late", symbol, _tnd(args), _tnd(aux),
                    input_shapes={"data": feature})


def test_lane_failure_fails_its_batch_and_rejects_after(gw):
    _, _, _, feature = _register(gw, "m", tiny_mlp, buckets=(1,),
                                 max_wait_ms=0.0)
    vs = gw._get_model("m").replicas[0].variant_set

    def broken(variant, batch):
        raise RuntimeError("device lost")

    vs.run = broken
    with pytest.raises(ServingError):
        gw.infer("m", _x(feature), timeout=10.0)
    with pytest.raises(RejectedError) as ei:
        gw.submit("m", _x(feature))
    assert ei.value.reason == "no_replica"


# -- predictor (test_serving.py:630, :671) -----------------------------------
def test_predictor_concurrent_first_forward_builds_once():
    symbol, args, aux, feature = tiny_mlp(tmx)
    pred = Predictor(symbol, _tnd(args), _tnd(aux), {"data": (1,) + feature},
                     device="cpu")
    builds = []
    orig_build = pred._build

    def counting_build():
        builds.append(threading.get_ident())
        time.sleep(0.02)                    # widen the race window
        orig_build()

    pred._build = counting_build
    x = _x(feature)
    outs, errs = [None] * 8, []
    barrier = threading.Barrier(8)

    def fire(i):
        try:
            barrier.wait(5.0)
            outs[i] = pred.forward(data=x)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(15.0)
    assert not errs
    assert len(builds) == 1, f"lazy _build ran {len(builds)} times"
    want = Predictor(symbol, _tnd(args), _tnd(aux), {"data": (1,) + feature},
                     device="cpu").forward(data=x)
    for out in outs:
        np.testing.assert_array_equal(out[0], want[0])


def test_predictor_explicit_device_pin():
    symbol, args, aux, feature = tiny_mlp(tmx)
    pred = Predictor(symbol, _tnd(args), _tnd(aux), {"data": (1,) + feature},
                     dev_type="cpu")
    out = pred.forward(data=_x(feature))
    assert out[0].shape == (1, 4)
    assert all(v.device == torch.device("cpu") for v in pred._param_vals)


def test_predictor_matches_jax_and_reads_its_checkpoint(tmp_path):
    jsym, args, aux, feature = tiny_cnn(mx)
    prefix = str(tmp_path / "cnn")
    mx.model.save_checkpoint(prefix, 2, jsym, _jnd(args), _jnd(aux))
    shapes = {"data": (3,) + feature}
    x = _x(feature, rows=3, seed=7)
    want = mx.predictor.Predictor.from_checkpoint(prefix, 2, shapes)
    pred = Predictor.from_checkpoint(prefix, 2, shapes, device="cpu")
    assert pred.output_shapes() == want.output_shapes() == [(3, 3)]
    got, ref = pred.forward(data=x)[0], want.forward(data=x)[0]
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    with pytest.raises(tmx.MXNetError):
        pred.forward(data=x[:1])
    pred.reshape({"data": (1,) + feature})
    # another batch size may take another CPU convolution kernel
    np.testing.assert_allclose(pred.forward(data=x[:1])[0], got[:1],
                               rtol=0, atol=1e-5 * np.abs(got).max())


def test_dequantize_offline_params_roundtrip():
    """The helper behind the dequant lowering equals the JAX package's
    and folds back within one quantization step."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (4, 3)).astype(F32)
    amax = float(np.abs(w).max())
    q = np.clip(np.rint(w * (tq.INT8_RANGE / amax)), -tq.INT8_RANGE,
                tq.INT8_RANGE).astype(np.int8)
    qarg = {"fc_weight_int8": q,
            "fc_weight_int8_min": np.array(-amax, F32),
            "fc_weight_int8_max": np.array(amax, F32),
            "unrelated": np.ones(2, F32)}
    back = tq.dequantize_offline_params(_tnd(qarg))
    want = jq.dequantize_offline_params(_jnd(qarg))
    assert set(back) == set(want) == {"fc_weight"}
    np.testing.assert_array_equal(back["fc_weight"].asnumpy(),
                                  want["fc_weight"].asnumpy())
    np.testing.assert_allclose(back["fc_weight"].asnumpy(), w,
                               atol=amax / tq.INT8_RANGE * 0.51)


# -- every variant against the JAX gateway -----------------------------------
BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module")
def jax_replies():
    """The JAX gateway's replies for every variant (int8 native) on the
    tiny CNN, and the JAX package's calibrated graph for the same
    calibration data (the flow its VariantSet runs)."""
    jsym, args, aux, feature = tiny_cnn(mx)
    calib = _x(feature, rows=16, seed=3)
    xs = [_x(feature, rows=r, seed=20 + r) for r in (1, 3)]
    jgw = JGateway()
    try:
        jgw.register("q", jsym, _jnd(args), _jnd(aux),
                     input_shapes={"data": feature},
                     variants=("fp32", "bf16", "int8"), calib_data=calib,
                     buckets=BUCKETS, max_wait_ms=0.0,
                     int8_lowering="native")
        replies = {v: [jgw.infer("q", x, variant=v)[0] for x in xs]
                   for v in ("fp32", "bf16", "int8")}
    finally:
        jgw.close()
    qsym, qarg, qaux = jq.quantize_model(
        jsym, _jnd(args), _jnd(aux), calib_mode="naive",
        calib_data=mx.io.NDArrayIter(data={"data": calib}, batch_size=8),
        num_calib_examples=len(calib))
    return dict(args=args, aux=aux, feature=feature, calib=calib, xs=xs,
                replies=replies, qsym=qsym,
                qarg={k: v.asnumpy() for k, v in qarg.items()},
                qaux={k: v.asnumpy() for k, v in qaux.items()})


def _calib_table(sym):
    return [(n.op, n.attrs["min_calib_range"], n.attrs["max_calib_range"])
            for n in sym._topo() if "min_calib_range" in n.attrs]


def test_variants_match_the_jax_gateway(jax_replies, gw):
    """fp32 within 1e-5 of the logits' scale; bf16 within 2e-2 of it
    (both packages round every float input, weight and op output to
    bfloat16, in other orders); the port's own calibration table within
    rtol 1e-5 of the JAX package's (fp32 sums in another order)."""
    r = jax_replies
    feature = r["feature"]
    symbol, _, _, _ = tiny_cnn(tmx)
    gw.register("q", symbol, _tnd(r["args"]), _tnd(r["aux"]),
                input_shapes={"data": feature},
                variants=("fp32", "bf16", "int8"), calib_data=r["calib"],
                buckets=BUCKETS, max_wait_ms=0.0, int8_lowering="native")
    for i, x in enumerate(r["xs"]):
        want32 = r["replies"]["fp32"][i]
        scale = np.abs(want32).max()
        got32 = gw.infer("q", x)[0]
        np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-5 * scale)
        got16 = gw.infer("q", x, variant="bf16")[0]
        np.testing.assert_allclose(got16, r["replies"]["bf16"][i], rtol=0,
                                   atol=2e-2 * scale)
        got8 = gw.infer("q", x, variant="int8")[0]
        assert np.abs(got8 - want32).max() < 0.2 * max(scale, 1.0)
    vs = gw._get_model("q").replicas[0].variant_set
    mine, ref = _calib_table(vs.int8_symbol), _calib_table(r["qsym"])
    assert [m[0] for m in mine] == [j[0] for j in ref] and len(ref) >= 3
    np.testing.assert_allclose([m[1:] for m in mine], [j[1:] for j in ref],
                               rtol=1e-5)


def test_int8_native_bitwise_given_the_jax_calibrated_graph(jax_replies):
    """The int8 native executable of the port (the VariantSet's
    ``compile_symbol_forward`` of the quantized graph) on the JAX
    package's calibrated graph and weights, at each bucket a reply pads
    to, equals the JAX gateway's int8 replies bitwise."""
    r = jax_replies
    with CPU:
        qsym = tmx.sym.load_json(r["qsym"].tojson())
        qarg, qaux = tmx.model.params_from_jax(r["qarg"], r["qaux"])
    fn, pvals = compile_symbol_forward(qsym, {**qarg, **qaux}, device="cpu")
    for i, x in enumerate(r["xs"]):
        bucket = pick_bucket(BUCKETS, len(x))
        padded = np.zeros((bucket,) + x.shape[1:], F32)
        padded[:len(x)] = x
        got = fn(pvals, {"data": padded})[0].numpy()[:len(x)]
        want = r["replies"]["int8"][i]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# -- quantize_net ------------------------------------------------------------
R18_SHAPE = (2, 3, 32, 32)


def test_quantize_net_resnet18_matches_jax():
    """``quantize_net`` on resnet18_v1 from the JAX package's weights:
    the calibration table within rtol 1e-5 of the JAX package's (the
    same flow as its ``quantize_net``: trace, naive calibration on 8
    images), and, given the JAX package's table and int8 weights, the
    port's int8 logits equal its ``quantize_net`` logits bitwise."""
    from mxnet_tpu.gluon.block import infer_shapes as j_infer_shapes
    from mxnet_tpu.gluon.model_zoo import vision as jv
    from mxnet_tpu.symbol.trace import trace_block as j_trace
    from mxnet_tpu_torch.gluon.model_zoo import vision as tv
    from mxnet_tpu_torch.gluon.utils import params_from_jax

    rng = np.random.default_rng(31)
    calib = rng.standard_normal((8,) + R18_SHAPE[1:]).astype(F32)
    x = rng.standard_normal(R18_SHAPE).astype(F32)
    jnet = jv.resnet18_v1(prefix="r18_")
    jnet.initialize(mx.init.Xavier(magnitude=2))
    j_infer_shapes(jnet, R18_SHAPE)
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    jfwd, jparams = jq.quantize_net(jnet, R18_SHAPE[0], calib)
    want = np.asarray(jfwd(jparams, mx.nd.array(x)._data))
    # the JAX package's table: the steps of its quantize_net
    jsym, jp = j_trace(jnet)
    aux_names = set(jsym.list_auxiliary_states())
    jqsym, jqarg, jqaux = jq.quantize_model(
        jsym, {k: p.data() for k, p in jp.items() if k not in aux_names},
        {k: p.data() for k, p in jp.items() if k in aux_names},
        calib_mode="naive",
        calib_data=mx.io.NDArrayIter(data=calib, batch_size=8),
        num_calib_examples=8)

    tnet = tv.resnet18_v1(prefix="r18_")
    tnet.initialize(tmx.initializer.Zero(), ctx=CPU)
    params_from_jax(tnet, weights, ctx=CPU)
    tfwd, tparams = tq.quantize_net(tnet, R18_SHAPE[0], calib, ctx=CPU)
    mine, ref = _calib_table(tfwd.symbol), _calib_table(jqsym)
    assert [m[0] for m in mine] == [j[0] for j in ref] and len(ref) > 20
    np.testing.assert_allclose([m[1:] for m in mine], [j[1:] for j in ref],
                               rtol=1e-5)
    own = tfwd(tparams, x).numpy()
    assert own.shape == (2, 1000) and np.isfinite(own).all()
    with CPU:
        qsym = tmx.sym.load_json(jqsym.tojson())
        qarg, qaux = tmx.model.params_from_jax(
            {k: v.asnumpy() for k, v in jqarg.items()},
            {k: v.asnumpy() for k, v in jqaux.items()})
    fwd, params = tq.quantized_forward(qsym, qarg, qaux, device="cpu")
    got = fwd(params, x).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
