"""The port's tensor-parallel generator held to the JAX package on the
CPU (counterpart of tests/test_serving_sharded.py's generate half):
``Gateway.register_generator(tp=2)`` on two ``cpu`` shards — the
paged pool's heads sharded over the slice, the weights split by the
layout table, K3 prefill and K4 decode on each shard's heads, the
row-parallel sums and the vocab-sharded embedding and head through the
in-process mesh's collectives — gives greedy tokens equal to the JAX
package's ``reference_generate`` on the same weights (the contract the
JAX tp lane is held to, ``test_generator_tp2_greedy_matches_reference``);
each pool shard holds ``bytes_total / tp`` bytes (the JAX sharded
pool's per-device bytes), indivisible heads raise in both packages, a
tp lane killed mid-stream hands its streams' blocks to the other slice
token for token, and ``stats()["tp"]``, ``scale`` over slices and the
``MXTPU_SERVING_TP`` default hold.

The decoder is the JAX tp test's (vocab 50, d_model 32, 2 layers of 4
heads; 2 heads a shard) with weights drawn from a numpy seed (std 0.4,
so the greedy streams vary), carried to the port by ``params_from_jax``;
the JAX references come once per module through the hybridized JAX
block. Tokens exact; no subprocess; every wait bounded.

The one-shot half (the JAX file's first half): a ``ShardedVariantSet``
over two ``cpu`` positions and ``register(tp=2)`` on the JAX test's MLP,
held within ``DIVERGENCE_BOUND`` of the JAX package's slice (two of its
virtual CPU devices) and its gateway, the bf16 variant no further from
fp32 than twice the JAX bf16 slice, the placement report's rows and
per-device bytes the JAX report's (and each position's stored bytes
what the report states), the refusals, the environment default and
``scale`` over slices."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.serving.generate import BlockPool as JaxPool
from mxnet_tpu.serving.sharded import ShardedVariantSet as JaxSliceSet
from mxnet_tpu.serving.generate import GenerativeDecoder as JaxDecoder
from mxnet_tpu.serving.generate import reference_generate as jax_reference
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (DIVERGENCE_BOUND, Gateway, ServingError,
                                     ShardedVariantSet)
from mxnet_tpu_torch.serving.generate import (BlockPool, GenerativeDecoder,
                                              params_from_jax)

CFG = dict(vocab_size=50, d_model=32, num_layers=2, num_heads=4,
           max_prompt_tokens=16)
LANE = dict(block_tokens=4, max_blocks=48, max_decode_batch=4, warmup=False)
SHARDS = ["cpu", "cpu"]
NEW = 12
PROMPTS = [[3, 1, 4, 1], [5, 9, 2, 6], [6, 5, 3, 5], [9, 7, 9, 2]]


@pytest.fixture(scope="module")
def jax_decoder():
    dec = JaxDecoder(**CFG)
    rng = np.random.default_rng(11)
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
    """{prompt: the JAX reference's NEW greedy tokens}."""
    jax_decoder.block.hybridize()
    return {tuple(p): jax_reference(jax_decoder, p, NEW) for p in PROMPTS}


def _shard_bytes(pool):
    return [k.nbytes + v.nbytes for k, v in pool.shards()]


def test_tp2_generator_tokens_equal_jax_reference(decoder, refs):
    gw = Gateway(devices=SHARDS)
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=NEW,
                                    tp=2, **LANE)
        st = gw.stats()["lm"]
        # both shards on one device: the slice is degraded, as on one card
        assert st["tp"] == 2 and st["degraded"] is True
        assert st["lanes"][0]["device"] == ["cpu", "cpu"]
        reqs = [gw.generate("lm", p, max_new_tokens=NEW, stream=True)
                for p in PROMPTS]
        assert [r.result(30.0) for r in reqs] == \
            [refs[tuple(p)] for p in PROMPTS]
        # a lone request, and one prompt decoded on its own
        assert gw.generate("lm", PROMPTS[2], max_new_tokens=5) == \
            refs[tuple(PROMPTS[2])][:5]
        pool = gen.lanes[0].pool
        assert pool.tp == 2 and len(pool.k) == len(pool.v) == 2
        assert _shard_bytes(pool) == [pool.bytes_total // 2] * 2
        assert pool.k[0].shape[3] == CFG["num_heads"] // 2
        calls = gen.lanes[0].stats()["step_calls"]
        assert calls["prefill"] == len(PROMPTS) + 1 and calls["decode"] > 0
    finally:
        gw.close()


def test_pool_shards_hold_bytes_total_over_tp_like_jax():
    kw = dict(num_layers=2, num_heads=4, head_dim=8, block_tokens=4,
              max_blocks=8)
    pool = BlockPool(**kw, device=tuple(SHARDS))
    jpool = JaxPool(**kw, device=tuple(jax.devices()[:2]))
    assert pool.bytes_total == jpool.bytes_total
    assert _shard_bytes(pool) == [s.data.nbytes * 2
                                  for s in jpool.k.addressable_shards]
    assert pool.bytes_per_block == jpool.bytes_per_block
    # the migration view: a block's shards join along the heads axis
    # and land back on each shard's heads
    rng = np.random.default_rng(1)
    ids = pool.alloc(3)
    full = rng.standard_normal((2, 3, 4, 4, 8)).astype(np.float32)
    pool.scatter(ids, torch.from_numpy(full), torch.from_numpy(-full))
    np.testing.assert_array_equal(pool.k[1][:, ids].numpy(),
                                  full[:, :, :, 2:])
    k, v = pool.gather(ids)
    np.testing.assert_array_equal(k.numpy(), full)
    np.testing.assert_array_equal(v.numpy(), -full)
    pool.close()
    assert pool.bytes_total == 0 and pool.k is None
    for cls, dev in ((BlockPool, tuple(SHARDS)),
                     (JaxPool, tuple(jax.devices()[:2]))):
        with pytest.raises(Exception, match="heads % tp"):
            cls(num_layers=1, num_heads=3, head_dim=8, block_tokens=4,
                max_blocks=4, device=dev)
    with pytest.raises(MXNetError):
        BlockPool(num_layers=1, num_heads=3, head_dim=8, block_tokens=4,
                  max_blocks=4, device=tuple(SHARDS))


def _kill_mid_stream(gen, deadline_s=20.0):
    """Mark a lane retiring (the JAX failover tests' kill) while one of
    its streams has at least two tokens still to go."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        with gen.cond:
            for ln in gen.lanes:
                if not ln.retiring and any(
                        r.tokens and len(r.tokens) <= r.max_new_tokens - 2
                        for r in ln.running):
                    ln.cause = "test: tp lane killed"
                    ln.retiring = True
                    gen.cond.notify_all()
                    return ln
        time.sleep(0)
    raise AssertionError("never caught a stream mid-decode")


def test_tp_lane_kill_and_scale_over_slices_token_exact(decoder, refs,
                                                        monkeypatch):
    """``MXTPU_SERVING_TP=2`` makes the generator's lanes slices; scale
    adds a second slice; killing one mid-stream migrates its streams'
    KV blocks (sharded gather, sharded landing) to the other, token for
    token; scale back to one slice frees a pool."""
    monkeypatch.setenv("MXTPU_SERVING_TP", "2")
    gw = Gateway(devices=SHARDS)
    try:
        gen = gw.register_generator("lm", decoder, max_new_tokens=NEW,
                                    **LANE)
        assert gw.stats()["lm"]["tp"] == 2 and gen.degraded
        rep = gw.scale("lm", 2)
        assert rep["added"] == 1 and rep["degraded"] is True
        assert all(len(ln.device) == 2 for ln in gen.lanes)
        reqs = [gw.generate("lm", p, max_new_tokens=NEW, stream=True)
                for p in PROMPTS]
        victim = _kill_mid_stream(gen)
        assert [r.result(30.0) for r in reqs] == \
            [refs[tuple(p)] for p in PROMPTS]
        spans = [a for r in reqs for (_, _, a) in r.recover_spans]
        assert spans and all(a["mode"] == "migrate" for a in spans)
        deadline = time.monotonic() + 10.0
        while not victim.finalized and time.monotonic() < deadline:
            time.sleep(0.001)
        assert victim.finalized and victim.pool.k is None
        rep = gw.scale("lm", 2)
        assert rep["added"] == 1
        freed = gw.scale("lm", 1)
        assert freed["retired"] == 1 and \
            freed["freed_bytes"] == gen.lanes[0].pool.bytes_total
        assert gw.generate("lm", PROMPTS[1], max_new_tokens=NEW) == \
            refs[tuple(PROMPTS[1])]
        meshes = [f"mxtorch-mesh{id(ln.pool.mesh):x}-" for ln in gen.lanes]
    finally:
        gw.close()
    # a closed pool stops its slice's shard threads
    assert not [t for t in threading.enumerate()
                if any(t.name.startswith(m) for m in meshes)]


def test_one_shot_register_with_tp_names_sharded_variant_set():
    """``register(tp=2)`` serves each lane through a
    ``ShardedVariantSet`` over its slice; a tp=3 generator cannot be
    carved from two devices."""
    symbol, args, aux, feature = _mlp(tmx)
    gw = Gateway(devices=SHARDS)
    try:
        m = gw.register("m", symbol, args, aux,
                        input_shapes={"data": feature}, buckets=(1,),
                        max_wait_ms=0.0, tp=2)
        assert isinstance(m.replicas[0].variant_set, ShardedVariantSet)
        assert gw.stats()["m"]["tp"] == 2
        with pytest.raises(ServingError, match="tp=3"):
            dec = GenerativeDecoder(vocab_size=16, d_model=16, num_layers=1,
                                    num_heads=2, device="cpu")
            gw.register_generator("lm", dec, tp=3, warmup=False)
    finally:
        gw.close()


def test_tp_lane_refuses_a_layout_it_cannot_split(decoder):
    """The tp lane splits qkv / mlp-in by columns and proj / mlp-out by
    rows; a layout table that places them otherwise raises at
    registration instead of serving a different split."""
    from mxnet_tpu_torch.parallel import SpecLayout
    gw = Gateway(devices=SHARDS)
    try:
        for layout in (SpecLayout(overrides=[(r"qkv_w$", "norm")]),
                       SpecLayout(overrides=[(r"ff2_w$", "mlp-in")])):
            with pytest.raises(MXNetError, match="the tp lane splits"):
                gw.register_generator("lm", decoder, tp=2, layout=layout,
                                      max_new_tokens=4, **LANE)
        assert "lm" not in gw.stats()
    finally:
        gw.close()


# -- one-shot models over a slice ---------------------------------------------
def _mlp(pkg, seed=0, width=32, layers=3, out=10):
    """The JAX test's MLP (``tests/test_serving_sharded.py`` ``mlp``) in
    ``pkg``: the same numpy draws, so both packages hold one model."""
    rng = np.random.default_rng(seed)
    h = pkg.sym.var("data")
    args = {}
    for i in range(layers):
        h = pkg.sym.Activation(pkg.sym.FullyConnected(
            h, name=f"fc{i}", num_hidden=width), act_type="relu")
        args[f"fc{i}_weight"] = rng.normal(0, 0.1, (width, width))
        args[f"fc{i}_bias"] = rng.normal(0, 0.1, width)
    o = pkg.sym.FullyConnected(h, name="fco", num_hidden=out)
    args["fco_weight"] = rng.normal(0, 0.1, (out, width))
    args["fco_bias"] = np.zeros(out)
    ctx = {"ctx": pkg.cpu()} if pkg is tmx else {}
    return o, {k: pkg.nd.array(v.astype(np.float32), **ctx)
               for k, v in args.items()}, {}, (width,)


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_sharded_variant_set_matches_the_jax_slice(monkeypatch, tmp_path):
    symbol, args, aux, feature = _mlp(tmx)
    jsym, jargs, jaux, _ = _mlp(mx)
    # MXTPU_LAYOUT_REPORT: the lane writes its placement report there
    monkeypatch.setenv("MXTPU_LAYOUT_REPORT", str(tmp_path / "slice.json"))
    vs = ShardedVariantSet(symbol, args, aux, "data", feature,
                           devices=SHARDS, variants=("fp32", "bf16"))
    monkeypatch.delenv("MXTPU_LAYOUT_REPORT")
    jvs = JaxSliceSet(jsym, jargs, jaux, "data", feature,
                      devices=jax.local_devices()[:2],
                      variants=("fp32", "bf16"))
    try:
        assert vs.tp == 2 and vs.int8_lowering is None and vs.degraded
        x = np.random.default_rng(1).normal(
            0, 1, (4,) + feature).astype(np.float32)
        got = {v: vs.run(v, x)[0] for v in ("fp32", "bf16")}
        want = {v: jvs.run(v, x)[0] for v in ("fp32", "bf16")}
        assert got["fp32"].shape == (4, 10)
        assert got["fp32"].dtype == got["bf16"].dtype == np.float32
        assert _dist(got["fp32"], want["fp32"]) <= DIVERGENCE_BOUND
        assert _dist(got["bf16"], got["fp32"]) <= \
            2 * _dist(want["bf16"], want["fp32"])
        # the three column-split weights and the row-split head's,
        # gathered on use
        assert vs.mesh.last_collectives == {"allgather": 4}
        assert vs.warmup((1, 4)) == 4
        rep, jrep = vs.placement_report(), jvs.placement_report()
        keys = ("param", "shape", "dtype", "role", "spec", "fitted_spec",
                "shard_ways", "bytes", "per_device_bytes")
        assert [{k: r[k] for k in keys} for r in rep["params"]] == \
            [{k: r[k] for k in keys} for r in jrep["params"]]
        for k in ("kind", "tp", "mesh", "total_bytes",
                  "per_device_param_bytes"):
            assert rep[k] == jrep[k], k
        assert vs.position_bytes() == [rep["per_device_param_bytes"]] * 2
        assert json.loads((tmp_path / "slice.json").read_text()) == \
            json.loads(json.dumps(rep))
    finally:
        vs.close()


def test_sharded_variant_set_refusals():
    """Both packages refuse a one-device slice and int8; the JAX package
    refuses a repeated device, which the port takes (``degraded``)."""
    symbol, args, aux, feature = _mlp(tmx)
    for kw in ({"devices": ["cpu"]},
               {"devices": SHARDS, "variants": ("int8",)}):
        with pytest.raises(MXNetError):
            ShardedVariantSet(symbol, args, aux, "data", feature, **kw)
    jsym, jargs, jaux, _ = _mlp(mx)
    d0 = jax.local_devices()[0]
    with pytest.raises(mx.base.MXNetError, match="repeat"):
        JaxSliceSet(jsym, jargs, jaux, "data", feature, devices=(d0, d0))


def test_gateway_tp2_matches_the_jax_slice_within_bound():
    symbol, args, aux, feature = _mlp(tmx)
    jsym, jargs, jaux, _ = _mlp(mx)
    jgw = mx.serving.Gateway()
    gw = Gateway(devices=SHARDS)
    try:
        jgw.register("m", jsym, jargs, jaux, input_shapes={"data": feature},
                     variants=("fp32",), buckets=(1, 4), max_wait_ms=0.0,
                     tp=2)
        gw.register("m", symbol, args, aux, input_shapes={"data": feature},
                    variants=("fp32", "bf16"), buckets=(1, 4),
                    max_wait_ms=0.0, tp=2)
        st = gw.stats()["m"]
        assert st["tp"] == 2 and st["degraded"] is True
        assert st["replicas"][0]["device"] == ["cpu", "cpu"]
        rng = np.random.default_rng(1)
        for rows in (1, 3, 4):
            x = rng.normal(0, 1, (rows,) + feature).astype(np.float32)
            got = gw.infer("m", x)
            want = jgw.infer("m", x)
            assert [g.shape for g in got] == [w.shape for w in want]
            assert max(_dist(g, w) for g, w in zip(got, want)) <= \
                DIVERGENCE_BOUND
            assert gw.infer("m", x, variant="bf16")[0].dtype == np.float32
    finally:
        gw.close()
        jgw.close()


def test_gateway_tp_refuses_int8_and_bad_tp_and_reads_the_env(monkeypatch):
    symbol, args, aux, feature = _mlp(tmx)
    gw = Gateway(devices=SHARDS)
    try:
        with pytest.raises(ServingError, match="int8"):
            gw.register("m8", symbol, args, aux,
                        input_shapes={"data": feature},
                        variants=("fp32", "int8"), tp=2,
                        calib_data=np.zeros((4,) + feature, np.float32))
        with pytest.raises(ServingError):
            gw.register("mneg", symbol, args, aux,
                        input_shapes={"data": feature}, tp=-2)
        gw.register("m1", symbol, args, aux, input_shapes={"data": feature},
                    buckets=(1,), max_wait_ms=0.0, tp=1)
        assert gw.stats()["m1"]["tp"] is None
        monkeypatch.setenv("MXTPU_SERVING_TP", "2")
        gw.register("envm", symbol, args, aux,
                    input_shapes={"data": feature}, buckets=(1,),
                    max_wait_ms=0.0)
        assert gw.stats()["envm"]["tp"] == 2
    finally:
        gw.close()


def test_gateway_tp_scale_out_and_in_over_slices():
    symbol, args, aux, feature = _mlp(tmx)
    gw = Gateway(devices=SHARDS)
    try:
        gw.register("sc", symbol, args, aux, input_shapes={"data": feature},
                    buckets=(1,), max_wait_ms=0.0, tp=2)
        rep = gw.scale("sc", 2)
        assert rep["added"] == 1 and rep["degraded"] is True
        m = gw._get_model("sc")
        assert [len(r.device) for r in m.replicas] == [2, 2]
        x = np.zeros((1,) + feature, np.float32)
        assert gw.infer("sc", x)[0].shape == (1, 10)
        rep = gw.scale("sc", 1)
        assert rep["retired"] == 1
        assert gw.infer("sc", x)[0].shape == (1, 10)
    finally:
        gw.close()
