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
token for token, and ``stats()["tp"]``, ``scale`` over slices, the
``MXTPU_SERVING_TP`` default and ``register(tp=2)``'s refusal hold.

The decoder is the JAX tp test's (vocab 50, d_model 32, 2 layers of 4
heads; 2 heads a shard) with weights drawn from a numpy seed (std 0.4,
so the greedy streams vary), carried to the port by ``params_from_jax``;
the JAX references come once per module through the hybridized JAX
block. Tokens exact; no subprocess; every wait bounded."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.serving.generate import BlockPool as JaxPool
from mxnet_tpu.serving.generate import GenerativeDecoder as JaxDecoder
from mxnet_tpu.serving.generate import reference_generate as jax_reference
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import Gateway, ServingError
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
    gw = Gateway(devices=SHARDS)
    try:
        with pytest.raises(ServingError, match="ShardedVariantSet"):
            gw.register("m", None, {}, {}, input_shapes={"data": (4,)},
                        tp=2)
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
