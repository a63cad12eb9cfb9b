"""The port's generative decode plane (mxnet_tpu_torch.serving) against
the JAX package on the same weights: paged block pool accounting,
decoder logits through ``params_from_jax``, gateway greedy decode
token for token against the JAX unpaged ``reference_generate`` (alone,
in a mid-flight join and in a mixed concurrent batch), streaming
replay, EOS stop, ``kv_cache_full`` fast-reject and bad requests. The
sizes follow tests/test_serving_generate.py."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.serving.generate import GenerativeDecoder as JaxDecoder
from mxnet_tpu.serving.generate import reference_generate as jax_reference
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import Gateway, RejectedError, ServingError
from mxnet_tpu_torch.serving.generate import (BlockPool, BlockTable,
                                              GenerativeDecoder,
                                              params_from_jax,
                                              reference_generate)

VOCAB = 50
CFG = dict(vocab_size=VOCAB, d_model=32, num_layers=2, num_heads=4,
           max_prompt_tokens=12)


def _jax_decoder(cfg):
    """The JAX decoder with its block hybridized: its references run one
    jitted forward a token count (the same tokens as the eager block,
    which compiles every op again for each new sequence length)."""
    dec = JaxDecoder(**cfg)
    dec.block.hybridize()
    return dec


@pytest.fixture(scope="module")
def jax_decoder():
    mx.random.seed(0)
    return _jax_decoder(CFG)


def _port_decoder(jax_dec, eos_id=None):
    tree = jax.tree_util.tree_map(np.asarray, jax_dec.param_tree())
    dec = GenerativeDecoder(**CFG, eos_id=eos_id, device="cpu")
    dec.load_state_dict(params_from_jax(tree))
    return dec


@pytest.fixture(scope="module")
def decoder(jax_decoder):
    return _port_decoder(jax_decoder)


@pytest.fixture(scope="module")
def gateway(decoder):
    gw = Gateway(device="cpu")
    gw.register_generator("lm", decoder, block_tokens=4, max_blocks=64,
                          max_new_tokens=12, max_decode_batch=4)
    yield gw
    gw.close()


def _pool(max_blocks):
    return BlockPool(num_layers=1, num_heads=2, head_dim=4, block_tokens=4,
                     max_blocks=max_blocks, device="cpu")


# -- block pool units --------------------------------------------------------
def test_block_pool_alloc_free_accounting():
    pool = _pool(8)
    assert pool.usable_blocks == 7          # block 0 = pad sink
    assert (pool.blocks_for(1), pool.blocks_for(4), pool.blocks_for(5)) \
        == (1, 1, 2)
    got = pool.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert pool.used_blocks() == 3
    occ = pool.occupancy()
    assert occ["used_blocks"] == 3 and occ["free_blocks"] == 4
    assert occ["bytes_total"] == pool.k.nbytes + pool.v.nbytes
    # K and V are two allocations, never aliased
    assert pool.k.data_ptr() != pool.v.data_ptr()
    pool.free(got)
    assert pool.used_blocks() == 0
    with pytest.raises(MXNetError):
        pool.alloc(8)                       # past the free list: a bug


def test_block_pool_lifo_reissue():
    pool = _pool(8)
    a = pool.alloc(2)
    pool.free(a)
    assert pool.alloc(1) == [a[-1]]         # last freed, first re-issued


def test_block_pool_reservation():
    pool = _pool(8)
    assert pool.reserve(5)
    assert pool.reserve(2)
    assert not pool.reserve(1)              # 7 usable, 7 reserved
    pool.unreserve(2)
    assert pool.reserve(2)
    pool.unreserve(100)
    assert pool.reserved_blocks() == 0
    pool.close()
    assert not pool.reserve(1) and pool.bytes_total == 0
    with pytest.raises(MXNetError):
        pool.alloc(1)


def test_block_table_grow_and_overflow():
    pool = _pool(16)
    t = BlockTable(pool, width=3)
    t.ensure_position(0)
    assert len(t.blocks) == 1
    t.ensure_position(7)                    # positions 0..7 -> 2 blocks
    assert len(t.blocks) == 2
    t.ensure_position(8)
    assert len(t.blocks) == 3
    assert list(t.row[:3]) == t.blocks
    with pytest.raises(MXNetError):
        t.ensure_position(12)               # width 3 exceeded
    assert len(t.blocks) == 3               # no partial state
    t.release()
    assert pool.used_blocks() == 0 and not t.blocks
    assert sorted(pool.alloc(pool.usable_blocks)) == \
        list(range(1, pool.max_blocks))


# -- the decoder against the JAX one -----------------------------------------
def test_params_from_jax_logits_match(jax_decoder, decoder):
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 9))
    want = jax_decoder.full_logits(tokens).asnumpy()
    got = decoder.full_logits(tokens).asnumpy()
    assert got.shape == (2, 9, VOCAB)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_params_from_jax_covers_every_parameter(jax_decoder, decoder):
    tree = jax.tree_util.tree_map(np.asarray, jax_decoder.param_tree())
    assert set(params_from_jax(tree)) == set(decoder.state_dict())


def test_seeded_init_follows_gluon_defaults():
    a = GenerativeDecoder(**CFG, device="cpu", seed=3).state_dict()
    b = GenerativeDecoder(**CFG, device="cpu", seed=3).state_dict()
    assert list(a) == list(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert torch.all(a["layers.0.ln1.gamma"] == 1)
    assert torch.all(a["layers.0.ln1.beta"] == 0)
    assert torch.all(a["layers.0.qkv.bias"] == 0)
    w = a["layers.0.qkv.weight"]
    assert w.abs().max() <= 0.07 and w.std() > 0.03   # Uniform(0.07)


@pytest.fixture(scope="module")
def greedy_ref(jax_decoder):
    """The JAX reference of the prompt two tests hold to it, computed
    once (the eager JAX decode dispatches every op of every step)."""
    prompt = [3, 7, 11, 2, 9]
    return prompt, jax_reference(jax_decoder, prompt, 8)


def test_port_reference_equals_jax_reference(greedy_ref, decoder):
    prompt, want = greedy_ref
    assert reference_generate(decoder, prompt, 8) == want


# -- gateway greedy decode vs the JAX oracle ---------------------------------
def test_gateway_greedy_equals_jax_reference(gateway, greedy_ref):
    prompt, want = greedy_ref
    assert gateway.generate("lm", prompt, max_new_tokens=8) == want


def test_midflight_join_keeps_streams_token_exact(gateway, jax_decoder):
    ra = gateway.submit_generate("lm", [2, 4, 6], max_new_tokens=12)
    deadline = time.time() + 5.0
    while not ra.tokens and time.time() < deadline:
        time.sleep(0.001)
    rb = gateway.submit_generate("lm", [3, 5, 7], max_new_tokens=5)
    got_a, got_b = ra.result(30), rb.result(30)
    assert got_a == jax_reference(jax_decoder, [2, 4, 6], 12)
    assert got_b == jax_reference(jax_decoder, [3, 5, 7], 5)


def test_concurrent_mixed_batch_token_exact(gateway, jax_decoder):
    """Six requests with prompts across every prompt bucket and budgets
    that retire at different steps share the decode batch."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, VOCAB, n).tolist()
               for n in (1, 4, 5, 9, 12, 7)]
    budgets = [12, 3, 7, 10, 1, 6]
    reqs = [gateway.submit_generate("lm", p, max_new_tokens=n)
            for p, n in zip(prompts, budgets)]
    for req, p, n in zip(reqs, prompts, budgets):
        assert req.result(60) == jax_reference(jax_decoder, p, n)


def test_streaming_iterator_is_replayable(gateway):
    req = gateway.generate("lm", [1, 2, 3], max_new_tokens=6, stream=True)
    seen = list(req.stream())
    assert seen == req.result(1.0)
    assert len(seen) == 6
    assert list(req.stream()) == seen


def test_eos_stops_generation(jax_decoder):
    free = jax_reference(jax_decoder, [5, 9, 1], 10)
    eos = free[3]
    stop = free.index(eos)                   # first occurrence wins
    gw = Gateway(device="cpu")
    try:
        gw.register_generator("lm_eos", _port_decoder(jax_decoder, eos),
                              block_tokens=4, max_blocks=32,
                              max_new_tokens=10, max_decode_batch=2,
                              warmup=False)
        out = gw.generate("lm_eos", [5, 9, 1], max_new_tokens=10)
        assert out == free[:stop + 1]
        assert out[-1] == eos
    finally:
        gw.close()


# -- admission ---------------------------------------------------------------
def test_kv_cache_full_fast_reject(decoder):
    gw = Gateway(device="cpu")
    try:
        # table width = (pad(12)+pad(12))/4 = 6; pool of 8 -> 7 usable:
        # one max-budget request reserves 6, a second cannot fit
        gw.register_generator("lm_small", decoder, block_tokens=4,
                              max_blocks=8, max_new_tokens=12,
                              max_decode_batch=2, warmup=False)
        r1 = gw.submit_generate("lm_small", list(range(1, 12)),
                                max_new_tokens=12)
        t0 = time.perf_counter()
        with pytest.raises(RejectedError) as ei:
            gw.submit_generate("lm_small", list(range(1, 12)),
                               max_new_tokens=12)
        assert ei.value.reason == "kv_cache_full"
        assert time.perf_counter() - t0 < 0.1
        r1.result(60.0)
        # retirement returns the budget: admission recovers
        assert len(gw.generate("lm_small", [1, 2, 3], max_new_tokens=2)) == 2
    finally:
        gw.close()


def test_queue_full_fast_reject(decoder, monkeypatch):
    from mxnet_tpu_torch.serving.generate.scheduler import GenLane
    gw = Gateway(device="cpu")
    try:
        # a lane that has not started yet leaves admitted work queued
        monkeypatch.setattr(GenLane, "start", lambda self: None)
        gen = gw.register_generator("lm_q", decoder, block_tokens=4,
                                    max_blocks=32, max_new_tokens=4,
                                    max_decode_batch=1, max_queue=1,
                                    warmup=False)
        r1 = gw.submit_generate("lm_q", [1, 2], max_new_tokens=4)
        with pytest.raises(RejectedError) as ei:
            gw.submit_generate("lm_q", [3], max_new_tokens=4)
        assert ei.value.reason == "queue_full"
        monkeypatch.undo()
        gen.lanes[0].start()
        assert len(r1.result(30)) == 4
    finally:
        gw.close()


def test_bad_requests_raise_not_reject(gateway):
    with pytest.raises(ServingError):
        gateway.submit_generate("lm", list(range(100)))   # > max_prompt
    with pytest.raises(ServingError):
        gateway.submit_generate("lm", [])
    with pytest.raises(ServingError):
        gateway.submit_generate("lm", [1], max_new_tokens=999)
    with pytest.raises(ServingError):
        gateway.submit_generate("nope", [1])


def test_pool_too_small_for_one_request_fails_registration(decoder):
    gw = Gateway(device="cpu")
    try:
        with pytest.raises(ServingError):
            gw.register_generator("lm_tiny", decoder, block_tokens=4,
                                  max_blocks=4, max_new_tokens=12,
                                  warmup=False)
        # the failed registration released its name
        gw.register_generator("lm_tiny", decoder, block_tokens=4,
                              max_blocks=32, max_new_tokens=12,
                              warmup=False)
        with pytest.raises(ServingError):
            gw.register_generator("lm_tiny", decoder, block_tokens=4,
                                  max_blocks=32, warmup=False)
    finally:
        gw.close()


def test_close_fails_pending_and_rejects_new(decoder):
    gw = Gateway(device="cpu")
    gw.register_generator("lm_close", decoder, block_tokens=4,
                          max_blocks=32, max_new_tokens=12,
                          max_decode_batch=1, warmup=False)
    reqs = [gw.submit_generate("lm_close", [1, 2], max_new_tokens=12)
            for _ in range(3)]
    gw.close()
    for req in reqs:
        assert req.done()
        try:
            assert len(req.result(1.0)) == 12   # finished before close
        except ServingError:
            pass                                # failed cleanly by close
    with pytest.raises(ServingError):
        gw.submit_generate("lm_close", [1])


def test_stats_count_steps_and_pool(gateway):
    gateway.generate("lm", [4, 4, 4], max_new_tokens=3)
    st = gateway.stats()["lm"]
    assert st["generator"] and st["table_width"] == 6
    assert st["prompt_buckets"] == [4, 8, 12]
    assert st["decode_buckets"] == [1, 2, 4]
    lane = st["lanes"][0]
    # warmup runs every prompt and decode bucket once, beside requests
    assert lane["step_calls"]["prefill"] == 3 + lane["prefills"]
    assert lane["step_calls"]["decode"] == 3 + lane["decode_steps"]
    assert lane["pool"]["used_blocks"] == 0    # everything retired


# -- a pool padded to the paged kernel's head size ---------------------------
def test_padded_pool_gateway_equals_jax_reference():
    """Heads of size 12 (d_model 24, 2 heads): no paged kernel is built
    for it, so the pool is laid out at head size 16 on every device, the
    decoder writes columns [:12] and the rest stay zero. The gateway's
    greedy tokens over that pool equal the JAX package's unpaged
    reference on the same weights, and the pool's bytes count its
    padded size."""
    cfg = dict(vocab_size=VOCAB, d_model=24, num_layers=1, num_heads=2,
               max_prompt_tokens=12)
    mx.random.seed(1)
    jdec = _jax_decoder(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jdec.param_tree())
    dec = GenerativeDecoder(**cfg, device="cpu")
    dec.load_state_dict(params_from_jax(tree))
    gw = Gateway(device="cpu")
    try:
        gen = gw.register_generator("lm", dec, block_tokens=4,
                                    max_blocks=16, max_new_tokens=6,
                                    max_decode_batch=2)
        pool = gen.lanes[0].pool
        assert pool.head_dim == 12 and pool.k.shape[-1] == 16
        assert pool.bytes_total == 2 * 1 * 16 * 4 * 2 * 16 * 4
        prompts = [[3, 7, 11, 2, 9], [5, 1]]
        reqs = [gw.submit_generate("lm", p, max_new_tokens=6)
                for p in prompts]
        got = [r.result(60) for r in reqs]
        assert not pool.k[..., 12:].any() and not pool.v[..., 12:].any()
        assert pool.k[..., :12].any()
    finally:
        gw.close()
    assert got == [jax_reference(jdec, p, 6) for p in prompts]


@pytest.mark.parametrize("d_model,head,pool_head", [(400, 200, 256)])
def test_wide_head_gateway_equals_jax_reference(d_model, head, pool_head):
    """Heads of size 200 (2 heads): the pool is laid out at the paged
    kernel's D 256 (zero columns past 200), and the gateway's greedy
    tokens equal the JAX package's unpaged reference on the same weights
    (the JAX package serves any head size)."""
    cfg = dict(vocab_size=VOCAB, d_model=d_model, num_layers=1, num_heads=2,
               max_prompt_tokens=8)
    mx.random.seed(2)
    jdec = _jax_decoder(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jdec.param_tree())
    dec = GenerativeDecoder(**cfg, device="cpu")
    dec.load_state_dict(params_from_jax(tree))
    gw = Gateway(device="cpu")
    try:
        gen = gw.register_generator("lm", dec, block_tokens=4,
                                    max_blocks=12, max_new_tokens=4,
                                    max_decode_batch=2)
        pool = gen.lanes[0].pool
        assert pool.head_dim == head and pool.k.shape[-1] == pool_head
        prompts = [[3, 7, 11, 2, 9], [5, 1]]
        reqs = [gw.submit_generate("lm", p, max_new_tokens=4)
                for p in prompts]
        got = [r.result(60) for r in reqs]
        assert not pool.k[..., head:].any()
    finally:
        gw.close()
    assert got == [jax_reference(jdec, p, 4) for p in prompts]
