"""bf16-KV generative serving, the port against the JAX package on the
same weights: ``GenerativeDecoder(dtype="bfloat16")`` (Embedding and
Dense weights bf16, LayerNorm f32, as the JAX ``_build_block``) with a
bf16 paged pool, served through ``Gateway.register_generator`` at
tests/test_torch_generate.py's size. LayerNorm's f32 parameters promote
the residual stream to f32, so the prefill's flash attention runs on
f32 q/k/v and the decode step's paged attention on f32 queries over the
bf16 cache, in both packages; the K/V written into the pool round to
bf16 there. Greedy tokens are compared exactly: the gateway's against
the JAX gateway's, and against ``reference_generate`` where the JAX
package's equal it (that oracle's K/V are not rounded to bf16)."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.serving import Gateway as JaxGateway
from mxnet_tpu.serving.generate import GenerativeDecoder as JaxDecoder
from mxnet_tpu.serving.generate import reference_generate as jax_reference
from mxnet_tpu_torch.serving import Gateway
from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                              params_from_jax,
                                              reference_generate)
from mxnet_tpu_torch.serving.generate import model as port_model

VOCAB = 50
CFG = dict(vocab_size=VOCAB, d_model=32, num_layers=2, num_heads=4,
           max_prompt_tokens=12, dtype="bfloat16")
LANE = dict(block_tokens=4, max_blocks=64, max_new_tokens=12,
            max_decode_batch=4)
PROMPTS = [([3, 7, 11, 2, 9], 8), ([1], 12), ([4, 4, 8, 15, 16, 23, 42,
                                              5, 6], 6), ([2, 4, 6, 8], 10)]


@pytest.fixture(scope="module")
def decoders():
    mx.random.seed(0)
    jdec = JaxDecoder(**CFG)
    tree = jax.tree_util.tree_map(np.asarray, jdec.param_tree())
    dec = GenerativeDecoder(**CFG, device="cpu")
    dec.load_state_dict(params_from_jax(tree))
    return jdec, dec, tree


@pytest.fixture(scope="module")
def jax_tokens(decoders):
    jdec = decoders[0]
    gw = JaxGateway()
    try:
        gw.register_generator("lm", jdec, **LANE)
        return [gw.generate("lm", p, max_new_tokens=n) for p, n in PROMPTS]
    finally:
        gw.close()


def test_parameter_types_and_values_match_jax(decoders):
    jdec, dec, tree = decoders
    jps = list(jdec.block.collect_params().values())
    tps = list(dec.block.collect_params().values())
    assert [str(p.data().dtype) for p in tps] == \
        [str(p.data().dtype) for p in jps]
    kinds = {p.name.rsplit("_", 1)[-1]: str(p.data().dtype) for p in tps}
    assert kinds == {"weight": "bfloat16", "bias": "bfloat16",
                     "gamma": "float32", "beta": "float32"}
    assert dec.dtype == torch.bfloat16
    for a, b in zip(tps, jps):
        np.testing.assert_array_equal(
            a.data().asnumpy().view(np.uint16) if a.data().dtype.name ==
            "bfloat16" else a.data().asnumpy(),
            b.data().asnumpy().view(np.uint16) if b.data().dtype.name ==
            "bfloat16" else b.data().asnumpy())


def test_gateway_tokens_equal_the_jax_gateway(decoders, jax_tokens,
                                              monkeypatch):
    """Also: the pool is bf16 and sized by its item size, and every
    decode step's paged attention gets f32 q over bf16 caches."""
    _, dec, _ = decoders
    seen = set()
    paged = port_model.paged_attention

    def spy(q, k_cache, v_cache, *a, **kw):
        seen.add((q.dtype, k_cache.dtype, v_cache.dtype))
        return paged(q, k_cache, v_cache, *a, **kw)

    monkeypatch.setattr(port_model, "paged_attention", spy)
    gw = Gateway(device="cpu")
    try:
        gen = gw.register_generator("lm", dec, **LANE)
        pool = gen.lanes[0].pool
        assert pool.k.dtype == pool.v.dtype == torch.bfloat16
        assert pool.bytes_total == 2 * CFG["num_layers"] * LANE[
            "max_blocks"] * LANE["block_tokens"] * CFG["d_model"] * 2
        reqs = [gw.submit_generate("lm", p, max_new_tokens=n)
                for p, n in PROMPTS]
        got = [r.result(60) for r in reqs]
    finally:
        gw.close()
    assert got == jax_tokens
    assert seen == {(torch.float32, torch.bfloat16, torch.bfloat16)}


def test_tokens_equal_reference_generate_where_jax_does(decoders,
                                                        jax_tokens):
    jdec, dec, _ = decoders
    agree = 0
    for (p, n), toks in zip(PROMPTS[:2], jax_tokens):
        if jax_reference(jdec, p, n) == toks:
            agree += 1
            assert reference_generate(dec, p, n) == toks
    assert agree > 0

