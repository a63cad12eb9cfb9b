"""The port's attention (mxnet_tpu_torch.ops.attention) against the JAX
package on the same numpy inputs: the plain paged and flash versions
against the JAX references and the Pallas kernels in interpret mode,
the seq_len-0 padding contract, and the wrappers' device routing (a
CPU tensor takes the plain path and launches nothing; anything else the
kernel cannot take raises)."""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as att

# the Pallas paged kernel and its gather fallback agree to 2e-6 in the
# JAX package's own test (online vs two-pass softmax); the port's plain
# version is held to the same bound against both
PAGED_ATOL = 2e-6
# tests/test_pallas_attention.py's bounds for fp32 flash vs dense
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-5


def _paged_case(seed=0, b=3, h=2, d=8, bt=4, nb=6, tables=None, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kc = rng.normal(size=(nb, bt, h, d)).astype(np.float32)
    vc = rng.normal(size=(nb, bt, h, d)).astype(np.float32)
    if tables is None:
        tables = np.array([[1, 2, 3], [4, 0, 0], [5, 2, 0]], np.int32)
        lens = np.array([10, 3, 1], np.int32)
    return q, kc, vc, np.asarray(tables, np.int32), np.asarray(lens, np.int32)


def _wide_case():
    """Serving-like shapes: head_dim 64, 16-token blocks, lengths on
    both sides of block boundaries."""
    rng = np.random.default_rng(7)
    lens = np.array([1, 15, 16, 17, 33, 64], np.int32)
    tables = np.zeros((len(lens), 4), np.int32)
    ids = rng.permutation(np.arange(1, 32))
    at = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // 16)
        tables[i, :need] = ids[at:at + need]
        at += need
    return _paged_case(seed=3, b=len(lens), h=2, d=64, bt=16, nb=32,
                       tables=tables, lens=lens)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", ["small", "wide"])
def test_paged_plain_matches_jax_reference_and_pallas_kernel(case):
    q, kc, vc, tables, lens = _paged_case() if case == "small" \
        else _wide_case()
    scale = q.shape[-1] ** -0.5
    got = att.paged_attention(*_t(q, kc, vc, tables, lens)).numpy()
    ref = np.asarray(pk._paged_gather_reference(q, kc, vc, tables, lens,
                                                scale))
    kern = np.asarray(pk.paged_attention(q, kc, vc, tables, lens,
                                         force=True))
    live = lens > 0
    assert np.abs(got - ref)[live].max() < PAGED_ATOL
    assert np.abs(got - kern)[live].max() < PAGED_ATOL


def test_paged_plain_explicit_scale_matches_jax():
    q, kc, vc, tables, lens = _paged_case(seed=1)
    got = att.paged_attention(*_t(q, kc, vc, tables, lens),
                              scale=0.3).numpy()
    ref = np.asarray(pk._paged_gather_reference(q, kc, vc, tables, lens,
                                                0.3))
    assert np.abs(got - ref).max() < PAGED_ATOL


def test_paged_zero_len_row_does_not_poison_neighbours():
    q, kc, vc, tables, lens = _paged_case()
    lens2 = lens.copy()
    lens2[2] = 0
    a = att.paged_attention(*_t(q, kc, vc, tables, lens)).numpy()
    b = att.paged_attention(*_t(q, kc, vc, tables, lens2)).numpy()
    np.testing.assert_array_equal(a[:2], b[:2])
    assert np.isfinite(b).all()


def _flash_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_reference_and_pallas_kernel(causal):
    b, h, t, d = 2, 2, 256, 32
    q, k, v = _flash_inputs((b, h, t, d), seed=0)
    got = att.flash_attention(*_t(q, k, v), causal=causal).numpy()
    ref = np.asarray(pk._dense_reference(
        q.reshape(b * h, t, d), k.reshape(b * h, t, d),
        v.reshape(b * h, t, d), causal, d ** -0.5)).reshape(b, h, t, d)
    kern = np.asarray(pk.flash_attention(q, k, v, causal=causal,
                                         force=True, block_q=128,
                                         block_k=128))
    np.testing.assert_allclose(got, ref, rtol=FLASH_RTOL, atol=FLASH_ATOL)
    np.testing.assert_allclose(got, kern, rtol=FLASH_RTOL, atol=FLASH_ATOL)


def test_flash_plain_3d_form_matches_pallas_kernel():
    q, k, v = _flash_inputs((4, 128, 16), seed=1)
    got = att.flash_attention(*_t(q, k, v), causal=True).numpy()
    kern = np.asarray(pk.flash_attention(q, k, v, causal=True, force=True,
                                         block_q=64, block_k=64))
    assert got.shape == (4, 128, 16)
    np.testing.assert_allclose(got, kern, rtol=FLASH_RTOL, atol=FLASH_ATOL)


@pytest.mark.parametrize("t_q,t_k", [(48, 48), (5, 9), (7, 7)])
def test_flash_plain_ragged_and_decoder_offset_match_dense(t_q, t_k):
    """Lengths no Pallas block tiles (the port's kernel takes any T) and
    the decoder convention for causal t_q < t_k."""
    rng = np.random.default_rng(t_q * 100 + t_k)
    q = rng.standard_normal((3, t_q, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, t_k, 16)).astype(np.float32)
            for _ in range(2))
    got = att.flash_attention(*_t(q, k, v), causal=True, scale=0.2).numpy()
    ref = np.asarray(pk._dense_reference(q, k, v, True, 0.2))
    np.testing.assert_allclose(got, ref, rtol=FLASH_RTOL, atol=FLASH_ATOL)


def test_flash_plain_strided_views_match_contiguous():
    """The prefill step hands the kernel (1, H, T, hd) views into one
    (1, T, 3d) projection; the plain path must not care."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((1, 20, 3 * 32))
                           .astype(np.float32))
    views = [y.view(1, 20, 4, 8).transpose(1, 2) for y in qkv.chunk(3, -1)]
    got = att.flash_attention(*views, causal=True)
    want = att.flash_attention(*[x.contiguous() for x in views], causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_causal_with_more_queries_than_keys_raises():
    q, k, v = _t(*_flash_inputs((2, 8, 16), seed=2))
    with pytest.raises(MXNetError):
        att.flash_attention(q, k[:, :4], v[:, :4], causal=True)


def test_cpu_tensors_take_plain_path_and_launch_nothing():
    att.reset_launches()
    q, k, v = _t(*_flash_inputs((1, 2, 16, 8), seed=3))
    out = att.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(
        out, att.flash_attention_plain(q, k, v, causal=True), rtol=0, atol=0)
    pq, kc, vc, tables, lens = _t(*_paged_case())
    pout = att.paged_attention(pq, kc, vc, tables, lens)
    torch.testing.assert_close(
        pout, att.paged_attention_plain(pq, kc, vc, tables, lens),
        rtol=0, atol=0)
    assert att.flash_attention.launches == 0
    assert att.paged_attention.launches == 0


@pytest.mark.parametrize("which", ["flash", "paged"])
def test_wrappers_raise_on_devices_they_cannot_serve(which):
    """No silent fallback: a tensor neither on the CPU nor on CUDA, or
    inputs split across devices, raise."""
    if which == "flash":
        q, k, v = _t(*_flash_inputs((1, 2, 16, 8), seed=4))
        with pytest.raises(MXNetError):
            att.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
        with pytest.raises(MXNetError):
            att.flash_attention(q, k.to("meta"), v)
    else:
        q, kc, vc, tables, lens = _t(*_paged_case())
        with pytest.raises(MXNetError):
            att.paged_attention(q.to("meta"), kc.to("meta"),
                                vc.to("meta"), tables.to("meta"),
                                lens.to("meta"))
        with pytest.raises(MXNetError):
            att.paged_attention(q, kc, vc, tables.to("meta"), lens)
