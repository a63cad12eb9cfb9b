"""The port's attention (mxnet_tpu_torch.ops.attention) against the JAX
package on the same numpy inputs: the plain paged and flash versions
against the JAX references and the Pallas kernels in interpret mode,
the seq_len-0 padding contract, the wrappers' device routing (a CPU
tensor takes the plain path and launches nothing; anything else the
kernel cannot take raises), and the arithmetic of the Hopper kernels
emulated in plain torch: the flash kernel's 3xTF32 products and its
split online softmax, the paged kernel's split-KV and merge. The
gradient: the port's plain backward and torch autograd through the
CPU path against ``jax.grad`` of the Pallas forward (whose custom VJP is
``_chunked_attention_bwd``), and the backward kernel's two passes over
64-row tiles with the forward's log-sum-exp, emulated."""
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


# ---------------------------------------------------------------------------
# the Hopper kernels' arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------

def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped bits to
    the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the flash kernel's 3xTF32: each operand split into a TF32
    big part and a TF32 small part, the small cross terms summed before
    the big product, in f32 (a product of two TF32 values is exact in
    f32)."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _flash_emulated(q, k, v, causal, mm, stage=64, warps=4):
    """csrc/flash_attention.cu's order of work on (BH, T, D): keys in
    64-key stages, each stage's keys split over 4 warps of 16, each warp
    an online softmax of its own over the same query rows (a masked score
    gets p = 0, a row no key has reached keeps m = -1e30), then the warps'
    (m, l, acc) merged. Chunks the kernel skips are fully masked here,
    which leaves the state unchanged as the skip does."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    qs = q * d ** -0.5
    rows = torch.arange(t_q)[:, None]
    chunk = stage // warps
    m = torch.full((warps, bh, t_q), att.NEG_INF)
    l = torch.zeros(warps, bh, t_q)
    acc = torch.zeros(warps, bh, t_q, d)
    for s0 in range(0, t_k, stage):
        for w in range(warps):
            c0 = s0 + w * chunk
            if c0 >= t_k:
                continue
            keys = torch.arange(c0, min(c0 + chunk, t_k))
            ok = (keys[None, :] <= rows) if causal else \
                torch.ones(t_q, len(keys), dtype=torch.bool)
            sc = torch.where(ok, mm(qs, k[:, keys].transpose(1, 2)),
                             torch.tensor(att.NEG_INF))
            mn = torch.maximum(m[w], sc.max(-1).values)
            alpha = torch.exp(m[w] - mn)
            p = torch.where(ok, torch.exp(sc - mn[..., None]),
                            torch.tensor(0.0))
            l[w] = l[w] * alpha + p.sum(-1)
            acc[w] = acc[w] * alpha[..., None] + mm(p, v[:, keys])
            m[w] = mn
    f = torch.exp(m - m.max(0).values)
    return (acc * f[..., None]).sum(0) / (l * f).sum(0).clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [16, 48, 512])
def test_flash_3xtf32_emulation_meets_fp32_tolerance(t, causal):
    """The kernel's 3xTF32 products with its stage/warp split of the
    online softmax agree with the JAX package's dense reference within
    chip_smoke.py's FLASH_TOL (1e-4 max abs) at the serving head size."""
    q, k, v = _flash_inputs((2, t, 64), seed=10 + t)
    ref = np.asarray(pk._dense_reference(q, k, v, causal, 64 ** -0.5))
    got = _flash_emulated(*_t(q, k, v), causal, _mm_3xtf32).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def test_flash_1xtf32_emulation_misses_fp32_tolerance():
    """Plain TF32 (one product of the rounded operands) is what 3xTF32
    avoids: at T 512, causal, D 64 it is 1.06e-3 off the dense
    reference, ten times FLASH_TOL, where 3xTF32 is 8.0e-7 off (the
    reference's own f32 rounding included)."""
    q, k, v = _flash_inputs((2, 512, 64), seed=10 + 512)
    ref = np.asarray(pk._dense_reference(q, k, v, True, 64 ** -0.5))
    one = _flash_emulated(*_t(q, k, v), True, _mm_1xtf32).numpy()
    three = _flash_emulated(*_t(q, k, v), True, _mm_3xtf32).numpy()
    assert np.abs(one - ref).max() > 1e-4
    assert np.abs(three - ref).max() < 1e-2 * np.abs(one - ref).max()


def _paged_split_emulated(q, kc, vc, tables, lens, chunk):
    """csrc/paged_attention.cu's split-KV: each sequence cut into
    ``chunk``-token splits by position (a split may start inside a pool
    block); a split at or past the sequence's length is neither computed
    nor merged; each live split's (max, sum, acc) merged; a seq_len-0
    row is zeros."""
    b, h, d = q.shape
    nb, bt = kc.shape[:2]
    width = tables.shape[1]
    out = torch.zeros(b, h, d)
    for i in range(b):
        n = min(int(lens[i]), width * bt)
        parts = []
        for t0 in range(0, width * bt, chunk):
            if t0 >= n:
                continue
            tok = torch.arange(t0, min(t0 + chunk, n))
            blk = tables[i, tok // bt].long().clamp(0, nb - 1)
            kr, vr = kc[blk, tok % bt], vc[blk, tok % bt]   # (n_s, H, D)
            sc = torch.einsum("hd,thd->ht", q[i] * d ** -0.5, kr)
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("ht,thd->hd", p, vr)))
        if parts:
            mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
            f = [torch.exp(pm - mx) for pm, _, _ in parts]
            out[i] = sum(a * fi[:, None] for (_, _, a), fi in zip(parts, f)) \
                / sum(pl * fi for (_, pl, _), fi in zip(parts, f))[:, None]
    return out


@pytest.mark.parametrize("chunk", [64, 24, 10])
def test_paged_split_kv_emulation_matches_jax(chunk):
    """Split and merge against the JAX gather reference at the paged
    tolerance: seq_len 0, lengths 1, 15, 16, 17, on both sides of the
    chunk, and the full table; empty splits; chunks of 64 tokens (the
    kernel's) and of 24 and 10, whose edges fall inside 16-token blocks."""
    width, bt = 6, 16
    lens = np.array([0, 1, 15, 16, 17, chunk - 1, chunk, chunk + 1,
                     width * bt], np.int32)
    rng = np.random.default_rng(chunk)
    tables = np.zeros((len(lens), width), np.int32)
    ids = rng.permutation(np.arange(1, 64))
    at = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // bt)
        tables[i, :need] = ids[at:at + need]
        at += need
    q, kc, vc, tables, lens = _paged_case(seed=chunk, b=len(lens), h=2, d=64,
                                          bt=bt, nb=64, tables=tables,
                                          lens=lens)
    got = _paged_split_emulated(*_t(q, kc, vc, tables, lens), chunk).numpy()
    ref = np.asarray(pk._paged_gather_reference(q, kc, vc, tables, lens,
                                                64 ** -0.5))
    live = lens > 0
    assert np.abs(got - ref)[live].max() < PAGED_ATOL
    assert not got[~live].any()


# ---------------------------------------------------------------------------
# the gradient: against jax.grad of the Pallas forward, and the backward
# kernel's two-pass tiling emulated
# ---------------------------------------------------------------------------

def _bwd_case(case):
    """(q, k, v, d_out) numpy for JAX and the port's torch views of them,
    and causal."""
    rng = np.random.default_rng({"causal": 20, "rect": 21,
                                 "strided": 22}[case])
    if case == "causal":
        q, k, v = (rng.standard_normal((2, 128, 16)).astype(np.float32)
                   for _ in range(3))
        views = _t(q, k, v)
    elif case == "rect":
        q = rng.standard_normal((2, 128, 16)).astype(np.float32)
        k, v = (rng.standard_normal((2, 192, 16)).astype(np.float32)
                for _ in range(2))
        views = _t(q, k, v)
    else:
        # (B, H, T, D) views into one (B, T, 3, H, D) projection
        qkv = torch.from_numpy(rng.standard_normal((2, 64, 3, 2, 16))
                               .astype(np.float32))
        views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        q, k, v = (x.contiguous().numpy() for x in views)
    g = rng.standard_normal(q.shape).astype(np.float32)
    return (q, k, v, g), views, case != "rect"


def _jax_flash_grads(q, k, v, g, causal):
    import jax
    import jax.numpy as jnp

    def f(q, k, v):
        out = pk.flash_attention(q, k, v, causal=causal, force=True,
                                 interpret=True, block_q=64, block_k=64)
        return jnp.sum(out * g)

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("case", ["causal", "rect", "strided"])
def test_flash_gradient_matches_jax_grad_of_pallas_kernel(case):
    (q, k, v, g), views, causal = _bwd_case(case)
    want = _jax_flash_grads(q, k, v, g, causal)
    gt = torch.from_numpy(g)
    out = att.flash_attention_plain(*views, causal=causal)
    plain = att.flash_attention_bwd_plain(*views, out, gt, causal,
                                          block_q=48)
    leaves = [x.detach().clone().requires_grad_(True) for x in views]
    tout = att.flash_attention(*leaves, causal=causal)
    auto = torch.autograd.grad(tout, leaves, gt)
    for got in (plain, auto):
        for a, w in zip(got, want):
            assert a.shape == w.shape
            np.testing.assert_allclose(a.numpy(), w, rtol=FLASH_RTOL,
                                       atol=FLASH_ATOL)


def _lse(q, k, causal, scale):
    """Each row's log-sum-exp of the scaled (masked) scores: what the
    forward kernel writes for the backward."""
    s = scale * (q @ k.transpose(-1, -2))
    if causal:
        t_q, t_k = q.shape[-2], k.shape[-2]
        ok = torch.arange(t_k)[None, :] <= \
            torch.arange(t_q)[:, None] + (t_k - t_q)
        s = torch.where(ok, s, torch.tensor(float("-inf")))
    return torch.logsumexp(s, dim=-1)


def test_flash_bwd_wrapper_on_cpu_takes_plain_and_launches_nothing():
    att.reset_launches()
    (q, k, v, g), views, causal = _bwd_case("causal")
    out = att.flash_attention(*views, causal=causal)
    lse = _lse(*views[:2], causal, 16 ** -0.5)
    got = att.flash_attention_bwd(*views, out, torch.from_numpy(g), lse,
                                  causal)
    want = att.flash_attention_bwd_plain(*views, out, torch.from_numpy(g),
                                         causal)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert lse.shape == (2, 128)
    assert att.flash_attention.launches == 0
    assert att.flash_attention_bwd.launches == 0


def _bwd_emulated(q, k, v, out, g, lse, causal, scale, blk=64):
    """csrc/flash_attention_bwd.cu's order of work on (BH, T, D):
    D = rowsum(dO * O); pass 2 walks each 64-key block's query blocks
    (from the diagonal when causal) summing dV += P^T dO and
    dK += dS^T Q; pass 3 walks each 64-row query block's key blocks
    summing dQ += dS K; P = exp(scale * S - lse) recomputed in both,
    zero where masked."""
    t_q, t_k = q.shape[1], k.shape[1]
    d_vec = (g * out).sum(-1)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))

    def tile(q0, k0):
        rows = torch.arange(q0, min(q0 + blk, t_q))
        keys = torch.arange(k0, min(k0 + blk, t_k))
        s = q[:, rows] @ k[:, keys].transpose(1, 2)
        dp = g[:, rows] @ v[:, keys].transpose(1, 2)
        ok = keys[None, :] <= rows[:, None] if causal else \
            torch.ones(len(rows), len(keys), dtype=torch.bool)
        p = torch.where(ok, torch.exp(scale * s - lse[:, rows, None]),
                        torch.tensor(0.0))
        return rows, keys, p, p * (dp - d_vec[:, rows, None])

    for k0 in range(0, t_k, blk):
        for q0 in range(k0 if causal else 0, t_q, blk):
            rows, keys, p, ds = tile(q0, k0)
            dv[:, keys] += p.transpose(1, 2) @ g[:, rows]
            dk[:, keys] += ds.transpose(1, 2) @ q[:, rows]
    for q0 in range(0, t_q, blk):
        for k0 in range(0, min(q0 + blk, t_k) if causal else t_k, blk):
            rows, keys, p, ds = tile(q0, k0)
            dq[:, rows] += ds @ k[:, keys]
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("t_q,t_k,causal", [(100, 100, True),
                                            (192, 192, True),
                                            (130, 70, False),
                                            (64, 200, False)])
def test_flash_bwd_two_pass_emulation_matches_plain(t_q, t_k, causal):
    """The kernel's tiling with the forward's log-sum-exp and its causal
    skips gives the plain backward's gradient: the skipped blocks are
    the fully masked ones, and the ragged tails add nothing."""
    rng = np.random.default_rng(t_q * 1000 + t_k)
    q = rng.standard_normal((3, t_q, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, t_k, 16)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    q, k, v, g = _t(q, k, v, g)
    out = att.flash_attention_plain(q, k, v, causal)
    lse = _lse(q, k, causal, 16 ** -0.5)
    got = _bwd_emulated(q, k, v, out, g, lse, causal, 16 ** -0.5)
    want = att.flash_attention_bwd_plain(q, k, v, out, g, causal)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=FLASH_RTOL,
                                   atol=FLASH_ATOL)
