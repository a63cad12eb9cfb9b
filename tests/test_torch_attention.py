"""The port's attention (mxnet_tpu_torch.ops.attention) against the JAX
package on the same numpy inputs: the plain paged and flash versions
against the JAX references and the Pallas kernels in interpret mode,
the seq_len-0 padding contract, the wrappers' device routing (a CPU
tensor takes the plain path and launches nothing; anything else the
kernel cannot take raises), and the arithmetic of the Hopper kernels
emulated in plain torch: the flash kernel's 3xTF32 products and its
split online softmax, the fp32 backward's 3xTF32 products (and one TF32
product shown to miss the fp32 bound), the bf16 forward's one online
softmax per row and the bf16 backward's P and dS carried as two bf16
pieces (and one piece shown to miss the card's bound), the paged
kernels' split-KV and merge and their host-side chunk choice. The
gradient: the port's plain backward and torch autograd through the
CPU path against ``jax.grad`` of the Pallas forward (whose custom VJP is
``_chunked_attention_bwd``), and the backward kernel's two passes over
64-row tiles with the forward's log-sum-exp, emulated. Every emulation
shifts the causal diagonal by T_k - T_q for T_q < T_k, as the kernels
do; and the wrappers' zero-padding of head sizes no kernel is built for
(K3 and K4's pool) is held to the unpadded plain versions."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

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


def _tf32_rz(x):
    """float32 with its 13 low mantissa bits dropped: how the tensor core
    reads an f32 register that holds no TF32 value."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b, small=_tf32):
    """a @ b as the flash kernel's 3xTF32: each operand split into a TF32
    big part and a TF32 small part (``small`` rounds x - big), the small
    cross terms summed before the big product, in f32 (a product of two
    TF32 values is exact in f32)."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = small(a - ab), small(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _mm_3xtf32_bwd(a, b):
    """The backward kernels' 3xTF32: as :func:`_mm_3xtf32`, but the small
    part x - big goes to the tensor core unrounded, which drops its low
    13 bits."""
    return _mm_3xtf32(a, b, small=_tf32_rz)


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _flash_emulated(q, k, v, causal, mm, stage=64, warps=4):
    """csrc/flash_attention.cu's order of work on (BH, T, D): keys in
    64-key stages, each stage's keys split over 4 warps of 16, each warp
    an online softmax of its own over the same query rows (a masked score
    gets p = 0, a row no key has reached keeps m = -1e30), then the warps'
    (m, l, acc) merged. Chunks the kernel skips are fully masked here,
    which leaves the state unchanged as the skip does. Causal with
    T_q < T_k shifts the diagonal by T_k - T_q, as the kernel does."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    qs = q * d ** -0.5
    rows = torch.arange(t_q)[:, None] + (t_k - t_q)
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


def _paged_split_emulated(q, kc, vc, tables, lens, chunk, merge=None):
    """csrc/paged_attention.cu's split-KV: each sequence cut into
    ``chunk``-token splits by position (a split may start inside a pool
    block); a split at or past the sequence's length is neither computed
    nor merged; each live split's (max, sum, acc) merged, all at once
    (``merge`` None: the f32 merge kernel) or ``merge`` splits a batch
    with the sums so far rescaled to each batch's maximum (the bf16
    kernel's in-kernel merge); a seq_len-0 row is zeros."""
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
        if not parts:
            continue
        mx = torch.full((h,), -1e30)
        l_sum, acc = torch.zeros(h), torch.zeros(h, d)
        for s0 in range(0, len(parts), merge or len(parts)):
            batch = parts[s0:s0 + (merge or len(parts))]
            mb = torch.stack([mx] + [pm for pm, _, _ in batch]).max(0).values
            r = torch.exp(mx - mb)
            l_sum, acc = l_sum * r, acc * r[:, None]
            for pm, pl, pa in batch:
                f = torch.exp(pm - mb)
                l_sum, acc = l_sum + pl * f, acc + pa * f[:, None]
            mx = mb
        out[i] = acc / l_sum[:, None]
    return out


@pytest.mark.parametrize("chunk", [128, 64, 32, 24, 10])
def test_paged_split_kv_emulation_matches_jax(chunk):
    """Split and merge against the JAX gather reference at the paged
    tolerance: seq_len 0, lengths 1, 15, 16, 17, on both sides of the
    chunk, and the full table; empty splits; chunks of 128 and 64 tokens
    (the kernels'; 32, the bf16 kernel's at D 256) and of 24 and 10,
    whose edges fall inside 16-token blocks."""
    width, bt = 10, 16
    lens = np.array([0, 1, 15, 16, 17, chunk - 1, chunk, chunk + 1,
                     width * bt], np.int32)
    rng = np.random.default_rng(chunk)
    tables = np.zeros((len(lens), width), np.int32)
    ids = rng.permutation(np.arange(1, 128))
    at = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // bt)
        tables[i, :need] = ids[at:at + need]
        at += need
    q, kc, vc, tables, lens = _paged_case(seed=chunk, b=len(lens), h=2, d=64,
                                          bt=bt, nb=128, tables=tables,
                                          lens=lens)
    got = _paged_split_emulated(*_t(q, kc, vc, tables, lens), chunk).numpy()
    ref = np.asarray(pk._paged_gather_reference(q, kc, vc, tables, lens,
                                                64 ** -0.5))
    live = lens > 0
    assert np.abs(got - ref)[live].max() < PAGED_ATOL
    assert not got[~live].any()


@pytest.mark.parametrize("chunk,merge", [(64, 16), (32, 16), (24, 16),
                                         (10, 4)])
def test_paged_batched_merge_emulation_matches_jax(chunk, merge):
    """The bf16 kernel's merge, ``merge`` splits' partials a batch with
    the sums rescaled to each batch's maximum, against the JAX gather
    reference at the paged tolerance, over rows of more splits than one
    batch holds (a 1,280-token table: 20 splits of 64, 54 of 24, 128 of
    10), with one batch, a batch and one split, and seq_len 0."""
    width, bt = 80, 16
    lens = np.array([0, 1, chunk * merge - 1, chunk * merge,
                     chunk * merge + 1, 700, width * bt], np.int32)
    rng = np.random.default_rng(chunk + merge)
    tables = np.zeros((len(lens), width), np.int32)
    ids = rng.permutation(np.arange(1, 512))
    at = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // bt)
        tables[i, :need] = ids[at:at + need]
        at += need
    q, kc, vc, tables, lens = _paged_case(seed=chunk, b=len(lens), h=2, d=64,
                                          bt=bt, nb=512, tables=tables,
                                          lens=lens)
    got = _paged_split_emulated(*_t(q, kc, vc, tables, lens), chunk,
                                merge).numpy()
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


def _mm_pieces(x, b, pieces):
    """x @ b in f32 with x carried as ``pieces`` bf16 values, as the bf16
    backward kernel feeds P and dS to the tensor cores: 1 is one rounding
    (hi = bf16(x)), 2 adds lo = bf16(x - hi), each piece's product
    summed into the same f32 result; 0 keeps x in f32."""
    if pieces == 0:
        return x @ b
    out, rest = 0, x
    for _ in range(pieces):
        piece = rest.to(torch.bfloat16).float()
        out = out + piece @ b
        rest = rest - piece
    return out


def _bwd_emulated(q, k, v, out, g, lse, causal, scale, blk=64,
                  mm=torch.matmul, walk=None):
    """csrc/flash_attention_bwd.cu's order of work on (BH, T, D):
    D = rowsum(dO * O); pass 2 walks each 64-key block's query blocks
    (from the diagonal when causal) summing dV += P^T dO and
    dK += dS^T Q; pass 3 walks each 64-row query block's key blocks
    summing dQ += dS K; P = exp(scale * S - lse) recomputed in both,
    zero where masked. ``walk``: the rows of a walked block (query
    blocks in pass 2, key blocks in pass 3), ``blk`` unless given; the
    fp32 kernels walk 32 at D 256. ``mm``: how the kernels run each of the five
    products (S, dP, and dV, dK, dQ with P and dS as their left
    operand): the fp32 kernels' 3xTF32 (:func:`_mm_3xtf32`), or the
    bf16 kernels' exact products with P and dS in bf16 pieces
    (:func:`_mm_pieces`). Causal with T_q < T_k shifts the diagonal by
    T_k - T_q: each key block's first query block and each query block's
    last key block move with it, as in the kernels."""
    t_q, t_k = q.shape[1], k.shape[1]
    shift = t_k - t_q if causal else 0
    walk = walk or blk
    d_vec = (g * out).sum(-1)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))

    def tile(q0, n_q, k0, n_k):
        rows = torch.arange(q0, min(q0 + n_q, t_q))
        keys = torch.arange(k0, min(k0 + n_k, t_k))
        s = mm(q[:, rows], k[:, keys].transpose(1, 2))
        dp = mm(g[:, rows], v[:, keys].transpose(1, 2))
        ok = keys[None, :] <= rows[:, None] + shift if causal else \
            torch.ones(len(rows), len(keys), dtype=torch.bool)
        p = torch.where(ok, torch.exp(scale * s - lse[:, rows, None]),
                        torch.tensor(0.0))
        return rows, keys, p, p * (dp - d_vec[:, rows, None])

    for k0 in range(0, t_k, blk):
        first = max(k0 - shift, 0) // walk * walk if causal else 0
        for q0 in range(first, t_q, walk):
            rows, keys, p, ds = tile(q0, walk, k0, blk)
            dv[:, keys] += mm(p.transpose(1, 2), g[:, rows])
            dk[:, keys] += mm(ds.transpose(1, 2), q[:, rows])
    for q0 in range(0, t_q, blk):
        for k0 in range(0, min(q0 + blk + shift, t_k) if causal else t_k,
                        walk):
            rows, keys, p, ds = tile(q0, blk, k0, walk)
            dq[:, rows] += mm(ds, k[:, keys])
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


# ---------------------------------------------------------------------------
# bfloat16: the plain versions against the JAX package on bf16 inputs, and
# the bf16 kernels' arithmetic emulated
# ---------------------------------------------------------------------------

# tests/test_pallas_attention.py's bound for the bf16 Pallas kernel against
# an f32 dense run on the same bf16 inputs; chip_smoke.py holds the bf16
# kernels to it elementwise, and to no more than BF16_F64_RATIO times the
# plain bf16 version's distance (relative L2) from an f64 run
BF16_RTOL, BF16_ATOL = 0.1, 0.05
BF16_F64_RATIO = 2.0
# one bf16 rounding: a value x rounds to within half an ulp, and an ulp of
# a bf16 value is at most 2^-7 of it; two roundings of nearly equal f32
# values land at most one ulp apart
BF16_ULP = 2.0 ** -7
# chip_smoke.py's bound for the bf16 backward kernel against the plain
# backward given the same forward output: the fp32 bound plus one ulp
BF16_BWD_RTOL, BF16_BWD_ATOL = FLASH_RTOL + BF16_ULP, FLASH_ATOL


def _bf16(*arrays):
    """bf16 torch tensors of f32 numpy arrays (rounded to nearest even),
    and the same values as f32 numpy arrays for the JAX package."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return ts, [t.float().numpy() for t in ts]


def _jbf16(a):
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.bfloat16)    # exact: a holds bf16 values


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_bf16_matches_jax_reference_and_pallas_kernel(causal):
    """The plain version in bf16 is the JAX ``_dense_reference`` in bf16
    (what the JAX ``flash_attention`` runs below FLASH_MIN_SEQ): the same
    roundings (scaled q, scores, probabilities, output), in another
    summation order, so at most a few bf16 ulps apart: 4 ulps of the
    output's scale (|o| <= max |v|). Against the Pallas kernel in
    interpret mode, which computes in f32 inside as the Hopper kernel
    does, it meets the JAX bf16 bound."""
    b, h, t, d = 1, 2, 256, 32
    (q, k, v), (qn, kn, vn) = _bf16(*_flash_inputs((b, h, t, d), seed=30))
    got = att.flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ref = np.asarray(pk._dense_reference(
        *(_jbf16(x.reshape(b * h, t, d)) for x in (qn, kn, vn)), causal,
        d ** -0.5).astype(np.float32)).reshape(b, h, t, d)
    kern = pk.flash_attention(*(_jbf16(x) for x in (qn, kn, vn)),
                              causal=causal, force=True, block_q=128,
                              block_k=128)
    assert kern.dtype.name == "bfloat16"
    dense32 = np.asarray(pk._dense_reference(
        qn.reshape(b * h, t, d), kn.reshape(b * h, t, d),
        vn.reshape(b * h, t, d), causal, d ** -0.5)).reshape(b, h, t, d)
    assert np.abs(got - ref).max() <= 4 * BF16_ULP * np.abs(vn).max()
    np.testing.assert_allclose(got, np.asarray(kern, np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(got, dense32, rtol=BF16_RTOL, atol=BF16_ATOL)


def _flash_bf16_emulated(q, k, v, causal, stage=64):
    """csrc/flash_attention.cu's bf16 kernel on (BH, T, D) bf16: S = Q K^T
    from bf16 operands with f32 sums (a product of two bf16 values is
    exact in f32), scaled in f32; one f32 online softmax per row over
    every key it can see, in 64-key stages (a masked score gets p = 0);
    P rounded to bf16 (nearest even) for the P V product, the row sums
    taken from the f32 P; the output rounded once to bf16. Causal with
    T_q < T_k shifts the diagonal by T_k - T_q."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    qf, kf, vf = (x.float() for x in (q, k, v))
    rows = torch.arange(t_q)[:, None] + (t_k - t_q)
    m = torch.full((bh, t_q), att.NEG_INF)
    l = torch.zeros(bh, t_q)
    acc = torch.zeros(bh, t_q, d)
    for s0 in range(0, t_k, stage):
        keys = torch.arange(s0, min(s0 + stage, t_k))
        ok = (keys[None, :] <= rows) if causal else \
            torch.ones(t_q, len(keys), dtype=torch.bool)
        sc = torch.where(ok, (qf @ kf[:, keys].transpose(1, 2))
                         * d ** -0.5, torch.tensor(att.NEG_INF))
        mn = torch.maximum(m, sc.max(-1).values)
        alpha = torch.exp(m - mn)
        p = torch.where(ok, torch.exp(sc - mn[..., None]), torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] \
            + p.to(torch.bfloat16).float() @ vf[:, keys]
        m = mn
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(16, 16), (48, 64), (512, 64), (130, 128),
                                 (80, 256)])
def test_flash_bf16_emulation_meets_chip_bound(t, d, causal):
    """The bf16 kernel's arithmetic meets the bound chip_smoke.py holds the
    kernel to: within the JAX bf16 bound of an f32 dense run elementwise,
    and no further from an f64 run than twice the plain bf16 version."""
    (q, k, v), (qn, kn, vn) = _bf16(*_flash_inputs((2, t, d), seed=40 + t))
    got = _flash_bf16_emulated(q, k, v, causal).float().numpy()
    exact = att.flash_attention_plain(
        *(x.double() for x in (q, k, v)), causal=causal).numpy()
    plain = att.flash_attention_plain(q, k, v, causal=causal).float().numpy()
    dense32 = np.asarray(pk._dense_reference(qn, kn, vn, causal, d ** -0.5))
    np.testing.assert_allclose(got, dense32, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert _rel_l2(got, exact) <= BF16_F64_RATIO * _rel_l2(plain, exact)


def test_flash_bf16_emulation_has_no_wider_rounding_than_the_output():
    """What the bound above allows the kernel: its distance from f64 is
    the output's own bf16 rounding and little more (P rounded to bf16
    adds under half of it), where the plain bf16 version, which rounds
    the scores too, sits further off. chip_smoke.py holds the kernel to
    the same 1.5x on the card."""
    (q, k, v), _ = _bf16(*_flash_inputs((2, 512, 64), seed=41))
    exact = att.flash_attention_plain(*(x.double() for x in (q, k, v)),
                                      causal=True)
    got = _flash_bf16_emulated(q, k, v, True).double()
    rounded = exact.to(torch.bfloat16).double()
    plain = att.flash_attention_plain(q, k, v, causal=True).double()
    assert _rel_l2(got, exact) <= 1.5 * _rel_l2(rounded, exact)
    assert _rel_l2(plain, exact) > _rel_l2(got, exact)


def _jax_flash_grads_bf16(q, k, v, g, causal):
    import jax
    import jax.numpy as jnp

    def f(q, k, v):
        out = pk.flash_attention(q, k, v, causal=causal, force=True,
                                 interpret=True, block_q=64, block_k=64)
        return jnp.sum(out.astype(jnp.float32) * g)

    out = pk.flash_attention(q, k, v, causal=causal, force=True,
                             interpret=True, block_q=64, block_k=64)
    grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out, np.float32), [np.asarray(x, np.float32)
                                         for x in grads]


@pytest.mark.parametrize("case", ["causal", "rect"])
def test_flash_bf16_gradient_matches_jax_grad_of_pallas_kernel(case):
    """bf16 q, k, v: ``jax.grad`` of the interpret-mode Pallas forward
    (its VJP, ``_chunked_attention_bwd``, computes in f32 from the bf16
    inputs and rounds each gradient once to bf16). The plain backward
    given the same forward output runs the same f32 arithmetic in another
    order: at most one bf16 ulp apart. torch autograd through the CPU
    path (the plain forward in bf16) meets the JAX bf16 bound."""
    rng = np.random.default_rng({"causal": 50, "rect": 51}[case])
    t_k = 128 if case == "causal" else 192
    causal = case == "causal"
    (q, k, v, g), (qn, kn, vn, gn) = _bf16(
        rng.standard_normal((2, 128, 16)).astype(np.float32),
        *(rng.standard_normal((2, t_k, 16)).astype(np.float32)
          for _ in range(2)),
        rng.standard_normal((2, 128, 16)).astype(np.float32))
    jout, want = _jax_flash_grads_bf16(*(_jbf16(x) for x in (qn, kn, vn)),
                                       _jbf16(gn), causal)
    out = torch.from_numpy(jout).to(torch.bfloat16)
    plain = att.flash_attention_bwd_plain(q, k, v, out, g, causal,
                                          block_q=48)
    for a, w in zip(plain, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        np.testing.assert_allclose(a.float().numpy(), w, rtol=BF16_ULP,
                                   atol=1e-6)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    auto = torch.autograd.grad(att.flash_attention(*leaves, causal=causal),
                               leaves, g)
    for a, w in zip(auto, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)


def _bwd_tf32_case(case):
    """(q, k, v, d_out) numpy (BH, T, D) and causal for the fp32
    backward's emulation: causal, rectangular (non-causal 128 x 192),
    ragged T 100 (no 64-row tiling: the JAX function differentiates its
    dense path) and causal with T_q 100 < T_k 256 (the diagonal shifted)
    at D 16, causal at D 64, and causal at D 256 with T_q 100 < T_k 160
    (the kernels' 32-row walked tiles)."""
    t_q, t_k, d, causal = {"causal": (128, 128, 16, True),
                           "rect": (128, 192, 16, False),
                           "ragged": (100, 100, 16, True),
                           "offset": (100, 256, 16, True),
                           "d64": (128, 128, 64, True),
                           "d256": (100, 160, 256, True)}[case]
    rng = np.random.default_rng(t_q * 7 + t_k + d)
    q = rng.standard_normal((2, t_q, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, t_k, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    return (q, k, v, g), causal


def _bwd_tf32_emulated(q, k, v, g, causal, mm):
    """The fp32 backward kernel emulated with every product as ``mm``,
    from the 3xTF32 forward's emulated output and the rows' log-sum-exp:
    P and dS enter their products as f32 values, split by ``mm`` as the
    kernel splits them leaving the accumulator; walked tiles of 32 rows
    at D 256, as the kernels take them there."""
    q, k, v, g = _t(q, k, v, g)
    scale = q.shape[-1] ** -0.5
    out = _flash_emulated(q, k, v, causal, _mm_3xtf32)
    lse = _lse(q, k, causal, scale)
    return _bwd_emulated(q, k, v, out, g, lse, causal, scale, mm=mm,
                         walk=32 if q.shape[-1] > 128 else None)


def _within_fp32(got, want):
    return [bool(np.allclose(a.numpy(), w, rtol=FLASH_RTOL, atol=FLASH_ATOL))
            for a, w in zip(got, want)]


@pytest.mark.parametrize("case", ["causal", "rect", "ragged", "offset",
                                  "d64", "d256"])
def test_flash_bwd_3xtf32_emulation_meets_fp32_tolerance(case):
    """The fp32 backward kernel's arithmetic (its two-pass tiling, every
    product 3xTF32 with the small parts unrounded, P and dS split as they
    leave the accumulator) gives
    ``jax.grad`` of the Pallas forward in interpret mode (whose VJP is
    ``_chunked_attention_bwd``) within the fp32 attention bound."""
    (q, k, v, g), causal = _bwd_tf32_case(case)
    want = _jax_flash_grads(q, k, v, g, causal)
    got = _bwd_tf32_emulated(q, k, v, g, causal, _mm_3xtf32_bwd)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=FLASH_RTOL,
                                   atol=FLASH_ATOL)


def test_flash_bwd_1xtf32_emulation_misses_fp32_tolerance():
    """Why the backward splits every operand: one TF32 product of the
    rounded operands (10 mantissa bits) puts dQ, dK and dV outside the
    fp32 bound that 3xTF32 meets on the same inputs."""
    (q, k, v, g), causal = _bwd_tf32_case("d64")
    want = _jax_flash_grads(q, k, v, g, causal)
    one = _bwd_tf32_emulated(q, k, v, g, causal, _mm_1xtf32)
    three = _bwd_tf32_emulated(q, k, v, g, causal, _mm_3xtf32_bwd)
    assert _within_fp32(one, want) == [False] * 3
    assert all(_within_fp32(three, want))


def _bwd_bf16_case(t_q, t_k, causal, d=16, bh=3, seed=7):
    """bf16 q, k, v, d_out (BH, T, D), and the emulated bf16 forward's
    output with the f32 log-sum-exp the forward kernel writes beside it."""
    rng = np.random.default_rng(t_q * 1000 + t_k + seed)
    (q, k, v, g), _ = _bf16(
        rng.standard_normal((bh, t_q, d)).astype(np.float32),
        *(rng.standard_normal((bh, t_k, d)).astype(np.float32)
          for _ in range(2)),
        rng.standard_normal((bh, t_q, d)).astype(np.float32))
    out = _flash_bf16_emulated(q, k, v, causal)
    lse = _lse(q.float(), k.float(), causal, d ** -0.5)
    return q, k, v, g, out, lse


def _bwd_bf16_emulated(q, k, v, g, out, lse, causal, pieces):
    """The bf16 backward kernel emulated: f32 inside from the bf16
    inputs, P and dS carried as ``pieces`` bf16 values, each gradient
    rounded once to bf16."""
    return [x.to(torch.bfloat16) for x in _bwd_emulated(
        *(x.float() for x in (q, k, v, out, g)), lse, causal,
        q.shape[-1] ** -0.5, mm=lambda x, b: _mm_pieces(x, b, pieces))]


def _within_chip_bwd_bound(got, q, k, v, g, out, causal):
    """Per gradient, whether it meets chip_smoke.py phase 13's bound
    against the plain backward given the same forward output."""
    want = att.flash_attention_bwd_plain(q, k, v, out, g, causal)
    return [bool(((a.double() - w.double()).abs()
                  <= BF16_BWD_ATOL + BF16_BWD_RTOL * w.double().abs()).all())
            for a, w in zip(got, want)]


@pytest.mark.parametrize("t_q,t_k,causal", [(100, 100, True),
                                            (130, 70, False),
                                            (100, 256, True)])
def test_flash_bwd_bf16_emulation_meets_chip_bound(t_q, t_k, causal):
    """The bf16 backward kernel's arithmetic (f32 inside, S and dP one
    exact product each, P and dS split into bf16 hi and lo for the dV,
    dK and dQ products, each gradient rounded once), from the emulated
    bf16 forward's output and log-sum-exp: within chip_smoke.py's bound
    of the plain backward given the same output (rtol 1e-4 + 2^-7, atol
    1e-5), no further from an f64 backward than twice the plain bf16
    backward (from the plain bf16 forward's output), and within the JAX
    bf16 bound of it."""
    q, k, v, g, out, lse = _bwd_bf16_case(t_q, t_k, causal)
    got = _bwd_bf16_emulated(q, k, v, g, out, lse, causal, pieces=2)
    assert all(_within_chip_bwd_bound(got, q, k, v, g, out, causal))
    qd, kd, vd, gd = (x.double() for x in (q, k, v, g))
    exact = att.flash_attention_bwd_plain(
        qd, kd, vd, att.flash_attention_plain(qd, kd, vd, causal), gd,
        causal)
    plain = att.flash_attention_bwd_plain(
        q, k, v, att.flash_attention_plain(q, k, v, causal), g, causal)
    for a, p, e in zip(got, plain, exact):
        assert _rel_l2(a.float(), e) <= BF16_F64_RATIO * _rel_l2(p.float(), e)
        np.testing.assert_allclose(a.float().numpy(), p.float().numpy(),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


def test_flash_bwd_bf16_single_rounding_misses_chip_bound():
    """Why the bf16 backward splits P and dS: rounded once to bf16 (the
    FA2 / SDPA rounding) they put dQ, dK and dV outside chip_smoke.py's
    unchanged bound against the plain backward, where the two-piece
    split meets it on the same inputs."""
    q, k, v, g, out, lse = _bwd_bf16_case(256, 256, True, bh=4, seed=8)
    one = _bwd_bf16_emulated(q, k, v, g, out, lse, True, pieces=1)
    two = _bwd_bf16_emulated(q, k, v, g, out, lse, True, pieces=2)
    assert _within_chip_bwd_bound(one, q, k, v, g, out, True) == [False] * 3
    assert all(_within_chip_bwd_bound(two, q, k, v, g, out, True))


def _paged_bf16_case(case):
    """The paged case with bf16 caches: torch bf16 caches, and the same
    values as JAX bf16 arrays; q stays f32, as the bf16 decoder's decode
    step hands it over."""
    q, kc, vc, tables, lens = _paged_case() if case == "small" \
        else _wide_case()
    (kt, vt), (kn, vn) = _bf16(kc, vc)
    return q, (kt, vt), (kn, vn), tables, lens


@pytest.mark.parametrize("case", ["small", "wide"])
def test_paged_plain_bf16_cache_matches_jax_reference_and_pallas_kernel(
        case):
    """f32 q over bf16 caches: each side reads the bf16 values exactly
    into f32, so the paged bound of the f32 case holds."""
    q, (kt, vt), (kn, vn), tables, lens = _paged_bf16_case(case)
    got = att.paged_attention(torch.from_numpy(q), kt, vt,
                              *_t(tables, lens))
    assert got.dtype == torch.float32
    got = got.numpy()
    kj, vj = _jbf16(kn), _jbf16(vn)
    ref = np.asarray(pk._paged_gather_reference(
        q, kj, vj, tables, lens, q.shape[-1] ** -0.5))
    kern = np.asarray(pk.paged_attention(q, kj, vj, tables, lens,
                                         force=True))
    live = lens > 0
    assert np.abs(got - ref)[live].max() < PAGED_ATOL
    assert np.abs(got - kern)[live].max() < PAGED_ATOL
    # the split-KV emulation reads the same bf16 values
    split = _paged_split_emulated(torch.from_numpy(q), kt.float(),
                                  vt.float(), *_t(tables, lens), 64)
    assert np.abs(split.numpy() - ref)[live].max() < PAGED_ATOL


def test_paged_chunk_chooser_and_scratch_sizing():
    """The paged kernels' tokens per split CTA are chosen on the host
    from the shapes and the card's SM count alone: over bf16 caches 128
    at the serving decode
    shape (B 32, H 8, D 64, tables of 48 blocks of 16 tokens), 64 where
    the grid would fall under two CTAs an SM (B 1) and at D 128, 32 at
    D 256 (B 32 and B 1); over f32 caches always 64 (its split and merge
    kernels, D 256 too). The wrapper's
    buffers follow the chunk chosen: ceil(W * BT / chunk) splits of
    (2 + D) floats a (sequence, head), and for bf16 the (device,
    stream)'s zeroed int32 merge counters, one buffer a stream, grown
    (fresh and zeroed) for a larger B * H."""
    assert att._paged_chunk(32, 8, 64, 48, 16, True, 132) == 128
    assert att._paged_chunk(1, 8, 64, 48, 16, True, 132) == 64
    assert att._paged_chunk(32, 8, 128, 48, 16, True, 132) == 64
    assert att._paged_chunk(32, 8, 64, 48, 16, False, 132) == 64
    assert att._paged_chunk(32, 16, 256, 48, 16, True, 132) == 32
    assert att._paged_chunk(1, 16, 256, 256, 16, True, 132) == 32
    assert att._paged_chunk(32, 16, 256, 48, 16, False, 132) == 64
    # the grid floor follows the card's SM count: 4 x 8 x 6 CTAs are
    # under two an SM of 132 SMs, not of 66
    assert att._paged_chunk(4, 8, 64, 48, 16, True, 132) == 64
    assert att._paged_chunk(4, 8, 64, 48, 16, True, 66) == 128
    tables = torch.zeros((32, 48), dtype=torch.int32)
    q = torch.zeros((32, 8, 64))
    att._paged_counters.clear()
    try:
        for cache, chunk in ((torch.bfloat16, 128), (torch.float32, 64)):
            kc = torch.zeros((2, 16, 8, 64), dtype=cache)
            got, out, scratch, counters = att._paged_buffers(q, kc, tables,
                                                             132, 0)
            assert got == chunk
            assert out.shape == (32, 8, 64) and out.dtype == torch.float32
            assert scratch.dtype == torch.float32
            assert scratch.numel() == 32 * 8 * (48 * 16 // chunk) * (2 + 64)
            if cache == torch.float32:
                assert counters is None
                continue
            assert counters.dtype == torch.int32
            assert counters.numel() == 32 * 8 and not counters.any()
            assert att._paged_buffers(q[:4], kc, tables[:4], 132,
                                      0)[3] is counters
            # another stream has counters of its own
            other = att._paged_buffers(q, kc, tables, 132, 1)[3]
            assert other is not counters and not other.any()
            assert att._paged_buffers(q, kc, tables, 132, 0)[3] is counters
            wide = att._paged_buffers(torch.zeros((64, 8, 64)), kc,
                                      torch.zeros((64, 48),
                                                  dtype=torch.int32),
                                      132, 0)[3]
            assert wide.numel() == 64 * 8 and not wide.any()
    finally:
        att._paged_counters.clear()


def test_bf16_kernel_entry_types_on_cpu_and_launch_counts():
    """On the CPU every type takes the plain version and counts no
    launch; the wrappers refuse mixed flash types (no quiet cast)."""
    att.reset_launches()
    (q, k, v), _ = _bf16(*_flash_inputs((1, 2, 16, 8), seed=60))
    assert att.flash_attention(q, k, v, causal=True).dtype == torch.bfloat16
    pq, kc, vc, tables, lens = _paged_case()
    (kt, vt), _ = _bf16(kc, vc)
    assert att.paged_attention(torch.from_numpy(pq), kt, vt,
                               *_t(tables, lens)).dtype == torch.float32
    assert all(fn.launches == fn.launches_bf16 == 0 for fn in (
        att.flash_attention, att.flash_attention_bwd, att.paged_attention))
    b, h, t, d = 1, 2, 16, 16
    x16 = torch.zeros((b, h, t, d), dtype=torch.bfloat16, device="meta")
    x32 = torch.zeros((b, h, t, d), device="meta")
    for args in ((x16, x32, x32), (x16.half(), x16.half(), x16.half())):
        with pytest.raises(MXNetError):
            att._check_flash("flash_attention", *args, True)


# ---------------------------------------------------------------------------
# causal with T_q < T_k (the diagonal shifted by T_k - T_q) in the kernels'
# arithmetic, and every head size up to 128 (zero-padded to a built size)
# ---------------------------------------------------------------------------

# chip_smoke.py's first causal-offset case
OFFSET_TQ, OFFSET_TK = 100, 256


def _flash_offset_inputs(d, seed, bh=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, OFFSET_TQ, d)).astype(np.float32)
    k, v = (rng.standard_normal((bh, OFFSET_TK, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def test_flash_3xtf32_emulation_with_causal_offset_meets_fp32_tolerance():
    """The fp32 forward's stage/warp order with the shifted diagonal
    gives the JAX ``_dense_reference`` (queries the last T_q key
    positions) within the bound of the square case."""
    q, k, v = _flash_offset_inputs(64, seed=60)
    ref = np.asarray(pk._dense_reference(q, k, v, True, 64 ** -0.5))
    got = _flash_emulated(*_t(q, k, v), True, _mm_3xtf32).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def test_flash_bf16_emulation_with_causal_offset_meets_chip_bound():
    """The bf16 forward's one online softmax per row with the shifted
    diagonal: within the JAX bf16 bound of the f32 dense reference, and
    no further from f64 than twice the plain bf16 version."""
    (q, k, v), (qn, kn, vn) = _bf16(*_flash_offset_inputs(64, seed=61))
    got = _flash_bf16_emulated(q, k, v, True).float().numpy()
    exact = att.flash_attention_plain(
        *(x.double() for x in (q, k, v)), causal=True).numpy()
    plain = att.flash_attention_plain(q, k, v, causal=True).float().numpy()
    dense32 = np.asarray(pk._dense_reference(qn, kn, vn, True, 64 ** -0.5))
    np.testing.assert_allclose(got, dense32, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert _rel_l2(got, exact) <= BF16_F64_RATIO * _rel_l2(plain, exact)


def test_flash_bwd_bf16_emulation_with_causal_offset_meets_jax_grad():
    """The bf16 backward's passes with the shifted diagonal against
    ``jax.grad`` of the JAX forward (its dense path at T_q != T_k) on the
    same bf16 inputs, within the JAX bf16 bound."""
    q, k, v, g, out, lse = _bwd_bf16_case(OFFSET_TQ, OFFSET_TK, True)
    got = _bwd_bf16_emulated(q, k, v, g, out, lse, True, pieces=2)
    _, want = _jax_flash_grads_bf16(
        *(_jbf16(x.float().numpy()) for x in (q, k, v)),
        _jbf16(g.float().numpy()), True)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), w, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)


def test_flash_kernel_check_takes_causal_offset_and_refuses_more_queries():
    """The CUDA wrappers' shape check: causal with T_q <= T_k passes,
    T_q > T_k raises as both references do."""
    q, k, v = _t(*_flash_inputs((1, 2, 100, 16), seed=62))
    kl, vl = _t(*_flash_inputs((1, 2, 256, 16), seed=63))[:2]
    assert att._check_flash("f", q, kl, vl, True) == (1, 2, 100, 256, 16)
    with pytest.raises(MXNetError):
        att._check_flash("f", kl, q, v, True)


def _grads_through(attend, q, k, v, g, scale):
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = attend(*leaves, True, scale)
    return [out.detach(), *torch.autograd.grad(out, leaves, g)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 80, 200])
def test_flash_head_padding_is_exact(d, dtype):
    """What the CUDA wrappers do for a head size the kernels are not
    built for, run through the plain versions: q, k and v zero-padded to
    any built size that holds D, with the true D^-0.5 as scale, the
    output sliced back, give the unpadded output and gradients, causal
    with T_q < T_k included; so does the backward given padded out and
    dO (``_flash_bwd_padded``, the function the backward wrapper runs).
    The zero columns add exact zeros, but a product over more terms may
    sum in another order: held to 1e-6 (f32) or one ulp (bf16), far
    inside the kernels' bounds."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((2, 2, 24, d))
                         .astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 40, d))
                             .astype(np.float32)).to(dtype)
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(q.shape)
                         .astype(np.float32)).to(dtype)
    scale = d ** -0.5
    tol = dict(rtol=BF16_ULP if dtype == torch.bfloat16 else 1e-6,
               atol=1e-6)
    want = _grads_through(att.flash_attention_plain, q, k, v, g, scale)
    sizes = [b for b in att._FLASH_HEAD_DIMS if b >= d]

    def padded_to(size):
        def attend(q, k, v, causal, scale):
            return att.flash_attention_plain(*att._pad_last(size, q, k, v),
                                             causal, scale)[..., :d]
        return attend

    def through_wrapper(q, k, v, causal, scale):
        return att._flash_padded(q, k, v, causal, scale,
                                 att.flash_attention_plain)

    for attend in [through_wrapper] + [padded_to(b) for b in sizes]:
        for a, w in zip(_grads_through(attend, q, k, v, g, scale), want):
            assert a.shape == w.shape and a.dtype == w.dtype
            torch.testing.assert_close(a, w, **tol)
    bwd = att._flash_bwd_padded(q, k, v, want[0], g, True, scale,
                                att.flash_attention_bwd_plain)
    plain = att.flash_attention_bwd_plain(q, k, v, want[0], g, True, scale)
    for a, w in zip(bwd, plain):
        torch.testing.assert_close(a, w, **tol)


def test_head_sizes_past_128_raise():
    """Past 128 the wrappers pad to the D 256 instances; past 256, the
    largest built size, K3's wrappers raise and a pool keeps its D (the
    card raises at the paged launch)."""
    for d, size in ((129, 256), (144, 256), (200, 256), (256, 256)):
        assert att._built_dim(d, att._FLASH_HEAD_DIMS, "f") == size
        assert att.paged_head_dim(d) == size
    q = torch.zeros(1, 4, 288)
    with pytest.raises(MXNetError):
        att._flash_padded(q, q, q, True, 1.0, att.flash_attention_plain)
    with pytest.raises(MXNetError):
        att._flash_bwd_padded(q, q, q, q, q, True, 1.0,
                              att.flash_attention_bwd_plain)
    assert att.paged_head_dim(288) == 288     # the card raises at launch


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 12, 16, 80, 200])
def test_paged_pool_padding_is_exact(d, cache):
    """A pool laid out at ``paged_head_dim(D)`` (zero columns past D, as
    BlockPool allocates it): the wrapper pads q to the pool's D and
    slices the output, which equals the unpadded call to 1e-6 (a sum
    over more, zero, terms) and the JAX gather reference within its
    bound."""
    assert att.paged_head_dim(d) == {8: 8, 12: 16, 16: 16, 80: 128,
                                     200: 256}[d]
    q, kc, vc, tables, lens = _paged_case(seed=d, d=d)
    kt, vt = (torch.from_numpy(x).to(cache) for x in (kc, vc))
    args = _t(tables, lens)
    want = att.paged_attention(torch.from_numpy(q), kt, vt, *args)
    ref = np.asarray(pk._paged_gather_reference(
        q, kt.float().numpy(), vt.float().numpy(), tables, lens, d ** -0.5))
    live = lens > 0
    for size in [b for b in att._PAGED_HEAD_DIMS if b > d]:
        got = att.paged_attention(torch.from_numpy(q),
                                  *att._pad_last(size, kt, vt), *args)
        assert got.shape == want.shape == q.shape
        torch.testing.assert_close(got[live], want[live], rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(got.numpy() - ref)[live].max() < PAGED_ATOL


# ---------------------------------------------------------------------------
# head size 256 (Gemma-7B's heads): the plain versions against the JAX
# package, and the bf16 backward's arithmetic at that size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_q,t_k,causal", [(64, 64, True), (40, 96, True)])
def test_d256_plain_forward_and_gradient_match_jax(t_q, t_k, causal):
    """At D 256 the plain forward is the JAX ``_dense_reference`` and the
    interpret-mode Pallas forward, and the plain backward and torch
    autograd through the CPU path are ``jax.grad`` of that forward, at
    the fp32 attention bound (the JAX package serves any D)."""
    rng = np.random.default_rng(t_q * 100 + t_k)
    q = rng.standard_normal((2, t_q, 256)).astype(np.float32)
    k, v = (rng.standard_normal((2, t_k, 256)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    got = att.flash_attention(*_t(q, k, v), causal=causal)
    ref = np.asarray(pk._dense_reference(q, k, v, causal, 256 ** -0.5))
    kern = np.asarray(pk.flash_attention(q, k, v, causal=causal, force=True,
                                         interpret=True, block_q=64,
                                         block_k=64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)
    np.testing.assert_allclose(got.numpy(), kern, rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)
    want = _jax_flash_grads(q, k, v, g, causal)
    plain = att.flash_attention_bwd_plain(*_t(q, k, v), got,
                                          torch.from_numpy(g), causal)
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    auto = torch.autograd.grad(att.flash_attention(*leaves, causal=causal),
                               leaves, torch.from_numpy(g))
    for grads in (plain, auto):
        for a, w in zip(grads, want):
            np.testing.assert_allclose(a.numpy(), w, rtol=FLASH_RTOL,
                                       atol=FLASH_ATOL)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_d256_paged_plain_matches_jax(cache):
    """The plain paged version at D 256 (the kernels' chunk 64 for f32
    caches and 32 for bf16) against the JAX gather reference and the
    Pallas kernel in interpret mode, lengths about both chunks, a padding
    row; and the split-KV emulation at the bf16 kernel's chunk."""
    width, bt = 8, 16
    lens = np.array([0, 1, 31, 32, 33, 64, 65, 100, width * bt], np.int32)
    tables = np.zeros((len(lens), width), np.int32)
    ids = np.random.default_rng(5).permutation(np.arange(1, 64))
    at = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // bt)
        tables[i, :need] = ids[at:at + need]
        at += need
    q, kc, vc, tables, lens = _paged_case(seed=256, b=len(lens), h=2,
                                          d=256, bt=bt, nb=64,
                                          tables=tables, lens=lens)
    (kt, vt), (kn, vn) = _bf16(kc, vc) if cache == torch.bfloat16 else \
        (_t(kc, vc), (kc, vc))
    got = att.paged_attention(torch.from_numpy(q), kt, vt,
                              *_t(tables, lens)).numpy()
    ref = np.asarray(pk._paged_gather_reference(q, kn, vn, tables, lens,
                                                256 ** -0.5))
    kern = np.asarray(pk.paged_attention(q, kn, vn, tables, lens,
                                         force=True))
    live = lens > 0
    assert np.abs(got - ref)[live].max() < PAGED_ATOL
    assert np.abs(got - kern)[live].max() < PAGED_ATOL
    chunk = att._paged_chunk(len(lens), 2, 256, width, bt,
                             cache == torch.bfloat16, 132)
    split = _paged_split_emulated(torch.from_numpy(q), kt.float(),
                                  vt.float(), *_t(tables, lens), chunk,
                                  16 if cache == torch.bfloat16 else None)
    assert np.abs(split.numpy() - ref)[live].max() < PAGED_ATOL


def test_d256_flash_bwd_bf16_emulation_meets_chip_bound():
    """The bf16 backward at D 256 (its gradient columns split over two
    CTAs, which leaves each column's sums as they are): within phase
    13's bound of the plain backward given the same forward output, and
    no further from an f64 backward than twice the plain bf16 one."""
    q, k, v, g, out, lse = _bwd_bf16_case(80, 144, True, d=256, bh=2)
    got = _bwd_bf16_emulated(q, k, v, g, out, lse, True, pieces=2)
    assert all(_within_chip_bwd_bound(got, q, k, v, g, out, True))
    qd, kd, vd, gd = (x.double() for x in (q, k, v, g))
    exact = att.flash_attention_bwd_plain(
        qd, kd, vd, att.flash_attention_plain(qd, kd, vd, True), gd, True)
    plain = att.flash_attention_bwd_plain(
        q, k, v, att.flash_attention_plain(q, k, v, True), g, True)
    for a, p, e in zip(got, plain, exact):
        assert _rel_l2(a.float(), e) <= BF16_F64_RATIO * _rel_l2(p.float(), e)
