"""Attention kernels: the port's counterparts of ``flash_attention``
(with its gradient, ``_chunked_attention_bwd``) and ``paged_attention``
in ``mxnet_tpu/ops/pallas_kernels.py``.

Each entry point has three parts:

- a plain PyTorch version (``flash_attention_plain``,
  ``flash_attention_bwd_plain``, ``paged_attention_plain``), the
  counterpart of the JAX package's ``_dense_reference`` /
  ``_chunked_attention_bwd`` / ``_paged_gather_reference`` and the
  oracle the kernels are held against;
- a hand-written CUDA kernel for sm_90a in ``csrc/`` (see the note at
  the top of each source for the TPU kernel it replaces, its bound on
  the H100 and how its design meets it), built by :mod:`._build`, for
  float32 and for bfloat16 (f32 inside, as the TPU kernels compute);
- a wrapper that sends tensors on the CPU to the plain version and
  tensors on a CUDA device to the kernel of their type. It raises on any
  input the kernels do not take; nothing falls back and nothing is cast.
  Each kernel launch adds one to the wrapper's ``launches`` (float32) or
  ``launches_bf16`` count.

:func:`flash_attention` is differentiable. On the CPU torch autograd
differentiates the plain version. On CUDA, when a gradient is needed,
it is a ``torch.autograd.Function``: the forward kernel also writes the
rows' log-sum-exp, and the backward launches
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`). Without a
gradient (serving, ``inference_mode``) nothing is saved and the
log-sum-exp is not written.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

NEG_INF = -1e30


def reset_launches():
    for fn in (flash_attention, flash_attention_bwd, paged_attention):
        fn.launches = fn.launches_bf16 = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path and oracles)
# ---------------------------------------------------------------------------

def _scores(q, k, scale, causal, q0=0, t_q=None):
    """scale * Q K^T over (..., rows, D) x (..., T_k, D). With causal,
    the keys after each query are NEG_INF: q holds rows ``q0`` on of
    ``t_q`` queries (all of them by default), the last t_q positions of
    the key sequence (the decoder convention of the JAX reference)."""
    t_q = q.shape[-2] if t_q is None else t_q
    t_k = k.shape[-2]
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    if causal:
        if t_q > t_k:
            raise MXNetError(
                f"causal attention with t_q ({t_q}) > t_k ({t_k}) leaves "
                "queries with no visible keys; pad K/V or drop causal")
        rows = torch.arange(q0, q0 + q.shape[-2], device=q.device)
        mask = torch.arange(t_k, device=q.device)[None, :] \
            <= rows[:, None] + (t_k - t_q)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_plain(q, k, v, causal=False, scale=None):
    """Dense attention. q, k, v: (B, H, T, D) or (BH, T, D). When
    causal and T_q < T_k the queries are the last T_q positions of the
    key sequence (the decoder convention of the JAX reference)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.softmax(_scores(q, k, scale, causal), dim=-1)
    return torch.matmul(p, v)


def flash_attention_bwd_plain(q, k, v, out, d_out, causal=False,
                              scale=None, block_q=256):
    """dq, dk, dv of ``flash_attention_plain(q, k, v, causal, scale)``
    given its output ``out`` and the output gradient ``d_out``, the
    counterpart of the JAX package's ``_chunked_attention_bwd``: f32 (or
    the inputs' type where it is wider), over query blocks of
    ``block_q`` rows, each recomputing its scores and softmax, with
    D = rowsum(dO * O) for the softmax VJP and dK / dV summed over the
    blocks. Shapes (..., T, D); any ``T`` (the last block is short)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    t_q = q.shape[-2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, gf = (x.to(ct) for x in (q, k, v, d_out))
    d_vec = (gf * out.to(ct)).sum(-1)                    # (..., T_q)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    vt = vf.transpose(-1, -2)
    for i0 in range(0, t_q, block_q):
        i1 = min(i0 + block_q, t_q)
        qi, gi = qf[..., i0:i1, :], gf[..., i0:i1, :]
        p = torch.softmax(_scores(qi, kf, scale, causal, i0, t_q), dim=-1)
        dp = torch.matmul(gi, vt)
        ds = p * (dp - d_vec[..., i0:i1, None])
        dq[..., i0:i1, :] = torch.matmul(ds, kf) * scale
        dk += torch.matmul(ds.transpose(-1, -2), qi) * scale
        dv += torch.matmul(p.transpose(-1, -2), gi)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def paged_attention_plain(q, k_cache, v_cache, block_tables, seq_lens,
                          scale=None):
    """Gather each sequence's blocks into a contiguous view and run
    masked single-query attention. q: (B, H, D); k_cache/v_cache:
    (num_blocks, BT, H, D); block_tables: (B, W) int; seq_lens: (B,)
    int. A seq_len-0 row is batch padding: its output is garbage and
    the caller discards it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, w = block_tables.shape
    bt = k_cache.shape[1]
    idx = block_tables.long()
    k = k_cache[idx].reshape(b, w * bt, *k_cache.shape[2:])  # (B, S, H, D)
    v = v_cache[idx].reshape(b, w * bt, *v_cache.shape[2:])
    s = torch.einsum("bhd,bshd->bhs", q.float() * scale, k.float())
    pos = torch.arange(w * bt, device=q.device)[None, None, :]
    s = torch.where(pos < seq_lens.long()[:, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel bindings
# ---------------------------------------------------------------------------

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
_FLASH_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I, _I, _P]
_FLASH_BWD_ARGS = [_P] * 10 + [_I] * 5 + [_P, _F, _I, _I, _P]
_PAGED_ARGS = [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
               _I, _I, _F, _I, _P]
# bf16: the merge counters after the scratch
_PAGED_BF16_ARGS = _PAGED_ARGS[:9] + [_P] + _PAGED_ARGS[9:]
_FLASH_HEAD_DIMS = (16, 32, 64, 128)
_FLASH_TYPES = (torch.float32, torch.bfloat16)
_PAGED_HEAD_DIMS = (32, 64, 128)


def _fn(name, symbol, argtypes):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _aligned(x):
    """cp.async copies 16 bytes (4 f32 or 8 bf16 values): the base
    address and every stride but the last (unit) one must be multiples
    of 16 bytes."""
    return (x.data_ptr() % 16 == 0
            and all(st * x.element_size() % 16 == 0
                    for st in x.stride()[:-1]))


def _count(wrapper, bf16):
    """One launch of the wrapper's float32 or bfloat16 kernel."""
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def _check(err, what):
    if err != 0:
        raise MXNetError(f"{what}: CUDA launch failed with error {err}")


def _devices(name, *tensors):
    """'cpu' when every tensor is on the CPU, 'cuda' when every one is
    on one CUDA device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise MXNetError(f"{name}: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise MXNetError(f"{name}: unsupported device {dev}")
    return dev.type


def _require(cond, name, msg):
    if not cond:
        raise MXNetError(f"{name}: {msg}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _heads4(name, *xs):
    """(B, H, T, D) views of (B, H, T, D) or (BH, T, D) inputs, and
    whether they were 3-D."""
    _require(all(x.ndim in (3, 4) for x in xs)
             and len({x.ndim for x in xs}) == 1, name,
             f"expected (B, H, T, D) or (BH, T, D), got "
             f"{[tuple(x.shape) for x in xs]}")
    squeeze = xs[0].ndim == 3
    return [x.unsqueeze(1) if squeeze else x for x in xs], squeeze


def _check_flash(name, q, k, v, causal):
    """The shapes, types and layouts both flash kernels take."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    _require(k.shape == v.shape == (b, h, t_k, d), name,
             f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(q.dtype in _FLASH_TYPES and k.dtype == v.dtype == q.dtype,
             name, f"kernels take float32 or bfloat16 q, k and v of one "
             f"type, got {q.dtype}/{k.dtype}/{v.dtype}")
    _require(d in _FLASH_HEAD_DIMS, name,
             f"head size {d} not in {_FLASH_HEAD_DIMS}")
    _require(all(x.stride(-1) == 1 for x in (q, k, v)), name,
             "the head dimension must be contiguous (stride 1)")
    _require(not causal or t_q == t_k, name,
             f"causal kernel needs t_q == t_k, got {t_q} and {t_k}")
    _require(t_q > 0 and t_k > 0 and b * h * max(t_q, t_k) < 2 ** 31,
             name, f"unsupported shape {tuple(q.shape)} x {t_k}")
    return b, h, t_q, t_k, d


def _flash_fwd(q, k, v, causal, scale, with_lse):
    """Launch the forward kernel of q's type on (B, H, T, D) CUDA
    tensors: the output in that type laid out (B, T, H, D) (so the
    caller's head merge is a view) and, with ``with_lse``, the rows'
    log-sum-exp f32 (B, H, T_q)."""
    name = "flash_attention"
    b, h, t_q, t_k, d = _check_flash(name, q, k, v, causal)
    _require(all(_aligned(x) for x in (q, k, v)), name,
             "q, k and v need 16-byte aligned base addresses and strides "
             "(multiples of 4 float32 or 8 bfloat16 elements)")
    out = torch.empty((b, t_q, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device) \
        if with_lse else None
    strides = (ctypes.c_int64 * 12)(*[s for x in (q, k, v, out)
                                       for s in x.stride()[:3]])
    bf16 = q.dtype == torch.bfloat16
    fn = _fn("flash_attention", "mxt_flash_attention_bf16" if bf16
             else "mxt_flash_attention_f32", _FLASH_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None, b, h, t_q, t_k, d,
             strides, float(scale), int(bool(causal)), q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    _check(err, name)
    _count(flash_attention, bf16)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving what the backward kernel reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _flash_fwd(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out)
        ctx.lse, ctx.causal, ctx.scale = lse, causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        if d_out.stride(-1) != 1:    # e.g. an expanded gradient of a sum
            d_out = d_out.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, d_out, ctx.lse,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise attention. q, k, v: (B, H, T, D) or (BH, T, D). CPU
    tensors take :func:`flash_attention_plain` (differentiated by torch
    autograd); CUDA tensors launch the kernel of
    ``csrc/flash_attention.cu`` for their type (float32, or bfloat16
    computed in f32 and written in bfloat16; D in {16, 32, 64, 128},
    unit stride along D, 16-byte aligned base addresses and strides,
    causal only with T_q == T_k) and count one launch in ``launches``
    (float32) or ``launches_bf16``. When a gradient is needed on CUDA,
    the backward is :func:`flash_attention_bwd`. The output has q's
    shape and type; on CUDA it is laid out (B, T, H, D) so the caller's
    head merge is a view."""
    name = "flash_attention"
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _devices(name, q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    (q, k, v), squeeze = _heads4(name, q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    else:
        out, _ = _flash_fwd(q, k, v, causal, scale, with_lse=False)
    return out.squeeze(1) if squeeze else out


def flash_attention_bwd(q, k, v, out, d_out, lse, causal=False,
                        scale=None):
    """dq, dk, dv of the flash forward: q, k, v, its output ``out`` and
    the output gradient ``d_out`` (B, H, T, D) or (BH, T, D), and the
    forward's row log-sum-exp ``lse`` (B, H, T_q) or (BH, T_q). CPU
    tensors take :func:`flash_attention_bwd_plain` (which recomputes the
    softmax and ignores ``lse``); CUDA tensors launch the three kernels
    of ``csrc/flash_attention_bwd.cu`` for q's type and count one launch
    in ``launches`` (float32) or ``launches_bf16``. The kernels take
    q, k, v, out and d_out float32, or all bfloat16; D in {16, 32, 64,
    128}, unit stride along D, causal only with T_q == T_k, and ``lse``
    f32 contiguous; anything else raises. The kernels of both types copy
    q, k, v and d_out 16 bytes at a time, so each of them that is not
    16-byte aligned (base address and strides, as the forward requires)
    is first copied to a contiguous tensor. The gradients come out in
    q's type, summed in f32 and rounded once."""
    name = "flash_attention_bwd"
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _devices(name, q, k, v, out, d_out, lse) == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, d_out, causal, scale)
    (q, k, v, out, d_out), squeeze = _heads4(name, q, k, v, out, d_out)
    b, h, t_q, t_k, d = _check_flash(name, q, k, v, causal)
    _require(out.shape == d_out.shape == q.shape, name,
             f"out {tuple(out.shape)} / d_out {tuple(d_out.shape)} do not "
             f"match q {tuple(q.shape)}")
    _require(out.dtype == d_out.dtype == q.dtype
             and out.stride(-1) == 1 and d_out.stride(-1) == 1, name,
             f"out and d_out must be {q.dtype} (q's type) with a "
             f"contiguous head dimension, got {out.dtype}/{d_out.dtype}")
    _require(lse.dtype == torch.float32 and lse.is_contiguous()
             and lse.numel() == b * h * t_q, name,
             f"lse must be float32 contiguous (B, H, T_q), got "
             f"{lse.dtype} {tuple(lse.shape)}")
    _require(-(-max(t_q, t_k) // 64) * b * h < 2 ** 31, name,
             f"grid too large for {b} x {h} x {max(t_q, t_k)}")
    bf16 = q.dtype == torch.bfloat16
    # e.g. a narrow view of a gradient autograd split up
    q, k, v, d_out = (x if _aligned(x) else
                      x.clone(memory_format=torch.contiguous_format)
                      for x in (q, k, v, d_out))
    grads = [torch.empty((b, t, h, d), dtype=q.dtype,
                         device=q.device).transpose(1, 2)
             for t in (t_q, t_k, t_k)]
    d_vec = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*[s for x in (q, k, v, out, d_out,
                                                  *grads)
                                       for s in x.stride()[:3]])
    fn = _fn("flash_attention_bwd", "mxt_flash_attention_bwd_bf16" if bf16
             else "mxt_flash_attention_bwd_f32", _FLASH_BWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             d_out.data_ptr(), lse.data_ptr(), d_vec.data_ptr(),
             *[g.data_ptr() for g in grads], b, h, t_q, t_k, d, strides,
             float(scale), int(bool(causal)), q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    _check(err, name)
    _count(flash_attention_bwd, bf16)
    return tuple(g.squeeze(1) for g in grads) if squeeze else tuple(grads)


# tokens per split CTA of the f32-cache kernel, the one chunk
# csrc/paged_attention.cu instantiates for it
_PAGED_CHUNK_F32 = 64
# (device, stream handle): the bf16 kernel's merge counters, int32, zero
# between calls, so calls in flight on two streams never share one
_paged_counters = {}


def _paged_chunk(b, h, d, w, bt, bf16, sms):
    """Tokens per split CTA of the paged kernel for B sequences of H
    heads of size D over tables of W blocks of BT tokens on a card of
    ``sms`` SMs, from the shapes only (``seq_lens`` stays on the device).
    f32 caches: ``_PAGED_CHUNK_F32``. bf16 caches: the f32 design's 32 KB
    of K and V in flight a CTA, 8192 / D tokens up to 128 (128 at D 64),
    unless the grid of B * H * ceil(W * BT / chunk) CTAs would then fall
    under two CTAs an SM: then 64."""
    if not bf16:
        return _PAGED_CHUNK_F32
    chunk = min(128, 8192 // d)
    if chunk > 64 and b * h * -(-w * bt // chunk) < 2 * sms:
        chunk = 64
    return chunk


def _paged_buffers(q, k_cache, block_tables, sms, stream):
    """What one paged kernel call on ``stream`` (a CUDA stream handle)
    of a card of ``sms`` SMs needs beside its inputs, on q's device:
    (chunk, out, scratch, counters). The scratch holds each split CTA's
    (max, sum, acc[D]) for ceil(W * BT / chunk) splits a (sequence,
    head); its slots past a sequence's length are neither written nor
    read. ``counters`` (bf16 caches; None for f32) is the (device,
    stream)'s merge-counter buffer, B * H int32 at least: zeroed when
    first made or grown, and left zero by every call."""
    b, h, d = q.shape
    bt = k_cache.shape[1]
    w = block_tables.shape[1]
    bf16 = k_cache.dtype == torch.bfloat16
    chunk = _paged_chunk(b, h, d, w, bt, bf16, sms)
    splits = -(-w * bt // chunk)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    scratch = torch.empty(b * h * splits * (2 + d), dtype=torch.float32,
                          device=q.device)
    counters = None
    if bf16:
        key = (q.device, stream)
        counters = _paged_counters.get(key)
        if counters is None or counters.numel() < b * h:
            counters = torch.zeros(b * h, dtype=torch.int32,
                                   device=q.device)
            _paged_counters[key] = counters
    return chunk, out, scratch, counters


def paged_attention(q, k_cache, v_cache, block_tables, seq_lens,
                    scale=None):
    """Single-query attention over a paged KV cache (the decode step).
    q: (B, H, D); k_cache/v_cache: (num_blocks, BT, H, D) pool of one
    layer; block_tables: (B, W) int32 pool block ids; seq_lens: (B,)
    int32 visible tokens (0 = padding row, output discarded). CPU
    tensors take :func:`paged_attention_plain`; CUDA tensors launch the
    kernels of ``csrc/paged_attention.cu`` for the caches' type (float32:
    split and merge; bfloat16, read into f32: one kernel that merges its
    splits itself, in chunks :func:`_paged_chunk` sizes) and count one
    launch per call in ``launches`` (float32 caches) or
    ``launches_bf16``. q is float32 either way, and so is the output.
    The caches are read in place, never copied: they must be contiguous.
    ``seq_lens`` is never read on the host."""
    name = "paged_attention"
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _devices(name, q, k_cache, v_cache, block_tables, seq_lens) == "cpu":
        return paged_attention_plain(q, k_cache, v_cache, block_tables,
                                     seq_lens, scale)
    _require(q.ndim == 3 and k_cache.ndim == 4, name,
             f"expected q (B, H, D) and caches (NB, BT, H, D), got "
             f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, h, d = q.shape
    nb, bt = k_cache.shape[:2]
    _require(k_cache.shape == v_cache.shape == (nb, bt, h, d), name,
             f"caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do "
             f"not match q {tuple(q.shape)}")
    _require(block_tables.ndim == 2 and block_tables.shape[0] == b
             and seq_lens.shape == (b,), name,
             f"tables {tuple(block_tables.shape)} / seq_lens "
             f"{tuple(seq_lens.shape)} do not match batch {b}")
    _require(q.dtype == torch.float32 and k_cache.dtype == v_cache.dtype
             and k_cache.dtype in _FLASH_TYPES, name,
             f"kernels take a float32 q over float32 or bfloat16 caches, "
             f"got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    _require(block_tables.dtype == torch.int32
             and seq_lens.dtype == torch.int32, name,
             "block_tables and seq_lens must be int32")
    _require(d in _PAGED_HEAD_DIMS, name,
             f"head size {d} not in {_PAGED_HEAD_DIMS}")
    _require(q.stride(-1) == 1, name, "q's head dimension must be contiguous")
    _require(k_cache.is_contiguous() and v_cache.is_contiguous()
             and block_tables.is_contiguous() and seq_lens.is_contiguous(),
             name, "caches, tables and seq_lens must be contiguous")
    _require(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
             name, "caches must be 16-byte aligned")
    _require(b <= 65535 and h <= 65535 and block_tables.shape[1] > 0
             and block_tables.shape[1] * bt < 2 ** 31, name,
             f"unsupported batch {b} / heads {h} / table width "
             f"{block_tables.shape[1]}")
    w = block_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    chunk, out, scratch, counters = _paged_buffers(
        q, k_cache, block_tables,
        torch.cuda.get_device_properties(q.device).multi_processor_count,
        stream)
    bf16 = counters is not None
    head = [q.data_ptr(), q.stride(0), q.stride(1), k_cache.data_ptr(),
            v_cache.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), scratch.data_ptr()]
    tail = [b, h, d, nb, bt, w, chunk, float(scale), q.device.index, stream]
    if bf16:
        fn = _fn("paged_attention", "mxt_paged_attention_bf16",
                 _PAGED_BF16_ARGS)
        err = fn(*head, counters.data_ptr(), *tail)
    else:
        fn = _fn("paged_attention", "mxt_paged_attention_f32", _PAGED_ARGS)
        err = fn(*head, *tail)
    _check(err, name)
    _count(paged_attention, bf16)
    return out


reset_launches()
