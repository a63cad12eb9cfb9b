"""Attention kernels of the decode plane: the port's counterparts of
``flash_attention`` and ``paged_attention`` in
``mxnet_tpu/ops/pallas_kernels.py``.

Each entry point has three parts:

- a plain PyTorch version (``flash_attention_plain``,
  ``paged_attention_plain``), the counterpart of the JAX package's
  ``_dense_reference`` / ``_paged_gather_reference`` and the oracle the
  kernels are held against;
- a hand-written CUDA kernel for sm_90a in ``csrc/`` (see the note at
  the top of each source for the TPU kernel it replaces, its bound on
  the H100 and how its design meets it), built by :mod:`._build`;
- a wrapper that sends tensors on the CPU to the plain version and
  tensors on a CUDA device to the kernel. It raises on any input the
  kernel does not take; nothing falls back. Each kernel launch adds one
  to the wrapper's ``launches`` count.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

NEG_INF = -1e30


def reset_launches():
    flash_attention.launches = 0
    paged_attention.launches = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path and oracles)
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, causal=False, scale=None):
    """Dense attention. q, k, v: (B, H, T, D) or (BH, T, D). When
    causal and T_q < T_k the queries are the last T_q positions of the
    key sequence (the decoder convention of the JAX reference)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    t_q, t_k = q.shape[-2], k.shape[-2]
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    if causal:
        if t_q > t_k:
            raise MXNetError(
                f"causal attention with t_q ({t_q}) > t_k ({t_k}) leaves "
                "queries with no visible keys; pad K/V or drop causal")
        q_pos = torch.arange(t_q, device=q.device)[:, None] + (t_k - t_q)
        mask = torch.arange(t_k, device=q.device)[None, :] <= q_pos
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)


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
_FLASH_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I, _I, _P]
_PAGED_ARGS = [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
               _I, _F, _I, _P]
_FLASH_HEAD_DIMS = (16, 32, 64, 128)
_PAGED_HEAD_DIMS = (32, 64, 128)


def _fn(name, symbol, argtypes):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _aligned(x):
    """cp.async copies 16 bytes: the base address and every stride but
    the last (unit) one must be multiples of 16 bytes."""
    return (x.data_ptr() % 16 == 0
            and all(st % 4 == 0 for st in x.stride()[:-1]))


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

def flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise attention forward. q, k, v: (B, H, T, D) or (BH, T, D).
    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch
    the kernel of ``csrc/flash_attention.cu`` (fp32, D in {16, 32, 64,
    128}, unit stride along D, 16-byte aligned base addresses and
    strides, causal only with T_q == T_k) and count one launch. The
    output has q's shape; on CUDA it is laid out (B, T, H, D) so the
    caller's head merge is a view."""
    name = "flash_attention"
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _devices(name, q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    _require(q.ndim in (3, 4) and q.ndim == k.ndim == v.ndim, name,
             f"expected (B, H, T, D) or (BH, T, D), got {tuple(q.shape)}")
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    _require(k.shape == v.shape == (b, h, t_k, d), name,
             f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(all(x.dtype == torch.float32 for x in (q, k, v)), name,
             f"kernel takes float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    _require(d in _FLASH_HEAD_DIMS, name,
             f"head size {d} not in {_FLASH_HEAD_DIMS}")
    _require(all(x.stride(-1) == 1 for x in (q, k, v)), name,
             "the head dimension must be contiguous (stride 1)")
    _require(all(_aligned(x) for x in (q, k, v)), name,
             "q, k and v need 16-byte aligned base addresses and strides "
             "(multiples of 4 elements)")
    _require(not causal or t_q == t_k, name,
             f"causal kernel needs t_q == t_k, got {t_q} and {t_k}")
    _require(t_q > 0 and t_k > 0 and b * h * t_q < 2 ** 31, name,
             f"unsupported shape {tuple(q.shape)} x {t_k}")
    out = torch.empty((b, t_q, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*[s for x in (q, k, v, out)
                                       for s in x.stride()[:3]])
    fn = _fn("flash_attention", "mxt_flash_attention_f32", _FLASH_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, h, t_q, t_k, d, strides, float(scale), int(bool(causal)),
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _check(err, name)
    flash_attention.launches += 1
    return out.squeeze(1) if squeeze else out


def paged_attention(q, k_cache, v_cache, block_tables, seq_lens,
                    scale=None):
    """Single-query attention over a paged KV cache (the decode step).
    q: (B, H, D); k_cache/v_cache: (num_blocks, BT, H, D) pool of one
    layer; block_tables: (B, W) int32 pool block ids; seq_lens: (B,)
    int32 visible tokens (0 = padding row, output discarded). CPU
    tensors take :func:`paged_attention_plain`; CUDA tensors launch the
    split and merge kernels of ``csrc/paged_attention.cu`` and count one
    launch per call. The caches are read in place, never copied: they
    must be contiguous. ``seq_lens`` is never read on the host."""
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
    _require(all(x.dtype == torch.float32 for x in (q, k_cache, v_cache)),
             name, f"kernel takes float32, got {q.dtype}/{k_cache.dtype}")
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
    chunk = _fn("paged_attention", "mxt_paged_attention_chunk", [])()
    splits = -(-w * bt // chunk)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    # each split CTA's (max, sum, acc[d]); slots past a sequence's length
    # are neither written nor read
    scratch = torch.empty(b * h * splits * (2 + d), dtype=torch.float32,
                          device=q.device)
    fn = _fn("paged_attention", "mxt_paged_attention_f32", _PAGED_ARGS)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), k_cache.data_ptr(),
             v_cache.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
             out.data_ptr(), scratch.data_ptr(), b, h, d, nb, bt, w,
             float(scale), q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    _check(err, name)
    paged_attention.launches += 1
    return out


flash_attention.launches = 0
paged_attention.launches = 0
