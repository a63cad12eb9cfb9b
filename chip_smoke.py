#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every kernel of the generative serving path from ``csrc/``;
3. hold each kernel against its plain PyTorch version on the card at
   the serving path's shapes (stated tolerances);
4. time each kernel, its plain version and, where one exists, the
   PyTorch library call that computes the same function; print one
   JSON line per kernel and the flash-vs-dense sweep over the prompt
   buckets;
5. drive the serving path: ``Gateway.register_generator`` with the
   documented decoder (vocab 32000, d_model 512, 8 layers, 8 heads,
   2.15 GB paged KV pool) and 32 concurrent streamed
   ``Gateway.generate`` requests; check lengths, one request token for
   token against the unpaged ``reference_generate``, and that the
   kernels' launch counts equal one per layer per prefill / decode step;
   print throughput and latencies, then serve the same requests again
   under torch.profiler for the device's time by kernel and idle share;
6. one ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout (no ``mxnet_tpu_torch`` beside this
file), it exits with a non-zero code.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
SEED = 0

# the decoder configuration docs/serving.md documents as its quickstart
VOCAB, D_MODEL, LAYERS, HEADS, MAX_PROMPT = 32000, 512, 8, 8, 512
BLOCK_TOKENS, MAX_BLOCKS, MAX_NEW, MAX_BATCH = 16, 4096, 256, 32
HEAD_DIM = D_MODEL // HEADS
TABLE_WIDTH = (MAX_PROMPT + MAX_NEW) // BLOCK_TOKENS

PAGED_TOL = 2e-5
FLASH_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def measure(fn, iters=50, warmup=5):
    """(device_ms, launch_ms) per call of ``fn()``. device_ms is the sum of
    the device activity (kernels, copies) torch.profiler records over the
    calls; launch_ms is the CUDA-event time from the first call to the
    last, which also counts the gaps while the host launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    check(device_us > 0, "torch.profiler recorded no device time")
    return device_us / iters / 1e3, start.elapsed_time(end) / iters


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


# -- phase 3/4: paged attention ---------------------------------------------
def paged_inputs(lens, layers, nb, dev, rng):
    """q, per-layer pool views, tables, seq_lens for one decode step:
    each row's live blocks are distinct pool blocks, the rest pad sink."""
    b = len(lens)
    q = torch.from_numpy(rng.standard_normal(
        (b, HEADS, HEAD_DIM), dtype=np.float32)).to(dev)
    shape = (layers, nb, BLOCK_TOKENS, HEADS, HEAD_DIM)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    need = [(n + BLOCK_TOKENS - 1) // BLOCK_TOKENS for n in lens]
    ids = rng.permutation(np.arange(1, nb))[:sum(need)]
    tables = np.zeros((b, TABLE_WIDTH), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = ids[at:at + n]
        at += n
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(np.asarray(lens, np.int32)).to(dev))


def phase_paged(att, dev, rng):
    # correctness: lengths on both sides of block boundaries, a 1, a full
    # table and a padding row (0, excluded from the comparison)
    lens = [1, 15, 16, 17, 31, 32, 33, 100, 255, 256, 257, 512,
            TABLE_WIDTH * BLOCK_TOKENS, 5, 48, 49]
    lens += list(rng.integers(2, TABLE_WIDTH * BLOCK_TOKENS, 15)) + [0]
    q, k, v, tab, sl = paged_inputs(lens, 1, MAX_BLOCKS, dev, rng)
    got = att.paged_attention(q, k[0], v[0], tab, sl)
    want = att.paged_attention_plain(q, k[0], v[0], tab, sl)
    torch.cuda.synchronize()
    live = torch.from_numpy(np.asarray(lens) > 0).to(dev)
    err = (got - want).abs()[live].max().item()
    check(bool(torch.all(got[~live] == 0)), "paged: seq_len-0 row not zeros")
    log(f"paged_attention: max abs err {err:.3e} (tol {PAGED_TOL})")
    check(err <= PAGED_TOL, f"paged_attention error {err} > {PAGED_TOL}")
    del k, v

    # timing at the serving path's decode shape: a full batch bucket of
    # 32 rows mid-generation, one pool per layer like the real cache so
    # consecutive calls find the L2 cold, as consecutive layers do
    lens = [int(n) for n in rng.integers(5, MAX_PROMPT + 1, MAX_BATCH) + 32]
    q, k, v, tab, sl = paged_inputs(lens, LAYERS, MAX_BLOCKS, dev,
                                    rng)
    layer = [0]

    def run(fn):
        def go():
            li = layer[0] = (layer[0] + 1) % LAYERS
            fn(q, k[li], v[li], tab, sl)
        return go

    ms, launch_ms = measure(run(att.paged_attention))
    plain_ms, _ = measure(run(att.paged_attention_plain), iters=10)
    live_tok = sum(lens)
    nbytes = (2 * live_tok * HEADS * HEAD_DIM * 4 + 2 * q.numel() * 4
              + tab.numel() * 4 + sl.numel() * 4)
    flops = 4 * live_tok * HEADS * HEAD_DIM
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S \
        else "operations"
    del k, v
    torch.cuda.empty_cache()
    return {"name": "paged_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:236",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "launch_ms": launch_ms,
            "shape": {"B": MAX_BATCH, "H": HEADS, "D": HEAD_DIM,
                      "BT": BLOCK_TOKENS, "W": TABLE_WIDTH,
                      "live_tokens": live_tok}}


# -- phase 3/4: flash attention ---------------------------------------------
def prefill_qkv(t, dev, rng):
    """q, k, v as the prefill step hands them to the kernel: (1, H, T, hd)
    views into one (1, T, 3d) projection output."""
    qkv = torch.from_numpy(rng.standard_normal(
        (1, t, 3 * D_MODEL), dtype=np.float32)).to(dev)
    return [y.view(1, t, HEADS, HEAD_DIM).transpose(1, 2)
            for y in qkv.chunk(3, dim=-1)]


def flash_cost(t):
    """Bytes (q, k, v read once, out written once) and causal flops."""
    nbytes = 4 * HEADS * t * HEAD_DIM * 4
    flops = 4 * HEADS * HEAD_DIM * t * (t + 1) // 2
    return nbytes, flops


def phase_flash(att, dev, rng):
    err = 0.0
    for t, causal in ((16, True), (48, True), (512, True), (48, False)):
        q, k, v = prefill_qkv(t, dev, rng)
        got = att.flash_attention(q, k, v, causal=causal)
        want = att.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        log(f"flash_attention T={t} causal={causal}: max abs err {e:.3e} "
            f"(tol {FLASH_TOL})")
        check(e <= FLASH_TOL, f"flash_attention T={t} error {e} > "
              f"{FLASH_TOL}")
        err = max(err, e)
    # the 3-d (BH, T, D) form
    q3, k3, v3 = (torch.from_numpy(rng.standard_normal(
        (HEADS, 40, HEAD_DIM), dtype=np.float32)).to(dev) for _ in range(3))
    e = (att.flash_attention(q3, k3, v3, causal=True)
         - att.flash_attention_plain(q3, k3, v3, causal=True)).abs().max()
    check(e.item() <= FLASH_TOL, f"flash_attention 3-d error {e.item()}")

    sweep = []
    for t in (16, 32, 64, 128, 256, 512):      # the prefill buckets
        q, k, v = prefill_qkv(t, dev, rng)
        row = {"T": t}
        row["ms"], row["launch_ms"] = measure(
            lambda: att.flash_attention(q, k, v, True))
        row["plain_ms"], row["plain_launch_ms"] = measure(
            lambda: att.flash_attention_plain(q, k, v, True))
        row["library_ms"], row["library_launch_ms"] = measure(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        nbytes, flops = flash_cost(t)
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                              flops / FP32_FLOPS_PER_S) * 1e3
        sweep.append(row)
    log("flash_sweep " + json.dumps(sweep))
    top = sweep[-1]
    nbytes, flops = flash_cost(top["T"])
    return {"name": "flash_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:43",
            "max_abs_err": err, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS_PER_S else "operations"),
            "library_ms": top["library_ms"], "launch_ms": top["launch_ms"],
            "shape": {"B": 1, "H": HEADS, "T": top["T"], "D": HEAD_DIM,
                      "causal": True}}


# -- phase 5: the serving path ----------------------------------------------
def phase_serve(att, dev, rng):
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                                  reference_generate)

    n_req = MAX_BATCH
    plens = np.linspace(5, MAX_PROMPT, n_req).astype(int)
    rng.shuffle(plens)
    new = rng.integers(32, 65, n_req)
    prompts = [rng.integers(0, VOCAB, int(p)).tolist() for p in plens]

    t0 = time.perf_counter()
    dec = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                            num_layers=LAYERS, num_heads=HEADS,
                            max_prompt_tokens=MAX_PROMPT, device=dev,
                            seed=SEED)
    log(f"decoder: {sum(p.numel() for p in dec.parameters())} parameters "
        f"on {dec.device} ({time.perf_counter() - t0:.2f}s)")

    att.reset_launches()
    gw = Gateway(device=dev)
    try:
        t0 = time.perf_counter()
        gen = gw.register_generator(
            "lm", dec, block_tokens=BLOCK_TOKENS, max_blocks=MAX_BLOCKS,
            max_new_tokens=MAX_NEW, max_decode_batch=MAX_BATCH)
        pool_bytes = gen.lane.pool.bytes_total
        log(f"register_generator: pool {pool_bytes / 1e9:.3f} GB, warmup "
            f"{time.perf_counter() - t0:.2f}s")
        check(pool_bytes == 2 * LAYERS * MAX_BLOCKS * BLOCK_TOKENS * HEADS
              * HEAD_DIM * 4, "pool size")

        streamed = [None] * n_req
        reqs = []

        def consume(i, req):
            streamed[i] = list(req.stream())

        t_start = time.perf_counter()
        threads = []
        for i in range(n_req):
            req = gw.generate("lm", prompts[i], max_new_tokens=int(new[i]),
                              stream=True)
            reqs.append(req)
            th = threading.Thread(target=consume, args=(i, req))
            th.start()
            threads.append(th)
        results = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t_start
        for th in threads:
            th.join(timeout=60)
            check(not th.is_alive(), "stream consumer still running")
        stats = gw.stats()["lm"]
        flash_n, paged_n = (att.flash_attention.launches,
                            att.paged_attention.launches)
        profile_traffic(gw, prompts, new)
    finally:
        gw.close()

    for i, (res, n) in enumerate(zip(results, new)):
        check(len(res) == n, f"request {i}: {len(res)} tokens, want {n}")
        check(streamed[i] == res, f"request {i}: stream != result")
        check(all(0 <= t < VOCAB for t in res), f"request {i}: bad token")
    lane = stats["lanes"][0]
    calls = lane["step_calls"]
    check(calls["prefill"] == len(stats["prompt_buckets"]) + n_req,
          f"prefill calls {calls['prefill']}")
    check(lane["prefills"] == n_req, f"prefills {lane['prefills']}")
    check(flash_n == calls["prefill"] * LAYERS,
          f"flash launches {flash_n} != {calls['prefill']} x {LAYERS}")
    check(paged_n == calls["decode"] * LAYERS,
          f"paged launches {paged_n} != {calls['decode']} x {LAYERS}")
    check(flash_n > 0 and paged_n > 0, "a kernel was never launched")

    # one request token for token against the unpaged plain-attention oracle
    pick = int(np.argsort(plens)[n_req // 2])
    t0 = time.perf_counter()
    ref = reference_generate(dec, prompts[pick], int(new[pick]))
    check(ref == results[pick],
          f"request {pick} (prompt {plens[pick]}) differs from "
          f"reference_generate:\n{results[pick]}\n{ref}")
    log(f"reference_generate: request {pick} (prompt {plens[pick]}, "
        f"{new[pick]} new) token-exact ({time.perf_counter() - t0:.2f}s)")

    gen_tokens = int(sum(new))
    # per request, on the host clock: submit -> first token (queue behind
    # the burst's other prefills + own prefill) and the mean gap between
    # its streamed tokens
    ttft = sorted((r.first_token_ns - r.submit_ns) / 1e6 for r in reqs)
    gaps = [(r.last_token_ns - r.first_token_ns) / 1e6 / (len(r.tokens) - 1)
            for r in reqs]
    main = {"requests": n_req, "generated_tokens": gen_tokens,
            "prompt_tokens": int(sum(plens)), "wall_s": wall,
            "tokens_per_s": gen_tokens / wall,
            "ttft_ms": {"mean": sum(ttft) / n_req, "p50": ttft[n_req // 2],
                        "max": ttft[-1]},
            "mean_inter_token_ms": sum(gaps) / n_req,
            "mean_prefill_ms": lane["prefill_ns"] / lane["prefills"] / 1e6,
            "mean_decode_step_ms": lane["decode_ns"]
            / lane["decode_steps"] / 1e6,
            "decode_steps": lane["decode_steps"],
            "mean_decode_rows": lane["decode_rows"] / lane["decode_steps"],
            "flash_launches": flash_n, "paged_launches": paged_n,
            "step_calls": calls}
    log("main_path " + json.dumps(main))
    return {"flash_attention": flash_n, "paged_attention": paged_n}


def profile_traffic(gw, prompts, new):
    """Serve the same requests again under torch.profiler: device time by
    kernel and the device's busy share of the window."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [gw.generate("lm", p, max_new_tokens=int(n), stream=True)
                for p, n in zip(prompts, new)]
        for r in reqs:
            r.result(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    groups = {}
    for ms, _, name in rows:
        low = name.lower()
        g = ("flash_attention" if "flash_attention_kernel" in name else
             "paged_attention" if "paged_attention_kernel" in name else
             "matmul" if any(w in low for w in ("gemm", "gemv", "cutlass",
                                                "xmma", "splitk")) else
             "copy" if "memcpy" in low or "memset" in low else "other")
        groups[g] = groups.get(g, 0.0) + ms
    log("profile " + json.dumps({
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "by_group_ms": groups,
        "top": [{"ms": ms, "count": c, "name": n[:90]}
                for ms, c, n in rows[:12]]}))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        fail(f"no mxnet_tpu_torch package beside {__file__}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, here)
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import attention as att

    # fp32 comparisons: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    card = card_line()
    check(card, "nvidia-smi reported no card")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    build_s = _build.build_all()
    log(f"build: {build_s:.1f}s for {', '.join(_build.KERNELS)}")

    kernels = [phase_flash(att, dev, rng),
               phase_paged(att, dev, rng)]

    launches = phase_serve(att, dev, rng)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        log("kernel " + json.dumps(k))
        k.pop("shape")
        k.pop("launch_ms")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
