#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every kernel of the port from ``csrc/``, one ``nvcc`` per
   source, all at once;
3. hold each kernel against its plain PyTorch version on the card at
   its main path's shapes (stated tolerances; the INT8 epilogue
   bitwise, on ties, clip edges and an odd size too). The flash kernel
   at every prefill bucket and head size 16/32/64/128, over all cases no
   further from an f64 run than twice the fp32 plain version, and its
   SASS must hold TF32 tensor-core instructions (cuobjdump); the paged
   kernel at lengths on both sides of its 64-token splits, seq_len-0
   rows zeros;
4. time each kernel, its plain version and, where one exists, the
   PyTorch library call that computes the same function; print one
   JSON line per kernel, the flash sweep over the prompt buckets (with
   the 3xTF32 and fp32 bounds) and the paged rows at B 32 and B 1;
5. drive the serving path: ``Gateway.register_generator`` with the
   documented decoder (vocab 32000, d_model 512, 8 layers, 8 heads,
   2.15 GB paged KV pool) and 32 concurrent streamed
   ``Gateway.generate`` requests; check lengths, one request token for
   token against the unpaged ``reference_generate``, and that the
   kernels' launch counts equal one per layer per prefill / decode step;
   print throughput and latencies, then serve the same requests again
   under torch.profiler for the device's time by kernel and idle share;
6. drive the INT8 inference path at full width: a seeded random
   ResNet-50 v1 checkpoint (``model.save_checkpoint``), then
   ``load_checkpoint`` → ``quantize_model`` (naive calibration on 8
   seeded images) → ``get_backend_symbol("XLA")`` → ``simple_bind`` at
   batch 128 x 3x224x224 → ``forward``; check the 53 fused quantized
   convolutions, exactly 53 epilogue-kernel launches in one forward and
   no plain epilogue on the card, and the first 2 images' logits
   bitwise against the same graph run on the CPU; print fp32 and int8
   images/s and the int8 forward's device time by group and idle share;
7. K2, the fused optimizer kernels: ``fused_sgd_mom`` and ``fused_adam``
   bitwise against their plain versions at sizes 1, 7, 64, 1,000,003 and
   ResNet-50's largest tensor (2,359,296), clip on and off, ``wd`` 0 and
   not, ``rescale`` not 1, Adam variances with zeros, in place; timed
   per call at the largest tensor (cold L2) and per step over the 161
   trainable ResNet-50 tensors;
8. drive the symbolic training path at full width: the same seeded
   checkpoint, ``SoftmaxOutput`` on top, ``simple_bind(grad_req="write")``
   at batch 128 x 3x224x224, then 10 steps of ``forward(is_train=True)``
   → ``backward`` → ``nd.sgd_mom_update`` on each of the 161 trainable
   tensors, on one seeded batch; check exactly 161 K2 launches per step,
   finite losses that fall, and no plain update on the card; print the
   step time, images/s and one step's device time by group and idle
   share; then one step at batch 4 on the card against the CPU plain
   path (loss, two gradients, an updated weight);
9. 3 Adam steps at batch 32 through ``nd.adam_update`` (bias correction
   folded into lr): 161 launches per step, finite, falling loss;
10. one ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout (no ``mxnet_tpu_torch`` beside this
file), it exits with a non-zero code.
"""
from __future__ import annotations

import json
import os
import shutil
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
TF32_FLOPS_PER_S = 495e12      # H100 SXM TF32 on the tensor cores, dense
SEED = 0

# the decoder configuration docs/serving.md documents as its quickstart
VOCAB, D_MODEL, LAYERS, HEADS, MAX_PROMPT = 32000, 512, 8, 8, 512
BLOCK_TOKENS, MAX_BLOCKS, MAX_NEW, MAX_BATCH = 16, 4096, 256, 32
HEAD_DIM = D_MODEL // HEADS
TABLE_WIDTH = (MAX_PROMPT + MAX_NEW) // BLOCK_TOKENS

PAGED_TOL = 2e-5
FLASH_TOL = 1e-4

# the repo's INT8 cell: ResNet-50 v1 at batch 128 (bench.py BATCH)
R50_SHAPE = (128, 3, 224, 224)
R50_QUANT_CONVS = 53
CALIB_IMAGES = 8
CPU_IMAGES = 2
# the smallest and largest of the 53 conv accumulators at batch 128
EPI_SMALLEST = (128, 512, 7, 7)      # 3,211,264 int32
EPI_LARGEST = (128, 256, 56, 56)     # 102,760,448 int32

# the training path: the classic symbolic loop of the reference's
# example/image-classification at ResNet-50 v1's full width and depth
TRAIN_BATCH, TRAIN_STEPS, R50_TRAINABLE = 128, 10, 161
# lr 0.1 (the reference's for batch 256 with a warm-up) overshoots on one
# fixed batch from random weights and ends above the first loss; 0.01
# brings the loss down step by step
SGD_HYPER = dict(lr=0.01, momentum=0.9, wd=1e-4)
ADAM_BATCH, ADAM_STEPS = 32, 3
ADAM_HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=1e-4)
PARITY_BATCH = 4
# one training step on the card vs the CPU plain path. In f64 the two
# run the same algorithm and agree to rounding (1e-9 of each tensor's
# largest value). In f32 their sums run in another order (cuDNN vs the
# CPU's kernels): the loss to rtol 1e-5 and the FC weight's gradient and
# update to 1e-4 of their largest value, as the CPU tests against the
# JAX package hold them. The stem's weight gradient, under 53
# BatchNorms at batch 4, is ill-conditioned in f32 (both devices are
# some 3% of its largest value off the f64 run), so it is held to the
# f64 run: the card no further from it than twice the CPU.
PARITY_LOSS_RTOL, PARITY_TENSOR_TOL, PARITY_F64_TOL = 1e-5, 1e-4, 1e-9
PARITY_STEM_RATIO = 2.0
K2_LARGEST = 512 * 512 * 3 * 3       # stage 4's 3x3 convolution weight


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
    # correctness: lengths on both sides of block boundaries and of the
    # kernel's 64-token splits, a 1, a full table and a padding row (0,
    # excluded from the comparison and held to zeros)
    lens = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 191,
            192, 193, 255, 256, 257, 512, TABLE_WIDTH * BLOCK_TOKENS - 1,
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
    # consecutive calls find the L2 cold, as consecutive layers do; then
    # one row at the full table
    rows = []
    for lens in ([int(n) for n in rng.integers(5, MAX_PROMPT + 1, MAX_BATCH)
                  + 32], [TABLE_WIDTH * BLOCK_TOKENS]):
        q, k, v, tab, sl = paged_inputs(lens, LAYERS, MAX_BLOCKS, dev, rng)
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
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       flops / FP32_FLOPS_PER_S) * 1e3
        rows.append({"B": len(lens), "live_tokens": live_tok, "ms": ms,
                     "launch_ms": launch_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_share": bound_ms / ms,
                     "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                  >= flops / FP32_FLOPS_PER_S
                                  else "operations")})
        del k, v
        torch.cuda.empty_cache()
    log("paged_timing " + json.dumps(rows))
    top = rows[0]
    return {"name": "paged_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:236",
            "max_abs_err": err, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "launch_ms": top["launch_ms"],
            "shape": {"B": MAX_BATCH, "H": HEADS, "D": HEAD_DIM,
                      "BT": BLOCK_TOKENS, "W": TABLE_WIDTH,
                      "live_tokens": top["live_tokens"]}}


# -- phase 3/4: flash attention ---------------------------------------------
def prefill_qkv(t, dev, rng, hd=HEAD_DIM):
    """q, k, v as the prefill step hands them to the kernel: (1, H, T, hd)
    views into one (1, T, 3d) projection output (H = d_model / hd)."""
    qkv = torch.from_numpy(rng.standard_normal(
        (1, t, 3 * D_MODEL), dtype=np.float32)).to(dev)
    return [y.view(1, t, D_MODEL // hd, hd).transpose(1, 2)
            for y in qkv.chunk(3, dim=-1)]


def flash_cost(t):
    """Bytes (q, k, v read once, out written once) and causal flops."""
    nbytes = 4 * HEADS * t * HEAD_DIM * 4
    flops = 4 * HEADS * HEAD_DIM * t * (t + 1) // 2
    return nbytes, flops


def flash_bounds(t):
    """(bound ms on the route the kernel takes: 3xTF32 products, three
    TF32 products each; bound ms on the fp32 FMA pipes; what bounds the
    first)."""
    nbytes, flops = flash_cost(t)
    mem_s = nbytes / HBM_BYTES_PER_S
    tf32_s = 3 * flops / TF32_FLOPS_PER_S
    return (max(mem_s, tf32_s) * 1e3,
            max(mem_s, flops / FP32_FLOPS_PER_S) * 1e3,
            "bytes" if mem_s >= tf32_s else "operations")


def flash_sass(build):
    """The flash kernel's SASS must run both products on the tensor cores
    in TF32 (HMMA ... TF32 from mma.sync, or HGMMA): cuobjdump on the
    built library, counting the instructions of the kernel's functions."""
    tool = None
    for cand in ("cuobjdump", os.path.join(os.environ.get(
            "CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")):
        if (found := shutil.which(cand)) or os.path.exists(cand):
            tool = found or cand
            break
    check(tool is not None, "cuobjdump not found: cannot check the SASS")
    lib = str(build._target("flash_attention"))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "flash_attention_kernel" in fn and (
                ("HMMA" in line and "TF32" in line) or "HGMMA" in line):
            counts[fn] = counts.get(fn, 0) + 1
    check(len(counts) == 4 and all(counts.values()),
          f"flash_attention: tensor-core TF32 instructions per kernel "
          f"instance {counts} (want all 4 head sizes)")
    log("flash_attention SASS: TF32 tensor-core instructions per head "
        "size " + json.dumps(sorted(counts.values())))
    return counts


def phase_flash(att, build, dev, rng):
    flash_sass(build)
    # every prefill bucket at every head size the kernel takes, causal as
    # the prefill runs it, some lengths no bucket has, and non-causal.
    # Besides the fp32 plain version, an f64 plain run on the same inputs:
    # over all cases the kernel's largest error against it may be no more
    # than twice the fp32 plain version's (a 1xTF32 product would be ~1e-3
    # off). Per case the two are maxima over a few hundred values each and
    # 3xTF32 keeps 22 of an operand's 24 bits, so one case may read 2x
    err, err_kernel, err_plain, worst_ratio = 0.0, 0.0, 0.0, 0.0
    cases = [(t, hd, True) for hd in (16, 32, 64, 128)
             for t in (16, 32, 64, 128, 256, 512)]
    cases += [(48, 64, True), (48, 64, False), (512, 64, False),
              (100, 128, False)]
    for t, hd, causal in cases:
        q, k, v = prefill_qkv(t, dev, rng, hd)
        got = att.flash_attention(q, k, v, causal=causal)
        want = att.flash_attention_plain(q, k, v, causal=causal)
        exact = att.flash_attention_plain(q.double(), k.double(),
                                          v.double(), causal=causal)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        e_kernel = (got.double() - exact).abs().max().item()
        e_plain = (want.double() - exact).abs().max().item()
        log(f"flash_attention T={t} D={hd} causal={causal}: max abs err "
            f"{e:.3e} (tol {FLASH_TOL}); vs f64 kernel {e_kernel:.3e}, "
            f"fp32 plain {e_plain:.3e}")
        check(e <= FLASH_TOL, f"flash_attention T={t} D={hd} error {e} > "
              f"{FLASH_TOL}")
        err = max(err, e)
        err_kernel = max(err_kernel, e_kernel)
        err_plain = max(err_plain, e_plain)
        worst_ratio = max(worst_ratio, e_kernel / e_plain)
    log(f"flash_attention vs f64 over {len(cases)} cases: kernel "
        f"{err_kernel:.3e}, fp32 plain {err_plain:.3e}; worst case ratio "
        f"{worst_ratio:.3f}")
    check(err_kernel <= 2 * err_plain, f"flash_attention: {err_kernel:.3e} "
          f"off the f64 run, more than twice the fp32 plain version's "
          f"{err_plain:.3e}")
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
        row["bound_ms"], row["fp32_bound_ms"], row["bound_by"] = \
            flash_bounds(t)
        sweep.append(row)
    log("flash_sweep " + json.dumps(sweep))
    top = sweep[-1]
    return {"name": "flash_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:43",
            "max_abs_err": err, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
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
        g = ("flash_attention" if "flash_attention" in name else
             "paged_attention" if "paged_attention" in name else
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


# -- phase 3/4: INT8 requantize epilogue -----------------------------------
def epilogue_acc(shape, dev, gen, bound=2 ** 20):
    """int32 accumulators in the order the int8 convolution writes
    them: NCHW in shape, channels-last in memory."""
    n, c, h, w = shape
    acc = torch.randint(-bound, bound, (n, h, w, c), dtype=torch.int32,
                        device=dev, generator=gen)
    return acc.permute(0, 3, 1, 2)


def phase_int8(i8, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    # realistic scales: in * out ~ 1.9e-4, so |acc| < 2^20 spans about
    # +-200 and part of it clips; 0.125 * 4 = 1/2 puts every odd
    # accumulator on an exact .5 tie and +-255 on the clip edges
    s_in = torch.tensor(1.1e-4, dtype=torch.float32, device=dev)
    s_out = np.float32(1.7)
    cases = [
        ("ties_and_clip_edges", torch.arange(-300, 301, dtype=torch.int32,
                                             device=dev),
         torch.tensor(0.125, device=dev), np.float32(4.0)),
        ("odd_size_1000003", torch.randint(
            -2 ** 20, 2 ** 20, (1_000_003,), dtype=torch.int32,
            device=dev, generator=gen), s_in, s_out),
        ("smallest", epilogue_acc(EPI_SMALLEST, dev, gen), s_in, s_out),
        ("largest", epilogue_acc(EPI_LARGEST, dev, gen), s_in, s_out),
        ("largest_both_scales_on_device",
         epilogue_acc(EPI_LARGEST, dev, gen), s_in,
         torch.tensor(s_out, device=dev)),
    ]
    err = 0
    for name, acc, a, b in cases:
        for relu in (False, True):
            got = i8.int8_conv_epilogue(acc, a, b, relu)
            want = i8.int8_conv_epilogue_plain(acc, a, b, relu)
            torch.cuda.synchronize()
            check(got.dtype == torch.int8 and got.shape == acc.shape,
                  f"int8_epilogue {name}: {got.dtype} {tuple(got.shape)}")
            check(torch.equal(got, want),
                  f"int8_epilogue {name} relu={relu}: differs from the "
                  "plain version")
            err = max(err, (got.int() - want.int()).abs().max().item())
        log(f"int8_epilogue {name} {tuple(acc.shape)}: bitwise equal")
    acc = cases[3][1]
    ms, launch_ms = measure(lambda: i8.int8_conv_epilogue(acc, s_in, s_out,
                                                         True))
    plain_ms, _ = measure(lambda: i8.int8_conv_epilogue_plain(
        acc, s_in, s_out, True), iters=10)
    nbytes = acc.numel() * 5          # int32 read once, int8 written once
    ops = acc.numel() * 5             # mul, mul, round, clamp, relu
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S) * 1e3
    del cases, acc
    torch.cuda.empty_cache()
    return {"name": "int8_epilogue", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/int8_epilogue.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:364",
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / FP32_FLOPS_PER_S else "operations"),
            "library_ms": None, "launch_ms": launch_ms,
            "shape": {"acc": list(EPI_LARGEST), "relu": True}}


# -- phase 6: the INT8 inference path ----------------------------------------
def resnet_params(sym, rng):
    """Seeded fp32 weights (He-normal) and BatchNorm parameters and
    statistics away from the identity, as numpy."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + R50_SHAPE[1:])
    arg, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("beta"):
            v = rng.uniform(-0.2, 0.2, shape)
        else:
            v = rng.standard_normal(shape) * np.sqrt(
                2.0 / np.prod(shape[1:]))
        arg[name] = v.astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        v = (rng.uniform(-0.1, 0.1, shape) if "mean" in name
             else rng.uniform(0.5, 2.0, shape))
        aux[name] = v.astype(np.float32)
    return arg, aux


def time_forward(ex, data, iters=5):
    """Seconds per forward at steady state (host clock to a sync)."""
    ex.forward(data=data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        ex.forward(data=data)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def profile_forward(ex, data):
    """One int8 forward under torch.profiler: device time by group and
    the device's idle share of the forward's wall time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.forward(data=data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    groups = {}
    for ms, _, name in rows:
        low = name.lower()
        g = ("int8_epilogue" if "int8_epilogue_kernel" in name else
             "int8_conv_gemm" if any(w in low for w in (
                 "gemm", "xmma", "cutlass", "imma")) else
             "int8_conv_im2col" if "im2col" in low else "other")
        groups[g] = groups.get(g, 0.0) + ms
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "by_group_ms": groups,
            "top": [{"ms": ms, "count": c, "name": n[:90]}
                    for ms, c, n in rows[:12]]}


def phase_resnet(i8, dev, rng, here):
    import collections

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.quantization import quantize_model

    t0 = time.perf_counter()
    sym = mx.model_zoo.load_symbol("resnet50_v1")
    arg, aux = resnet_params(sym, rng)
    prefix = os.path.join(here, "build", "chip_smoke", "resnet50_v1")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    with mx.cpu():
        mx.model.save_checkpoint(
            prefix, 0, sym, {k: mx.nd.array(v) for k, v in arg.items()},
            {k: mx.nd.array(v) for k, v in aux.items()})
    sym, arg_p, aux_p = mx.model.load_checkpoint(prefix, 0)
    check(all(v.context == mx.gpu(0) for v in arg_p.values()),
          "load_checkpoint did not put the parameters on cuda:0")
    n_params = sum(v.size for v in arg_p.values())
    log(f"resnet50_v1: {n_params} parameters, checkpoint written and "
        f"loaded ({time.perf_counter() - t0:.2f}s)")
    x = rng.standard_normal(R50_SHAPE, dtype=np.float32)
    calib = rng.standard_normal((CALIB_IMAGES,) + R50_SHAPE[1:],
                                dtype=np.float32)
    data = mx.nd.array(x)

    ex32 = sym.simple_bind(grad_req="null", data=R50_SHAPE)
    ex32.copy_params_from(arg_p, aux_p)
    fp32_s = time_forward(ex32, data)
    logits32 = ex32.outputs[0].asnumpy()
    del ex32
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    qsym, qarg, qaux = quantize_model(
        sym, arg_p, aux_p, calib_mode="naive",
        calib_data=mx.io.NDArrayIter(calib, batch_size=CALIB_IMAGES),
        num_calib_examples=CALIB_IMAGES)
    quant_s = time.perf_counter() - t0
    fused = qsym.get_backend_symbol("XLA")
    counts = collections.Counter(n.op for n in fused._topo() if n.op)
    check(counts["_sg_xla_quant_conv"] == R50_QUANT_CONVS,
          f"partition: {dict(counts)}")
    ex8 = fused.simple_bind(grad_req="null", data=R50_SHAPE,
                            **{k: v.shape for k, v in qarg.items()})
    ex8.copy_params_from(qarg, qaux, allow_extra_params=True)

    # the main path's counted run: one forward, counts zeroed before it;
    # the plain epilogue is watched for any call with a CUDA tensor
    plain = i8.int8_conv_epilogue_plain
    plain_on_card = [0]

    def watched(acc, *a, **k):
        plain_on_card[0] += acc.is_cuda
        return plain(acc, *a, **k)

    i8.int8_conv_epilogue_plain = watched
    try:
        i8.reset_launches()
        out = ex8.forward(data=data)[0]
        torch.cuda.synchronize()
        launches = i8.int8_conv_epilogue.launches
    finally:
        i8.int8_conv_epilogue_plain = plain
    check(launches == R50_QUANT_CONVS,
          f"int8_epilogue launches {launches} != {R50_QUANT_CONVS}")
    check(plain_on_card[0] == 0, "the plain epilogue ran on the card")
    logits8 = out.asnumpy()
    check(logits8.shape == (R50_SHAPE[0], 1000) and
          np.isfinite(logits8).all(), f"int8 logits {logits8.shape}")
    int8_s = time_forward(ex8, data)
    prof = profile_forward(ex8, data)
    del ex8, out
    torch.cuda.empty_cache()

    # the same fused graph on the CPU (plain versions) for the first
    # images: every range is a calibrated constant and every op acts per
    # image, so the batch does not change a row
    t0 = time.perf_counter()
    with mx.cpu():
        args = {k: v.as_in_context(mx.cpu()) for k, v in qarg.items()}
        args["data"] = mx.nd.array(x[:CPU_IMAGES])
        cpu = fused.bind(args=args, grad_req="null").forward()[0]
        cpu_logits = cpu.asnumpy()
    check(np.array_equal(cpu_logits, logits8[:CPU_IMAGES]),
          "int8 logits on the card differ from the CPU plain path: max "
          f"{np.abs(cpu_logits - logits8[:CPU_IMAGES]).max()}")
    cpu_s = time.perf_counter() - t0
    log(f"int8 logits: first {CPU_IMAGES} images bitwise equal to the "
        f"CPU plain path ({cpu_s:.1f}s)")

    top1 = float((logits8.argmax(1) == logits32.argmax(1)).mean())
    rel = float(np.abs(logits8 - logits32).mean()
                / np.abs(logits32).mean())
    main = {"batch": R50_SHAPE[0], "fp32_images_per_s": R50_SHAPE[0] / fp32_s,
            "int8_images_per_s": R50_SHAPE[0] / int8_s,
            "fp32_forward_ms": fp32_s * 1e3, "int8_forward_ms": int8_s * 1e3,
            "quantize_model_s": quant_s, "partition": dict(counts),
            "int8_epilogue_launches": launches,
            "int8_vs_fp32": {"top1_agreement": top1,
                             "mean_rel_abs_err": rel},
            "int8_profile": prof}
    log("resnet50_int8 " + json.dumps(main))
    return {"int8_epilogue": launches}


# -- phase 7: K2, the fused optimizer kernels --------------------------------
SGD_CASES = (dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=1 / 128),
             dict(lr=0.037, momentum=0.87, wd=3e-4, rescale_grad=1 / 3,
                  clip_gradient=0.25),
             dict(lr=0.05, momentum=1.0, wd=0.0, rescale_grad=1.0))
ADAM_CASES = (dict(lr=0.01, wd=1e-4, rescale_grad=1 / 32),
              dict(lr=0.0037, beta1=0.85, beta2=0.99, epsilon=1e-6, wd=3e-4,
                   rescale_grad=1 / 3, clip_gradient=0.25),
              dict(lr=0.002, wd=0.0, rescale_grad=0.7))
SGD_BYTES, ADAM_BYTES = 20, 28       # per element: each array once
SGD_OPS, ADAM_OPS = 6, 15            # flops per element


def k2_arrays(n, dev, gen):
    """weight, grad, momentum / mean, variance (non-negative, zeros) at
    the scales training gives them."""
    w, g, m, v = (torch.randn(n, device=dev, generator=gen) * s
                  for s in (0.05, 3.0, 0.01, 1e-3))
    v = v.abs()
    v[::7] = 0
    return w, g, m, v


def resnet_trainable_shapes():
    import mxnet_tpu_torch as mx
    sym = mx.model_zoo.load_symbol("resnet50_v1")
    shapes = sym.infer_shape(data=(1,) + R50_SHAPE[1:])[0]
    return [s for n, s in zip(sym.list_arguments(), shapes) if n != "data"]


def k2_bound_ms(n, per_elem_bytes, per_elem_ops):
    return max(n * per_elem_bytes / HBM_BYTES_PER_S,
               n * per_elem_ops / FP32_FLOPS_PER_S) * 1e3


def phase_fused_opt(fo, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err = {"fused_sgd_mom": 0.0, "fused_adam": 0.0}

    def same(name, what, got, want):
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"{name} {what}: differs from the "
                  f"plain version by {(a - b).abs().max().item()}")
            err[name] = max(err[name], (a - b).abs().max().item())

    for n in (1, 7, 64, 1_000_003, K2_LARGEST):
        w, g, m, v = k2_arrays(n, dev, gen)
        for hp in SGD_CASES:
            want = fo.sgd_mom_plain(w, g, m, **hp)
            same("fused_sgd_mom", f"n={n} {hp}",
                 fo.fused_sgd_mom(w, g, m, **hp), want)
            w2, m2 = w.clone(), m.clone()
            same("fused_sgd_mom", f"n={n} {hp} in place",
                 fo.fused_sgd_mom(w2, g, m2, **hp, out=(w2, m2)), want)
        for hp in ADAM_CASES:
            want = fo.adam_plain(w, g, m, v, **hp)
            same("fused_adam", f"n={n} {hp}",
                 fo.fused_adam(w, g, m, v, **hp), want)
            w2, m2, v2 = w.clone(), m.clone(), v.clone()
            same("fused_adam", f"n={n} {hp} in place",
                 fo.fused_adam(w2, g, m2, v2, **hp, out=(w2, m2, v2)), want)
        log(f"fused_opt n={n}: sgd_mom and adam bitwise equal to their "
            "plain versions (every case, in place too)")

    # per call at the largest tensor: eight sets of arrays in turn, so
    # each call finds the 50 MB L2 cold, as consecutive tensors of a step do
    sets = [k2_arrays(K2_LARGEST, dev, gen) for _ in range(8)]
    turn = [0]

    def rotating(fn):
        def go():
            w, g, m, v = sets[turn[0] % len(sets)]
            turn[0] += 1
            fn(w, g, m, v)
        return go

    # (name, kernel, plain version, hyperparameters, bytes and flops per
    # element, state arrays)
    specs = (("fused_sgd_mom", fo.fused_sgd_mom, fo.sgd_mom_plain,
              dict(SGD_HYPER, rescale_grad=1.0 / TRAIN_BATCH), SGD_BYTES,
              SGD_OPS, 1),
             ("fused_adam", fo.fused_adam, fo.adam_plain,
              dict(ADAM_HYPER, rescale_grad=1.0 / TRAIN_BATCH), ADAM_BYTES,
              ADAM_OPS, 2))
    rows = {}
    for name, kernel, plain, hp, nbytes, ops, nstates in specs:
        def call(w, g, m, v, f=kernel, k=nstates, hp=hp):
            st = (m, v)[:k]
            f(w, g, *st, **hp, out=(w, *st))

        def call_plain(w, g, m, v, f=plain, k=nstates, hp=hp):
            f(w, g, *(m, v)[:k], **hp)

        ms, launch_ms = measure(rotating(call))
        plain_ms, _ = measure(rotating(call_plain), iters=10)
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/fused_opt.cu",
            "replaces": ("mxnet_tpu/ops/pallas_kernels.py:498"
                         if name == "fused_sgd_mom" else
                         "mxnet_tpu/ops/pallas_kernels.py:507"),
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": k2_bound_ms(K2_LARGEST, nbytes, ops),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / FP32_FLOPS_PER_S else "operations"),
            # torch.optim's fused SGD / Adam apply wd and the bias
            # correction otherwise: no PyTorch call computes this function
            "library_ms": None, "launch_ms": launch_ms,
            "shape": {"n": K2_LARGEST, "hyper": hp}}
    del sets

    # per step: one call per trainable ResNet-50 tensor
    shapes = resnet_trainable_shapes()
    total = sum(int(np.prod(s)) for s in shapes)
    arrays = [k2_arrays(int(np.prod(s)), dev, gen) for s in shapes]
    step = {"tensors": len(shapes), "values": total}
    for name, kernel, plain, hp, nbytes, ops, nstates in specs:
        def all_kernel(f=kernel, k=nstates, hp=hp):
            for w, g, m, v in arrays:
                st = (m, v)[:k]
                f(w, g, *st, **hp, out=(w, *st))

        def all_plain(f=plain, k=nstates, hp=hp):
            for w, g, m, v in arrays:
                f(w, g, *(m, v)[:k], **hp)

        ms, launch_ms = measure(all_kernel, iters=20)
        plain_ms, _ = measure(all_plain, iters=2, warmup=1)
        step[name] = {"ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
                      "bound_ms": k2_bound_ms(total, nbytes, ops)}
        rows[name]["step"] = step[name]
    log("fused_opt_step " + json.dumps(step))
    del arrays
    torch.cuda.empty_cache()
    return [rows["fused_sgd_mom"], rows["fused_adam"]]


# -- phase 8/9: the symbolic training path -----------------------------------
def cross_entropy(prob, label, eps=1e-12):
    """Mean -log(p[label] + eps) of SoftmaxOutput's probabilities, as the
    repo's ``metric.CrossEntropy`` computes it (a 0-d tensor on their
    device)."""
    picked = prob.gather(1, label.long().reshape(-1, 1))
    return -torch.log(picked + eps).mean()


class PlainOnCard:
    """Counts calls of the K2 plain versions with CUDA tensors while
    active: the main path must take the kernels."""

    def __init__(self, fo):
        self.fo, self.calls = fo, 0

    def __enter__(self):
        self.saved = (self.fo.sgd_mom_plain, self.fo.adam_plain)

        def watch(fn):
            def watched(weight, *a, **k):
                self.calls += weight.is_cuda
                return fn(weight, *a, **k)
            return watched

        self.fo.sgd_mom_plain, self.fo.adam_plain = map(watch, self.saved)
        return self

    def __exit__(self, *exc):
        self.fo.sgd_mom_plain, self.fo.adam_plain = self.saved
        return False


def train_net(mx, here):
    """The seeded checkpoint the INT8 phase wrote, with SoftmaxOutput on
    top: (net, trainable names, arg_params, aux_params) on cuda:0."""
    prefix = os.path.join(here, "build", "chip_smoke", "resnet50_v1")
    sym, arg_p, aux_p = mx.model.load_checkpoint(prefix, 0)
    net = mx.sym.SoftmaxOutput(sym, name="softmax")
    params = [n for n in net.list_arguments()
              if n not in ("data", "softmax_label")]
    check(len(params) == R50_TRAINABLE,
          f"{len(params)} trainable tensors, want {R50_TRAINABLE}")
    return net, params, arg_p, aux_p


def train_executor(mx, net, batch, arg_p, aux_p, ctx):
    ex = net.simple_bind(ctx, grad_req="write",
                         data=(batch,) + R50_SHAPE[1:],
                         softmax_label=(batch,))
    ex.copy_params_from(arg_p, aux_p)
    return ex


def train_step(mx, ex, params, states, x, y, hp, adam_t=None):
    """forward(is_train=True) -> backward -> one update op per trainable
    tensor; returns the forward's loss (a device tensor)."""
    out = ex.forward(is_train=True, data=x, softmax_label=y)[0]
    ex.backward()
    for n in params:
        w = ex.arg_dict[n]
        if adam_t is None:
            mx.nd.sgd_mom_update(w, ex.grad_dict[n], states[n][0], out=w,
                                 **hp)
        else:
            # optimizer.Adam's bias correction, folded into lr
            b1, b2 = hp["beta1"], hp["beta2"]
            lr_t = hp["lr"] * np.sqrt(1 - b2 ** adam_t) / (1 - b1 ** adam_t)
            mx.nd.adam_update(w, ex.grad_dict[n], *states[n], out=w,
                              **dict(hp, lr=lr_t))
    return cross_entropy(out._data, y._data)


def kernel_group(name):
    low = name.lower()
    if "sgd_mom" in low or "adam<" in low or "::adam" in low:
        return "k2"
    if "wgrad" in low or "dgrad" in low or ("conv" in low and (
            "bwd" in low or "backward" in low)):
        return "conv_backward"
    if "fprop" in low or "conv" in low or "implicit" in low:
        return "conv_forward"
    if "bn_" in low or "batch_norm" in low or "batchnorm" in low \
            or "welford" in low:
        return "batchnorm"
    if "gemm" in low or "gemv" in low:
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "elementwise_other"


def profile_step(fn):
    """One training step under torch.profiler: device time by group and
    the device's idle share of the step's wall time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    groups, counts = {}, {}
    for ms, c, name in rows:
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
        counts[g] = counts.get(g, 0) + c
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "by_group_ms": groups, "by_group_launches": counts,
            "top": [{"ms": ms, "count": c, "name": n[:90]}
                    for ms, c, n in rows[:15]]}


def forward_flops(sym, batch):
    """Floating-point operations of the convolutions and the FC layer in
    one forward at ``batch`` (2 per multiply-add)."""
    shape = (batch,) + R50_SHAPE[1:]
    arg_shapes = dict(zip(sym.list_arguments(),
                          sym.infer_shape(data=shape)[0]))
    internals = sym.get_internals()
    out_shapes = dict(zip(internals.list_outputs(),
                          internals.infer_shape(data=shape)[1]))
    flops = 0
    for node in sym._topo():
        if node.op in ("Convolution", "FullyConnected"):
            weight = arg_shapes[node.inputs[1][0].name]
            out = out_shapes[node.name + "_output"]
            flops += 2 * int(np.prod(out)) * int(np.prod(weight[1:]))
    return flops


def phase_train(fo, dev, rng, here):
    import mxnet_tpu_torch as mx

    net, params, arg_p, aux_p = train_net(mx, here)
    t0 = time.perf_counter()
    ex = train_executor(mx, net, TRAIN_BATCH, arg_p, aux_p, mx.gpu(0))
    states = {n: [mx.nd.zeros(ex.arg_dict[n].shape, ctx=mx.gpu(0))]
              for n in params}
    x_np = rng.standard_normal((TRAIN_BATCH,) + R50_SHAPE[1:],
                               dtype=np.float32)
    y_np = rng.integers(0, 1000, TRAIN_BATCH).astype(np.float32)
    x, y = mx.nd.array(x_np), mx.nd.array(y_np)
    hp = dict(SGD_HYPER, rescale_grad=1.0 / TRAIN_BATCH)
    log(f"train: simple_bind + copy_params_from at batch {TRAIN_BATCH} "
        f"({time.perf_counter() - t0:.2f}s)")

    # the main path's counted run: counts zeroed just before it
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    with PlainOnCard(fo) as plain:
        fo.reset_launches()
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(train_step(mx, ex, params, states, x, y, hp))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = fo.fused_sgd_mom.launches
        adam_launches = fo.fused_adam.launches
    check(plain.calls == 0, "a plain K2 update ran on the card")
    check(launches == R50_TRAINABLE * TRAIN_STEPS and adam_launches == 0,
          f"fused_sgd_mom launches {launches} != {R50_TRAINABLE} x "
          f"{TRAIN_STEPS} (adam {adam_launches})")
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_s = float(np.median(secs[-5:]))
    prof = profile_step(lambda: train_step(mx, ex, params, states, x, y,
                                           hp))
    check(all(torch.isfinite(ex.arg_dict[n]._data).all() for n in params),
          "non-finite weights after training")
    del ex, states, x
    torch.cuda.empty_cache()

    parity = train_parity(mx, net, params, arg_p, aux_p, x_np, y_np, hp)
    # forward, data gradient and weight gradient: three products each
    step_flops = 3 * forward_flops(net, TRAIN_BATCH)
    main = {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "losses": losses,
            "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in secs],
            "images_per_s": TRAIN_BATCH / step_s,
            "conv_fc_flops_per_step": step_flops,
            "conv_fc_fp32_bound_ms": step_flops / FP32_FLOPS_PER_S * 1e3,
            "fused_sgd_mom_launches": launches,
            "launches_per_step": launches / TRAIN_STEPS,
            "peak_memory_gb": peak_gb, "step_profile": prof,
            "parity_batch4": parity}
    log("resnet50_train " + json.dumps(main))
    return launches


def train_parity(mx, net, params, arg_p, aux_p, x_np, y_np, hp):
    """One step at PARITY_BATCH from the checkpoint on the card and on
    the CPU plain path, in f32 (with the FC weight's update) and in f64
    (forward and backward only: K2 takes f32): the loss, the stem's and
    the FC's weight gradients, the FC weight after its update."""
    conv_w = params[0]
    fc_w = next(n for n in params if n.endswith("dense0_weight"))
    hp = dict(hp, rescale_grad=1.0 / PARITY_BATCH)
    got = {}
    for dt in ("float32", "float64"):
        for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            t0 = time.perf_counter()
            with ctx:
                ex = train_executor(
                    mx, net, PARITY_BATCH,
                    {k: v.astype(dt) for k, v in arg_p.items()},
                    {k: v.astype(dt) for k, v in aux_p.items()}, ctx)
                x = mx.nd.array(x_np[:PARITY_BATCH], dtype=dt)
                y = mx.nd.array(y_np[:PARITY_BATCH], dtype=dt)
                if dt == "float32":
                    states = {fc_w: [mx.nd.zeros(ex.arg_dict[fc_w].shape)]}
                    loss = train_step(mx, ex, [fc_w], states, x, y, hp)
                else:
                    out = ex.forward(is_train=True, data=x,
                                     softmax_label=y)[0]
                    ex.backward()
                    loss = cross_entropy(out._data, y._data)
                got[where, dt] = {
                    "loss": float(loss),
                    "stem_grad": ex.grad_dict[conv_w].asnumpy(),
                    "fc_grad": ex.grad_dict[fc_w].asnumpy(),
                    "fc_updated": ex.arg_dict[fc_w].asnumpy(),
                    "s": time.perf_counter() - t0}
            del ex

    def rel(a, b, key):
        return float(np.abs(a[key].astype(np.float64) - b[key]).max()
                     / np.abs(b[key]).max())

    card32, cpu32 = got["card", "float32"], got["cpu", "float32"]
    card64, cpu64 = got["card", "float64"], got["cpu", "float64"]
    res = {"loss_card": card32["loss"], "loss_cpu": cpu32["loss"],
           "loss_f64": cpu64["loss"],
           "cpu_s": cpu32["s"] + cpu64["s"]}
    check(abs(card64["loss"] - cpu64["loss"]) <= PARITY_F64_TOL
          * abs(cpu64["loss"]), "f64 loss card vs CPU")
    for key in ("stem_grad", "fc_grad"):
        res[key + "_f64_rel"] = r = rel(card64, cpu64, key)
        check(r <= PARITY_F64_TOL, f"f64 {key}: card vs CPU {r}")
    check(abs(card32["loss"] - cpu32["loss"]) <= PARITY_LOSS_RTOL
          * abs(cpu32["loss"]), f"batch-{PARITY_BATCH} loss card "
          f"{card32['loss']} vs CPU {cpu32['loss']}")
    for key in ("fc_grad", "fc_updated"):
        res[key + "_rel"] = r = rel(card32, cpu32, key)
        check(r <= PARITY_TENSOR_TOL, f"f32 {key}: card vs CPU differ by "
              f"{r} of the largest (> {PARITY_TENSOR_TOL})")
    res["stem_grad_card_vs_f64"] = card_err = rel(card32, cpu64,
                                                  "stem_grad")
    res["stem_grad_cpu_vs_f64"] = cpu_err = rel(cpu32, cpu64, "stem_grad")
    check(card_err <= PARITY_STEM_RATIO * cpu_err,
          f"f32 stem gradient: card {card_err} vs CPU {cpu_err} of the "
          "largest off the f64 run")
    log(f"train parity: batch {PARITY_BATCH} step on the card matches the "
        f"CPU plain path in f64 and f32 ({res['cpu_s']:.1f}s on the CPU)")
    return res


def phase_train_adam(fo, dev, rng, here):
    import mxnet_tpu_torch as mx

    net, params, arg_p, aux_p = train_net(mx, here)
    ex = train_executor(mx, net, ADAM_BATCH, arg_p, aux_p, mx.gpu(0))
    states = {n: [mx.nd.zeros(ex.arg_dict[n].shape) for _ in range(2)]
              for n in params}
    x = mx.nd.array(rng.standard_normal((ADAM_BATCH,) + R50_SHAPE[1:],
                                        dtype=np.float32))
    y = mx.nd.array(rng.integers(0, 1000, ADAM_BATCH).astype(np.float32))
    hp = dict(ADAM_HYPER, rescale_grad=1.0 / ADAM_BATCH)
    losses = []
    with PlainOnCard(fo) as plain:
        fo.reset_launches()
        for t in range(1, ADAM_STEPS + 1):
            losses.append(train_step(mx, ex, params, states, x, y, hp,
                                     adam_t=t))
        torch.cuda.synchronize()
        launches = fo.fused_adam.launches
        sgd_launches = fo.fused_sgd_mom.launches
    check(plain.calls == 0, "a plain K2 update ran on the card")
    check(launches == R50_TRAINABLE * ADAM_STEPS and sgd_launches == 0,
          f"fused_adam launches {launches} != {R50_TRAINABLE} x "
          f"{ADAM_STEPS} (sgd {sgd_launches})")
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite Adam loss: {losses}")
    check(losses[-1] < losses[0], f"Adam loss did not fall: {losses}")
    log("resnet50_train_adam " + json.dumps({
        "batch": ADAM_BATCH, "steps": ADAM_STEPS, "losses": losses,
        "fused_adam_launches": launches}))
    del ex, states, x
    torch.cuda.empty_cache()
    return launches


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
    from mxnet_tpu_torch.ops import fused_opt as fo
    from mxnet_tpu_torch.ops import int8 as i8

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

    kernels = [phase_flash(att, _build, dev, rng),
               phase_paged(att, dev, rng),
               phase_int8(i8, dev),
               *phase_fused_opt(fo, dev)]

    launches = phase_serve(att, dev, rng)
    launches.update(phase_resnet(i8, dev, rng, here))
    launches["fused_sgd_mom"] = phase_train(fo, dev, rng, here)
    launches["fused_adam"] = phase_train_adam(fo, dev, rng, here)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        log("kernel " + json.dumps(k))
        for extra in ("shape", "launch_ms", "step"):
            k.pop(extra, None)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
