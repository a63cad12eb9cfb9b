#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

To time another commit's paged-attention kernels (K4) the way phase 3
times this checkout's, in the same call (parent against change), unpack
it into a directory and run::

    python3 chip_smoke.py --time-paged DIR

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
   kernel at lengths on both sides of its 64- and 128-token splits,
   seq_len-0 rows zeros, the same bits from the next call, 20 calls in
   a row over 8 layer pools each within its bound, calls on two streams
   at once the one-stream bits, rows of a 4,096-token table at B 32 and
   B 1 (more splits than the bf16 kernel merges in one batch), and which
   kernels the calls launch (f32: split and merge; bf16: its one kernel,
   no merge kernel), each once a call; the
   flash backward (dQ, dK, dV with the forward's log-sum-exp; TF32
   tensor-core instructions in all 8 of its pass instances) against its
   plain version at the decoder-LM training path's shape (B 8, H 12, T
   2048, D 64, causal, strided views of one projection) and at head
   sizes 16 / 32 / 128, non-causal 128 x 192, ragged T 100 (rtol 1e-4 /
   atol 1e-5), over all cases no further from an f64 run than twice the
   plain fp32 pipeline, on unaligned views the bits of aligned copies,
   and the same bits from two calls at the LM shape;
4. time each kernel, its plain version and, where one exists, the
   PyTorch library call that computes the same function (device time
   from CUDA events over calls queued behind a spin of the card, launch
   gaps between kernels included); print one
   JSON line per kernel, the flash sweep over the prompt buckets (with
   the 3xTF32 and fp32 bounds, and the forward with its log-sum-exp
   output beside it), the paged rows at B 32 and B 1 (with the chunk
   the wrapper chose) and the flash backward at the training shape
   beside SDPA's backward, which it must beat (its passes' device ms
   too); each beside the time of the kernel's earlier design;
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
   share, and the memory the last forward's graph holds until the next
   forward (kept for a second ``backward``); then one step at batch 4 on
   the card against the CPU plain path (loss, two gradients, an updated
   weight);
9. 3 Adam steps at batch 32 through ``nd.adam_update`` (bias correction
   folded into lr): 161 launches per step, finite, falling loss;
10. gluon inference and one-shot serving at full width: gluon
   ``resnet50_v1`` (NCHW, standard stem) on ``cuda:0`` from seeded
   weights, hybridized, forward at batch 128 x 3x224x224 in fp32 (TF32
   off; median of 5 after a warm one, images/s, one forward's device
   time by group and idle share), its logits against the same weights
   through ``export`` → ``load_checkpoint`` → ``simple_bind`` →
   ``forward`` (1e-5 of their scale), the first 2 images against the
   CPU gluon path (1e-4) and the NHWC / s2d net against the NCHW one
   (1e-4); then ``Gateway.register_checkpoint`` on the export with the
   fp32, bf16 and int8 (native) variants, buckets 1-32, max_wait 2 ms,
   naive calibration on 8 images (18 executables warmed), and per
   variant a burst of 64 requests of 1-4 seeded images: every reply's
   shape and dtype, fp32 against the direct ``Predictor`` (1e-5 of the
   scale), bf16 and int8 against fp32 (the JAX package's bounds, and
   neither bitwise fp32); images/s, p50 / p90 / max latency, rows per
   batch, padding, and one fp32
   burst's device time and idle share; then ``quantize_net`` at batch 32
   (int8 bound, and whether its calibration table equals the
   gateway's). No kernel of the port launches in this phase;
11. gluon training through the imperative tape at full width: the same
   seeded gluon ``resnet50_v1``, hybridized, batch 128 x 3x224x224, 10
   steps of ``autograd.record()`` -> forward ->
   ``SoftmaxCrossEntropyLoss`` -> ``backward`` -> ``Trainer.step`` (SGD,
   momentum 0.9, lr 0.01) on one seeded batch, in fp32 and in bf16 with
   fp32 masters (``cast("bfloat16")``, ``multi_precision``): losses
   finite and falling; step ms, images/s, peak memory, the host ms of
   ``Trainer.step``, one step's and one ``Trainer.step``'s device time
   by group and idle share. The first fp32 step's loss against the same
   weights and batch through ``export`` -> ``simple_bind`` (1e-5), one
   batch-4 step against the CPU gluon path (phase 8's bounds), and the
   SGD class's update on the card within 1 ulp of one rounding per
   multiply-add. The Trainer's SGD computes its own update: no kernel of
   the port launches in this phase;
12. decoder-LM training through gluon at GPT-2 small's widths
   (``bench.py``'s transformer configuration): the port's
   ``GenerativeDecoder(vocab 50304, d_model 768, 12 layers, 12 heads,
   ff_mult 4)`` block in fp32 (TF32 off), tokens (8, 2048) from the
   seed, 5 steps of ``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` on
   next-token labels -> ``backward`` -> ``gluon.Trainer("adam", lr
   1e-4).step(8)``: exactly 12 flash forward and 12 flash backward
   launches a step; the first loss near ln 50304 and finite, falling
   losses; the first step's loss against the same step with the plain
   attention (forward and backward) on the card, and every parameter's
   gradient no further from an f64 run of that step than twice the fp32
   plain step's (the same step with TF32 products must fail that bound);
   step ms, tokens/s, peak memory, one step's device time by group and
   idle share;
13. bf16 through the decoder: the bf16 K3 forward (its SASS must hold
   BF16 tensor-core instructions at all four head sizes) at every
   prefill bucket and head size and at the decoder-LM shape, and the
   bf16 K3 backward through the autograd Function at the LM shape and a
   small grid, each within the JAX package's bf16 bound (rtol 0.1 /
   atol 0.05) and no further from an f64 run on the same bf16 inputs
   than twice the plain bf16 version (the backward also within one bf16
   ulp of the plain backward given the same forward output, and given
   unaligned views of its inputs the bits it gives on aligned copies,
   and the same bits from two calls at the LM shape); K4 over
   bf16 caches with f32 queries against its plain version (2e-5); each
   timed at the path's shape beside its bound and the library call
   (SDPA's bf16 forward, and forward plus backward; K4 at B 32 and B 1,
   cold L2). Then phase 12's decoder block cast to bf16, Adam with f32
   masters (``multi_precision``), 5 steps: exactly 12 bf16 flash forward
   and 12 bf16 flash backward launches a step and no fp32 one, the
   first loss and every gradient no further from an f32 run of the step
   than twice the plain-attention bf16 step's; step ms, tokens/s, peak
   memory, idle share, ``Trainer.step`` host ms, device ms by group. Then
   ``GenerativeDecoder(dtype="bfloat16")`` at phase 5's widths (bf16
   Dense and Embedding weights, f32 LayerNorm, a bf16 pool of half the
   f32 pool's bytes) serving phase 5's burst: 8 bf16-cache K4 launches a
   decode step, tokens equal to those of the same lane with the plain
   paged attention, and how many equal ``reference_generate`` (whose
   K/V are not rounded to bf16: information, no gate);
14. one ``{"kernels": [...]}`` line, then the result line
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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# ``measure``'s spin, in cycles a second: at least the card's clock, so
# the spin lasts at least as long as asked
SPIN_CYCLES_PER_S = 2.0e9
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


def profiled(fn, calls):
    """{entry: (records, device us)} of ``calls`` calls of ``fn`` under
    torch.profiler, for the entries with device time (kernels, copies).
    Later in a run the profiler on the card loses records, at times all
    of a window's: a window that recorded no device time is taken again,
    three in all ({} if none recorded any)."""
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages() if e.self_device_time_total > 0}
        if rows:
            return rows
    log(f"torch.profiler recorded no device time in three windows of "
        f"{calls} calls")
    return {}


def measure(fn, iters=50, warmup=5):
    """(device_ms, launch_ms) per call of ``fn()``, from CUDA events.
    launch_ms: over calls launched back to back, host gaps included.
    device_ms: over calls queued behind a spin of the card that lasts
    longer than the host took to launch them, so the card runs them back
    to back: its time, the gaps between kernels included. (torch.profiler
    is not used here: on the card it loses kernel records, and late in a
    run the durations it records disagree with the events.) If the card
    reached the calls before the host had queued them all (a call that
    waits for the card, or more launches than the queue holds), device_ms
    is the device time torch.profiler recorded (launch_ms where it
    recorded none), and a line says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launch_ms = start.elapsed_time(end) / iters
    torch.cuda._sleep(int((0.005 + 2 * host_s) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    if ahead:
        return start.elapsed_time(end) / iters, launch_ms
    device_us = sum(us for _, us in profiled(fn, iters).values())
    device_ms = device_us / iters / 1e3 if device_us else launch_ms
    log(f"the card caught up with the host in {iters} calls: device time "
        f"{device_ms} ms a call from " + ("torch.profiler" if device_us
                                          else "the launch events"))
    return device_ms, launch_ms


def kernels_launched(fn, calls):
    """{kernel name: records} of ``calls`` calls of ``fn`` from
    torch.profiler (``profiled``; a kernel is an entry with device time;
    the profiler may lose records, so a count is at most the launches)."""
    return {k: n for k, (n, _) in profiled(fn, calls).items()}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


# -- phase 3/4: paged attention ---------------------------------------------
def paged_inputs(lens, layers, nb, dev, rng, width=TABLE_WIDTH):
    """q, per-layer pool views, tables of ``width`` blocks, seq_lens for
    one decode step: each row's live blocks are distinct pool blocks, the
    rest pad sink."""
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
    tables = np.zeros((b, width), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = ids[at:at + n]
        at += n
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(np.asarray(lens, np.int32)).to(dev))


# calls in a row over the layer pools at the decode shape
PAGED_RUN = 20
# the table of the long-row case: more splits than the bf16 kernel's
# merge batch of 16 at either of its chunks
PAGED_LONG_TOKENS = 4096
# the decode step timed at B 32 (9,536 live tokens): the lengths phase 3
# draws from the seed, kept here so that another commit is timed on them
PAGED_DECODE_LENS = [284, 184, 257, 119, 49, 479, 491, 133, 70, 413, 505,
                     350, 105, 287, 91, 297, 219, 219, 507, 344, 409, 201,
                     342, 477, 212, 406, 384, 369, 260, 91, 480, 502]
# the paged kernels' earlier times at B 32 and B 1 (full table), measured by
# this script on an NVIDIA H100 80GB HBM3 at 700 W: f32 the split and merge
# kernels (unchanged), bf16 the same split and merge kernels over bf16
PAGED_EARLIER_MS = {"paged_attention": (0.02012, 0.00748),
                    "paged_attention_bf16": (0.01296, 0.00654)}


def paged_row(att, dev, rng, cache, lens, name, earlier_ms=None):
    """K4 over ``cache``-typed pools at ``lens``, one pool per layer like
    the real cache, so consecutive calls find the L2 cold, as
    consecutive layers do: first PAGED_RUN calls in a row (a decode
    step's and more), each within PAGED_TOL of the plain version and the
    same bits as the first call on its pool; then timed (``measure``),
    beside the plain version and the bound. Only the wrappers' common interface is used,
    so any commit's ``ops/attention.py`` can be timed so."""
    q, k, v, tab, sl = paged_inputs(lens, LAYERS, MAX_BLOCKS, dev, rng)
    k, v = k.to(cache), v.to(cache)
    plain = [att.paged_attention_plain(q, k[li], v[li], tab, sl)
             for li in range(LAYERS)]
    seen = {}
    for i in range(PAGED_RUN):
        li = i % LAYERS
        o = att.paged_attention(q, k[li], v[li], tab, sl)
        e = (o - plain[li]).abs().max().item()
        check(e <= PAGED_TOL, f"{name}: call {i} (layer {li}) off the "
              f"plain version by {e}")
        check(torch.equal(o, seen.setdefault(li, o)),
              f"{name}: call {i} differs from layer {li}'s first")
    del plain, seen
    layer = [0]

    def run(fn):
        def go():
            li = layer[0] = (layer[0] + 1) % LAYERS
            fn(q, k[li], v[li], tab, sl)
        return go

    ms, launch_ms = measure(run(att.paged_attention))
    plain_ms, _ = measure(run(att.paged_attention_plain), iters=10)
    live_tok = sum(lens)
    nbytes = (2 * live_tok * HEADS * HEAD_DIM * k.element_size()
              + 2 * q.numel() * 4 + tab.numel() * 4 + sl.numel() * 4)
    flops = 4 * live_tok * HEADS * HEAD_DIM
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
    del k, v
    torch.cuda.empty_cache()
    return {"B": len(lens), "live_tokens": live_tok, "ms": ms,
            "earlier_ms": earlier_ms, "launch_ms": launch_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_share": bound_ms / ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS_PER_S else "operations")}


def time_paged_tree(root):
    """K4's timing rows (both cache types, B 32 at PAGED_DECODE_LENS and
    B 1 at the full table) for the checkout at ``root``, as
    ``phase_paged`` times this one: another commit's kernels timed the
    same way in the same call."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = os.path.abspath(root)
    check(os.path.isdir(os.path.join(root, "mxnet_tpu_torch")),
          f"no mxnet_tpu_torch package in {root}")
    sys.path.insert(0, root)
    from mxnet_tpu_torch.ops import attention as att
    dev = torch.device("cuda", 0)
    log(card_line())
    log(f"paged timing of {att.__file__}")
    for cache in (torch.float32, torch.bfloat16):
        name = "paged_attention" + ("_bf16" if cache == torch.bfloat16
                                    else "")
        rng = np.random.default_rng(SEED)
        rows = [paged_row(att, dev, rng, cache, lens, name)
                for lens in (PAGED_DECODE_LENS,
                             [TABLE_WIDTH * BLOCK_TOKENS])]
        log(f"{name.replace('attention', 'timing')} " + json.dumps(rows))
    return 0


def phase_paged(att, dev, rng, cache=torch.float32, decode_lens=None):
    """K4 with f32 queries over ``cache``-typed pools (float32, or
    bfloat16: the bf16 decoder's pool, read exactly into f32 by both the
    kernel and the plain version) against the plain version, and timed at
    ``decode_lens`` (drawn here when None; the result's shape holds them,
    so that both cache types are timed on the same lengths)."""
    name = "paged_attention" + ("_bf16" if cache == torch.bfloat16 else "")
    # correctness: lengths on both sides of block boundaries and of the
    # kernel's 64-token splits, a 1, a full table and a padding row (0,
    # excluded from the comparison and held to zeros)
    lens = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 191,
            192, 193, 255, 256, 257, 512, TABLE_WIDTH * BLOCK_TOKENS - 1,
            TABLE_WIDTH * BLOCK_TOKENS, 5, 48, 49]
    lens += list(rng.integers(2, TABLE_WIDTH * BLOCK_TOKENS, 15)) + [0]
    q, k, v, tab, sl = paged_inputs(lens, 1, MAX_BLOCKS, dev, rng)
    k, v = k.to(cache), v.to(cache)
    got = att.paged_attention(q, k[0], v[0], tab, sl)
    want = att.paged_attention_plain(q, k[0], v[0], tab, sl)
    torch.cuda.synchronize()
    check(got.dtype == torch.float32, f"{name}: output {got.dtype}")
    live = torch.from_numpy(np.asarray(lens) > 0).to(dev)
    err = (got - want).abs()[live].max().item()
    check(bool(torch.all(got[~live] == 0)), f"{name}: seq_len-0 row not "
          "zeros")
    log(f"{name}: max abs err {err:.3e} (tol {PAGED_TOL})")
    check(err <= PAGED_TOL, f"{name} error {err} > {PAGED_TOL}")
    # the same bits from the next call (the bf16 kernel's merge counters
    # are back at zero), and the kernel launches one call makes: the f32
    # kernels split and merge, the bf16 kernel merges in itself
    again = att.paged_attention(q, k[0], v[0], tab, sl)
    check(torch.equal(got, again), f"{name}: two calls differ in their bits")
    # which kernels run (torch.profiler: it may lose records, so each
    # kernel at most once a call), and the wrapper's launches, once a call
    bf16 = cache == torch.bfloat16
    count = "launches_bf16" if bf16 else "launches"
    counted = getattr(att.paged_attention, count)
    launched = kernels_launched(
        lambda: att.paged_attention(q, k[0], v[0], tab, sl), PAGED_RUN)
    counted = getattr(att.paged_attention, count) - counted
    paged = {key[key.find("paged_attention"):].split("(")[0]: n
             for key, n in launched.items() if "paged_attention" in key}
    want = (("paged_attention_bf16_kernel",) if bf16
            else ("paged_attention_kernel", "paged_attention_merge_kernel"))
    check(counted == PAGED_RUN and len(paged) == len(want) and all(
        any(w in key for key in paged) for w in want)
        and all(0 < n <= PAGED_RUN for n in paged.values()),
        f"{name}: {counted} wrapper launches and kernels recorded {paged} "
        f"in {PAGED_RUN} calls, want {PAGED_RUN} and {want}, each at most "
        "once a call")
    log(f"{name}: kernels recorded in {PAGED_RUN} calls " + json.dumps(paged))
    # calls in flight on two streams at once (the bf16 kernel's merge
    # counters are kept per stream): each gives the one-stream bits
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize()
    outs = []
    for i in range(2 * PAGED_RUN):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(att.paged_attention(q, k[0], v[0], tab, sl))
    torch.cuda.synchronize()
    check(all(torch.equal(o, got) for o in outs),
          f"{name}: calls on two streams differ from one stream's bits")
    del k, v, outs

    # long rows: a 4,096-token table, so the bf16 kernel merges more
    # splits than one batch of its merge holds (32 of 128 tokens at B 32,
    # 64 of 64 at B 1); lengths about its 16-split batches, a 0 row. A
    # generator of their own leaves the timing's lengths as they were
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    long_w = PAGED_LONG_TOKENS // BLOCK_TOKENS
    lrng = np.random.default_rng(SEED + 1)
    long_b32 = ([PAGED_LONG_TOKENS, PAGED_LONG_TOKENS - 1, 2049, 2048, 2047,
                 1025, 1024, 1023, 0]
                + [int(n) for n in lrng.integers(2, PAGED_LONG_TOKENS, 23)])
    for lens in (long_b32, [PAGED_LONG_TOKENS]):
        q, k, v, tab, sl = paged_inputs(lens, 1, 1 + len(lens) * long_w,
                                        dev, lrng, long_w)
        k, v = k.to(cache), v.to(cache)
        got = att.paged_attention(q, k[0], v[0], tab, sl)
        want = att.paged_attention_plain(q, k[0], v[0], tab, sl)
        live = torch.from_numpy(np.asarray(lens) > 0).to(dev)
        e = (got - want).abs()[live].max().item()
        chunk = att._paged_chunk(len(lens), HEADS, HEAD_DIM, long_w,
                                 BLOCK_TOKENS, cache == torch.bfloat16, sms)
        log(f"{name}: B {len(lens)} over {PAGED_LONG_TOKENS}-token tables, "
            f"chunk {chunk} ({-(-max(lens) // chunk)} splits): max abs err "
            f"{e:.3e} (tol {PAGED_TOL})")
        check(e <= PAGED_TOL, f"{name}: long rows (B {len(lens)}) error {e}")
        check(bool(torch.all(got[~live] == 0)), f"{name}: long rows' "
              "seq_len-0 row not zeros")
        check(torch.equal(got, att.paged_attention(q, k[0], v[0], tab, sl)),
              f"{name}: long rows (B {len(lens)}): two calls differ")
        del q, k, v, got, want
        torch.cuda.empty_cache()

    # timing at the serving path's decode shape: a full batch bucket of
    # 32 rows mid-generation; then one row at the full table
    if decode_lens is None:
        decode_lens = [int(n) for n in rng.integers(5, MAX_PROMPT + 1,
                                                     MAX_BATCH) + 32]
        check(decode_lens == PAGED_DECODE_LENS, f"decode lengths drawn "
              f"{decode_lens}, not PAGED_DECODE_LENS")
    rows = []
    for lens in (decode_lens, [TABLE_WIDTH * BLOCK_TOKENS]):
        row = paged_row(att, dev, rng, cache, lens, name,
                        PAGED_EARLIER_MS[name][len(rows)])
        row["chunk"] = att._paged_chunk(len(lens), HEADS, HEAD_DIM,
                                        TABLE_WIDTH, BLOCK_TOKENS, bf16, sms)
        rows.append(row)
    log(f"{name.replace('attention', 'timing')} " + json.dumps(rows))
    top = rows[0]
    return {"name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:236",
            "max_abs_err": err, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "launch_ms": top["launch_ms"],
            "shape": {"B": MAX_BATCH, "H": HEADS, "D": HEAD_DIM,
                      "BT": BLOCK_TOKENS, "W": TABLE_WIDTH,
                      "live_tokens": top["live_tokens"],
                      "cache": str(cache).rsplit(".", 1)[-1],
                      "decode_lens": decode_lens}}


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


def flash_sass(build, lib="flash_attention", kernel="flash_attention_kernel",
               kind="TF32", count=4):
    """The SASS of ``kernel``'s instances in the built library ``lib``
    must run their products on the tensor cores: cuobjdump, counting in
    each function whose name holds ``kernel`` the HMMA instructions of
    ``kind`` (TF32 or BF16, from mma.sync) or, for BF16, HGMMA (wgmma);
    kind "HGMMA" counts HGMMA alone. ``count`` functions must have some:
    one per head size and pass."""
    tool = None
    for cand in ("cuobjdump", os.path.join(os.environ.get(
            "CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")):
        if (found := shutil.which(cand)) or os.path.exists(cand):
            tool = found or cand
            break
    check(tool is not None, "cuobjdump not found: cannot check the SASS")
    sass = subprocess.run([tool, "-sass", str(build._target(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and kernel in fn and (
                "HGMMA" in line if kind == "HGMMA" else
                ("HMMA" in line and kind in line)
                or (kind == "BF16" and "HGMMA" in line)):
            counts[fn] = counts.get(fn, 0) + 1
    check(len(counts) == count and all(counts.values()),
          f"{lib} {kernel}: tensor-core {kind} instructions per kernel "
          f"instance {counts} (want all {count})")
    log(f"{lib} {kernel} SASS: {kind} tensor-core instructions per "
        "instance " + json.dumps(sorted(counts.values())))
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
        # the forward as training runs it: with its log-sum-exp, saved
        # for the backward
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
        row["lse_ms"], row["lse_launch_ms"] = measure(
            lambda: att.flash_attention(ql, kl, vl, True))
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


# -- phase 3/4: the flash backward ------------------------------------------
# the decoder-LM training path (phase 12): bench.py _bench_transformer's
# GPT-2 small widths
LM_VOCAB, LM_D_MODEL, LM_LAYERS, LM_HEADS, LM_FF = 50304, 768, 12, 12, 4
LM_BATCH, LM_SEQ, LM_STEPS, LM_LR = 8, 2048, 5, 1e-4
LM_HEAD_DIM = LM_D_MODEL // LM_HEADS
# the JAX package's fp32 attention bound (tests/test_pallas_attention.py)
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
# the fp32 K3 backward's earlier design (its two passes on the fp32 FMA
# pipes) at the LM shape, measured by this script on an NVIDIA H100 80GB
# HBM3 at 700 W
F32_BWD_EARLIER_MS = 6.820


def lm_qkv(b, t, h, d, dev, gen, requires_grad=False):
    """q, k, v as the decoder block hands them to the kernels: (B, H, T, D)
    views into one (B, T, 3, H, D) projection."""
    qkv = torch.randn((b, t, 3, h, d), generator=gen).to(dev)
    qkv.requires_grad_(requires_grad)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def flash_bwd_cost(b, h, t_q, t_k, d, causal):
    """Bytes (q, k, v, out, dO read once, dq, dk, dv written once, lse
    read once: four (T_q, D) and four (T_k, D) tensors) and flops (five
    products of 2 D flops per visible query-key pair: S, dP, dV, dK,
    dQ)."""
    nbytes = 4 * b * h * (4 * t_q * d + 4 * t_k * d + t_q)
    pairs = t_q * (t_q + 1) // 2 if causal else t_q * t_k
    return nbytes, 10 * d * b * h * pairs


def phase_flash_bwd(att, build, dev):
    """The fp32 K3 backward through the path's autograd Function against
    the plain backward given the same forward output (BWD_RTOL /
    BWD_ATOL), and over all cases no further from an f64 run than twice
    the plain fp32 pipeline (forward and backward); unaligned views; the
    same bits from two calls and the time at the LM shape beside SDPA's
    fp32 backward. Both passes run their products on the tensor cores
    (TF32) at every head size."""
    flash_sass(build, "flash_attention_bwd", "_f32_kernel", "TF32", 8)
    gen = torch.Generator().manual_seed(SEED)
    cases = [(LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ, LM_HEAD_DIM, True, True),
             (2, 4, 256, 256, 16, True, False),
             (2, 4, 256, 256, 32, True, False),
             (2, 4, 256, 256, 128, True, False),
             (2, 4, 128, 192, 64, False, False),
             (2, 4, 100, 100, 64, True, False),
             (2, 4, 100, 100, 64, False, True)]
    err, share = 0.0, 0.0
    err_kernel, err_plain = [0.0] * 3, [0.0] * 3
    for b, h, t_q, t_k, d, causal, strided in cases:
        # through the path's entry: the autograd Function saves the
        # forward kernel's output and log-sum-exp for the backward kernel
        if strided:
            q, k, v = lm_qkv(b, t_q, h, d, dev, gen, requires_grad=True)
        else:
            q = torch.randn((b, h, t_q, d), generator=gen).to(dev)
            k, v = (torch.randn((b, h, t_k, d), generator=gen).to(dev)
                    for _ in range(2))
            for x in (q, k, v):
                x.requires_grad_(True)
        out = att.flash_attention(q, k, v, causal)
        d_out = torch.randn((b, h, t_q, d), generator=gen).to(dev)
        got = torch.autograd.grad(out, (q, k, v), d_out)
        torch.cuda.synchronize()
        q, k, v, out = (x.detach() for x in (q, k, v, out))
        want = att.flash_attention_bwd_plain(q, k, v, out, d_out, causal)
        qd, kd, vd = (x.double() for x in (q, k, v))
        exact = att.flash_attention_bwd_plain(
            qd, kd, vd, att.flash_attention_plain(qd, kd, vd, causal),
            d_out.double(), causal)
        plain = att.flash_attention_bwd_plain(
            q, k, v, att.flash_attention_plain(q, k, v, causal), d_out,
            causal)
        errs = []
        for i, (name, a, w, x, p) in enumerate(zip(("dq", "dk", "dv"), got,
                                                   want, exact, plain)):
            ok, e = within(a, w, BWD_RTOL, BWD_ATOL)
            share = max(share, bound_share(a, w, BWD_RTOL, BWD_ATOL))
            errs.append(e)
            err_kernel[i] = max(err_kernel[i], (a.double() - x).abs().max()
                                .item())
            err_plain[i] = max(err_plain[i], (p.double() - x).abs().max()
                               .item())
            check(ok, f"flash_attention_bwd B={b} H={h} Tq={t_q} Tk={t_k} "
                  f"D={d} causal={causal} strided={strided}: {name} off "
                  f"by {e:.3e} beyond rtol {BWD_RTOL} / atol {BWD_ATOL}")
        log(f"flash_attention_bwd B={b} H={h} Tq={t_q} Tk={t_k} D={d} "
            f"causal={causal} strided={strided}: max abs err dq/dk/dv "
            f"{errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (rtol "
            f"{BWD_RTOL}, atol {BWD_ATOL})")
        err = max(err, *errs)
        del q, k, v, out, d_out, got, want, exact, plain, qd, kd, vd
    # over all cases: a 1xTF32 product would sit ~1e-3 of the values off
    for name, e_k, e_p in zip(("dq", "dk", "dv"), err_kernel, err_plain):
        log(f"flash_attention_bwd {name} vs f64 over {len(cases)} cases: "
            f"kernel {e_k:.3e}, fp32 plain {e_p:.3e}")
        check(e_k <= 2 * e_p, f"flash_attention_bwd {name}: {e_k:.3e} off "
              f"the f64 run, more than twice the fp32 plain pipeline's "
              f"{e_p:.3e}")
    unaligned_bwd(att, dev, gen, torch.float32)
    torch.cuda.empty_cache()

    # timing at the training path's shape
    q, k, v = lm_qkv(LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM, dev, gen)
    out, lse = att._flash_fwd(q, k, v, True, LM_HEAD_DIM ** -0.5,
                              with_lse=True)
    d_out = torch.randn(out.shape, generator=gen).to(dev)
    # no atomics: every gradient is written once, in a fixed order
    first = att.flash_attention_bwd(q, k, v, out, d_out, lse, True)
    again = att.flash_attention_bwd(q, k, v, out, d_out, lse, True)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    check(same, "flash_attention_bwd: two calls at the LM shape differ in "
          "their bits")
    del first, again
    row = {"shape": {"B": LM_BATCH, "H": LM_HEADS, "T": LM_SEQ,
                     "D": LM_HEAD_DIM, "causal": True},
           "bound_share_max": share, "bitwise_run_to_run": same,
           "f64_err_kernel": err_kernel, "f64_err_plain": err_plain,
           "earlier_ms": F32_BWD_EARLIER_MS}
    row["ms"], row["launch_ms"] = measure(
        lambda: att.flash_attention_bwd(q, k, v, out, d_out, lse, True),
        iters=20)
    row["passes_ms"] = bwd_passes_ms(
        lambda: att.flash_attention_bwd(q, k, v, out, d_out, lse, True),
        ("bwd_dot_kernel", "dkdv_f32_kernel", "dq_f32_kernel"))
    row["plain_ms"], _ = measure(
        lambda: att.flash_attention_bwd_plain(q, k, v, out, d_out, True),
        iters=10)
    row["fwd_ms"], _ = measure(
        lambda: att.flash_attention(q, k, v, True), iters=20)
    # the forward as training runs it: with its log-sum-exp, saved
    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
    row["fwd_lse_ms"], _ = measure(
        lambda: att.flash_attention(qs, ks, vs, True), iters=20)
    # the yardstick: SDPA forward + backward less its forward, fp32
    ql, kl, vl = (x.detach().clone().requires_grad_(True)
                  for x in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        torch.autograd.grad(o, (ql, kl, vl), d_out)

    with torch.no_grad():
        sdpa_fwd, _ = measure(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=20)
    sdpa_both, _ = measure(sdpa_fwd_bwd, iters=20)
    row["library_ms"] = sdpa_both - sdpa_fwd
    row["library_fwd_ms"], row["library_fwd_bwd_ms"] = sdpa_fwd, sdpa_both
    check(row["ms"] < row["library_ms"],
          f"flash_attention_bwd: {row['ms']:.4f} ms, not below SDPA's fp32 "
          f"backward {row['library_ms']:.4f} ms")
    nbytes, flops = flash_bwd_cost(LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ,
                                   LM_HEAD_DIM, True)
    # as the forward's (flash_bounds): the card's fastest fp32-accurate
    # route is 3xTF32 on the tensor cores; the fp32 FMA pipes beside it
    mem_s, op_s = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS_PER_S
    row["bound_ms"] = max(mem_s, op_s) * 1e3
    row["bound_by"] = "bytes" if mem_s >= op_s else "operations"
    row["bytes"], row["flops"] = nbytes, flops
    row["fp32_bound_ms"] = max(mem_s, flops / FP32_FLOPS_PER_S) * 1e3
    # the kernels' own floor: 7 products a visible pair (S and dP twice,
    # dV, dK, dQ) against the function's 5, each 3 TF32 products
    row["kernel_floor_ms"] = max(mem_s, 7 / 5 * op_s) * 1e3
    log("flash_bwd_timing " + json.dumps(row))
    del q, k, v, out, lse, d_out, qs, ks, vs, ql, kl, vl
    torch.cuda.empty_cache()
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:144",
            "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "launch_ms": row["launch_ms"], "shape": row["shape"]}


def bwd_passes_ms(call, tags, n=5):
    """Device ms of each launch of the backward (the Dv dot, the dK/dV
    pass, the dQ pass), by kernel name: its mean torch.profiler record
    over ``n`` calls (each launches each once). Late in a run these
    records disagree with ``measure``'s events: a breakdown only."""
    rows = profiled(call, n)
    check(rows, f"torch.profiler recorded no pass of the backward in {n} "
          "calls")
    out = {}
    for tag in tags:
        hits = [v for key, v in rows.items() if tag in key]
        check(hits, f"torch.profiler recorded no {tag} in {n} calls")
        out[tag] = (sum(us for _, us in hits)
                    / sum(c for c, _ in hits) / 1e3)
    return out


# -- phase 5: the serving path ----------------------------------------------
def generate_burst(rng):
    """The serving phases' burst: MAX_BATCH prompts of 5-512 tokens, each
    asking for 32-64 new tokens (prompt lengths, new counts, prompts)."""
    plens = np.linspace(5, MAX_PROMPT, MAX_BATCH).astype(int)
    rng.shuffle(plens)
    new = rng.integers(32, 65, MAX_BATCH)
    prompts = [rng.integers(0, VOCAB, int(p)).tolist() for p in plens]
    return plens, new, prompts


def phase_serve(att, dev, burst):
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                                  reference_generate)

    n_req = MAX_BATCH
    plens, new, prompts = burst

    t0 = time.perf_counter()
    dec = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                            num_layers=LAYERS, num_heads=HEADS,
                            max_prompt_tokens=MAX_PROMPT, device=dev,
                            seed=SEED)
    log(f"decoder: {sum(t.numel() for t in dec.state_dict().values())} "
        f"parameters "
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
            "step_calls": calls, "pool_gb": pool_bytes / 1e9}
    log("main_path " + json.dumps(main))
    return {"flash_attention": flash_n, "paged_attention": paged_n}, main


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
                                                "nvjet", "xmma",
                                                "splitk")) else
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
def seeded_value(name, shape, rng):
    """A seeded fp32 value for the parameter ``name``: He-normal weights
    and biases, BatchNorm parameters and statistics away from the
    identity (gamma U(0.5, 1.5), beta U(-0.2, 0.2), mean U(-0.1, 0.1),
    variance U(0.5, 2))."""
    if name.endswith("gamma"):
        v = rng.uniform(0.5, 1.5, shape)
    elif name.endswith("beta"):
        v = rng.uniform(-0.2, 0.2, shape)
    elif name.endswith(("moving_mean", "running_mean")):
        v = rng.uniform(-0.1, 0.1, shape)
    elif name.endswith(("moving_var", "running_var")):
        v = rng.uniform(0.5, 2.0, shape)
    else:
        v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
    return v.astype(np.float32)


def resnet_params(sym, rng):
    """Seeded weights of the graph as numpy (arg, aux) dicts."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + R50_SHAPE[1:])
    arg = {name: seeded_value(name, shape, rng)
           for name, shape in zip(sym.list_arguments(), arg_shapes)
           if name != "data"}
    aux = {name: seeded_value(name, shape, rng)
           for name, shape in zip(sym.list_auxiliary_states(), aux_shapes)}
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

        ms, launch_ms = measure(all_kernel, iters=5)
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
    if "gemm" in low or "gemv" in low or "nvjet" in low:
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
    # the last training forward's graph is kept for a second backward
    # until the next forward: what it holds between steps
    held = torch.cuda.memory_allocated(dev)
    ex.forward(is_train=False, data=x, softmax_label=y)
    torch.cuda.synchronize()
    graph_held_gb = (held - torch.cuda.memory_allocated(dev)) / 1e9
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
            "peak_memory_gb": peak_gb,
            "recorded_graph_held_gb": graph_held_gb, "step_profile": prof,
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


# -- phase 10: gluon inference and one-shot serving --------------------------
# gluon ResNet-50 v1 at bench.py's inference batch, full width and depth
GLUON_SHAPE = (128, 3, 224, 224)
GLUON_PREFIX = "resnetv10_"
# logits over the same ops on the same card (gluon vs export -> executor)
GLUON_EXEC_TOL = 1e-5
# the card against the CPU gluon path (cuDNN vs the CPU's kernels), and
# the NHWC / s2d net against the NCHW one (channels-last cuDNN kernels
# and the stem's s2d rearrangement sum in other orders): the CPU tests'
# bound against the JAX package
GLUON_CPU_TOL = GLUON_LAYOUT_TOL = 1e-4
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_MAX_WAIT_MS = 2.0
SERVE_REQUESTS, SERVE_ROWS = 64, (1, 4)
SERVE_VARIANTS = ("fp32", "bf16", "int8")
# gateway fp32 replies vs the direct Predictor on the same rows: cuDNN
# may pick another algorithm per bucket, so bitwise is not assumed
SERVE_FP32_TOL = 1e-5
# the JAX package's own bounds (tests/test_serving.py): bf16 atol 0.15
# and rtol 0.1 relative to the fp32 logits' scale, int8 0.2 x scale
BF16_ATOL, BF16_RTOL, INT8_TOL = 0.15, 0.1, 0.2
QNET_BATCH = 32


def gluon_resnet(mx, weights, ctx, **kwargs):
    """resnet50_v1 on ``ctx`` with ``weights`` (None: draw them),
    shapes resolved without a forward, hybridized."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.block import infer_shapes
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet50_v1(prefix=GLUON_PREFIX, **kwargs)
    net.initialize(initializer.Zero(), ctx=ctx)
    infer_shapes(net, (1,) + GLUON_SHAPE[1:])
    if weights is None:
        rng = np.random.default_rng(SEED + 5)
        weights = {name: seeded_value(name, p.shape, rng)
                   for name, p in net.collect_params().items()}
    for name, p in net.collect_params().items():
        p.set_data(torch.from_numpy(weights[name]))
    net.hybridize()
    return net, weights


def timed_forwards(fn, iters=5):
    """Median seconds of ``iters`` calls of ``fn`` after a warm one, each
    ended by a sync (host clock); returns (median_s, last output)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def kernel_counts(att, i8, fo):
    return {"flash_attention": att.flash_attention.launches,
            "flash_attention_bwd": att.flash_attention_bwd.launches,
            "paged_attention": att.paged_attention.launches,
            "flash_attention_bf16": att.flash_attention.launches_bf16,
            "flash_attention_bwd_bf16":
                att.flash_attention_bwd.launches_bf16,
            "paged_attention_bf16": att.paged_attention.launches_bf16,
            "int8_epilogue": i8.int8_conv_epilogue.launches,
            "fused_sgd_mom": fo.fused_sgd_mom.launches,
            "fused_adam": fo.fused_adam.launches}


def calib_table(sym):
    """The calibrated ranges of a quantized graph in node order."""
    return [(n.op, float(n.attrs["min_calib_range"]),
             float(n.attrs["max_calib_range"]))
            for n in sym._topo() if "min_calib_range" in n.attrs]


def table_diff(a, b):
    """Largest relative difference of two calibration tables of one
    graph (None when their nodes differ)."""
    if [t[0] for t in a] != [t[0] for t in b]:
        return None
    return max((abs(x - y) / max(abs(y), 1e-30) for p, q in zip(a, b)
                for x, y in zip(p[1:], q[1:])), default=0.0)


def serve_burst(gw, xs, variant):
    """``len(xs)`` requests submitted back to back (the lane coalesces
    them under max_wait); returns the replies, per-request latencies in
    ms (submit to reply on the host clock), the burst's wall seconds
    and the model's batch / row / padding counts over it."""
    before = gw.stats()["r50"]
    t0 = time.perf_counter()
    reqs = [gw.submit("r50", x, variant=variant) for x in xs]
    replies = [r.result(timeout=600)[0] for r in reqs]
    wall = time.perf_counter() - t0
    after = gw.stats()["r50"]
    lat = sorted((r.exec_end_ns - r.submit_ns) / 1e6 for r in reqs)
    batches = after["batches"].get(variant, 0) \
        - before["batches"].get(variant, 0)
    rows = after["rows"] - before["rows"]
    return replies, {
        "variant": variant, "requests": len(xs), "images": rows,
        "wall_s": wall, "images_per_s": rows / wall,
        "p50_ms": lat[len(lat) // 2],
        "p90_ms": lat[int(0.9 * len(lat))],
        # a burst of 64 has no p99 of its own: its p99 is its largest
        "max_ms": lat[-1],
        "batches": batches, "mean_rows_per_batch": rows / batches,
        "padding_rows": after["padding_rows"] - before["padding_rows"]}


def phase_gluon(att, i8, fo, dev, rng, here):
    """Gluon ResNet-50 v1 inference on the card against the symbolic
    executor, the CPU and the NHWC / s2d net; then one-shot serving of
    its export (fp32, bf16, int8 native) and quantize_net. The path
    reaches none of the port's kernels: their counts must not move."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import Gateway

    counts0 = kernel_counts(att, i8, fo)
    ctx = mx.Context(dev)
    t0 = time.perf_counter()
    net, weights = gluon_resnet(mx, None, ctx)
    n_params = sum(int(np.prod(p.shape))
                   for p in net.collect_params().values())
    log(f"gluon resnet50_v1: {n_params} parameter values on {dev} "
        f"({time.perf_counter() - t0:.2f}s)")
    x = rng.standard_normal(GLUON_SHAPE, dtype=np.float32)
    data = mx.nd.array(x, ctx=ctx)
    fwd_s, out = timed_forwards(lambda: net(data))
    logits = out.asnumpy()
    check(logits.shape == (GLUON_SHAPE[0], 1000)
          and np.isfinite(logits).all(), f"gluon logits {logits.shape}")
    scale = float(np.abs(logits).max())
    prof = profile_step(lambda: net(data))

    # the same weights through export -> load_checkpoint -> simple_bind
    prefix = os.path.join(here, "build", "chip_smoke", "gluon_r50")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    net.export(prefix)
    sym, arg_p, aux_p = mx.model.load_checkpoint(prefix, 0, ctx=ctx)
    ex = sym.simple_bind(ctx, grad_req="null", data=GLUON_SHAPE)
    ex.copy_params_from(arg_p, aux_p)
    sym_logits = ex.forward(data=data)[0].asnumpy()
    exec_err = float(np.abs(sym_logits - logits).max())
    check(exec_err <= GLUON_EXEC_TOL * scale, f"gluon vs executor: "
          f"{exec_err} > {GLUON_EXEC_TOL} x {scale}")
    del ex
    # the first images on the CPU gluon path
    t0 = time.perf_counter()
    cpu_net, _ = gluon_resnet(mx, weights, mx.cpu())
    with mx.cpu():
        cpu_logits = cpu_net(mx.nd.array(x[:CPU_IMAGES])).asnumpy()
    cpu_err = float(np.abs(cpu_logits - logits[:CPU_IMAGES]).max())
    check(cpu_err <= GLUON_CPU_TOL * scale, f"gluon card vs CPU: "
          f"{cpu_err} > {GLUON_CPU_TOL} x {scale}")
    cpu_s = time.perf_counter() - t0
    del cpu_net
    # the same checkpoint channel-last with the space-to-depth stem
    nhwc, _ = gluon_resnet(mx, weights, ctx, layout="NHWC", stem="s2d")
    nhwc_s, nhwc_out = timed_forwards(lambda: nhwc(data))
    nhwc_err = float(np.abs(nhwc_out.asnumpy() - logits).max())
    check(nhwc_err <= GLUON_LAYOUT_TOL * scale, f"NHWC/s2d vs NCHW: "
          f"{nhwc_err} > {GLUON_LAYOUT_TOL} x {scale}")
    del nhwc, nhwc_out, out
    torch.cuda.empty_cache()
    log("gluon_r50 " + json.dumps({
        "batch": GLUON_SHAPE[0], "forward_ms": fwd_s * 1e3,
        "images_per_s": GLUON_SHAPE[0] / fwd_s,
        "nhwc_s2d_forward_ms": nhwc_s * 1e3,
        "max_err_vs_executor": exec_err, "max_err_vs_cpu": cpu_err,
        "max_err_nhwc_s2d": nhwc_err, "logit_scale": scale,
        "cpu_check_s": cpu_s, "forward_profile": prof}))

    # one-shot serving of the export
    calib = rng.standard_normal((CALIB_IMAGES,) + GLUON_SHAPE[1:],
                                dtype=np.float32)
    rows = rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1, SERVE_REQUESTS)
    xs = [rng.standard_normal((int(r),) + GLUON_SHAPE[1:],
                              dtype=np.float32) for r in rows]
    gw = Gateway(device=dev)
    try:
        t0 = time.perf_counter()
        gw.register_checkpoint(
            "r50", prefix, 0, {"data": GLUON_SHAPE[1:]},
            variants=SERVE_VARIANTS, calib_data=calib, calib_mode="naive",
            buckets=SERVE_BUCKETS, max_wait_ms=SERVE_MAX_WAIT_MS)
        reg_s = time.perf_counter() - t0
        st = gw.stats()["r50"]
        n_exec = len(SERVE_VARIANTS) * len(SERVE_BUCKETS)
        check(st["executables"] == n_exec,
              f"{st['executables']} executables warmed, want {n_exec}")
        check(st["int8_lowering"] == "native",
              f"int8 lowering {st['int8_lowering']} on the card")
        log(f"register_checkpoint: {st['executables']} executables, "
            f"warmup {st['warmup_seconds']:.2f}s ({reg_s:.2f}s in all)")
        bursts, replies = [], {}
        for variant in SERVE_VARIANTS:
            replies[variant], res = serve_burst(gw, xs, variant)
            bursts.append(res)
        burst_profile = profile_step(lambda: serve_burst(gw, xs, "fp32"))
        vs = gw._get_model("r50").replicas[0].variant_set
        gw_table = calib_table(vs.int8_symbol)
    finally:
        gw.close()

    for i, r in enumerate(replies["fp32"]):
        for v in SERVE_VARIANTS:
            got = replies[v][i]
            check(got.shape == (len(xs[i]), 1000)
                  and got.dtype == np.float32, f"{v} reply {i}: "
                  f"{got.shape} {got.dtype}")
            check(np.isfinite(got).all(), f"{v} reply {i} not finite")
    serve_scale = max(float(np.abs(r).max()) for r in replies["fp32"])
    pred = Predictor.from_checkpoint(prefix, 0, {"data": xs[0].shape},
                                     device=dev)
    fp32_err, bitwise, bf16_err, int8_err = 0.0, True, 0.0, 0.0
    bf16_same, int8_same = True, True
    for i, x_i in enumerate(xs):
        pred.reshape({"data": x_i.shape})
        want = pred.forward(data=x_i)[0]
        got = replies["fp32"][i]
        fp32_err = max(fp32_err, float(np.abs(got - want).max()))
        bitwise &= bool(np.array_equal(got, want))
        bf = replies["bf16"][i]
        check(np.all(np.abs(bf - got) <= BF16_ATOL * serve_scale
                     + BF16_RTOL * np.abs(got)),
              f"bf16 reply {i} outside atol {BF16_ATOL} x scale, rtol "
              f"{BF16_RTOL} of fp32")
        bf16_err = max(bf16_err, float(np.abs(bf - got).max()))
        int8_err = max(int8_err,
                       float(np.abs(replies["int8"][i] - got).max()))
        bf16_same &= bool(np.array_equal(bf, got))
        int8_same &= bool(np.array_equal(replies["int8"][i], got))
    check(fp32_err <= SERVE_FP32_TOL * serve_scale, f"gateway fp32 vs "
          f"Predictor: {fp32_err} > {SERVE_FP32_TOL} x {serve_scale}")
    check(int8_err <= INT8_TOL * serve_scale, f"int8 replies: {int8_err} "
          f"> {INT8_TOL} x {serve_scale}")
    # a variant that quietly ran in fp32 would pass the bounds above
    for v, same, err in (("bf16", bf16_same, bf16_err),
                         ("int8", int8_same, int8_err)):
        check(not same and err > fp32_err, f"{v} replies are the fp32 "
              f"ones (bitwise {same}, max err {err} <= fp32 vs Predictor "
              f"{fp32_err})")

    # quantize_net on the same weights
    t0 = time.perf_counter()
    qfwd, qparams = quantize_net(net, QNET_BATCH, calib, ctx=ctx)
    qnet_s = time.perf_counter() - t0
    q_s, qout = timed_forwards(lambda: qfwd(qparams, data._data[
        :QNET_BATCH]))
    qlogits = qout.cpu().numpy()
    check(qlogits.shape == (QNET_BATCH, 1000) and np.isfinite(qlogits).all(),
          f"quantize_net logits {qlogits.shape}")
    qscale = float(np.abs(logits[:QNET_BATCH]).max())
    qerr = float(np.abs(qlogits - logits[:QNET_BATCH]).max())
    check(qerr <= INT8_TOL * qscale, f"quantize_net: {qerr} > {INT8_TOL} "
          f"x {qscale}")
    qtable = calib_table(qfwd.symbol)
    counts1 = kernel_counts(att, i8, fo)
    check(counts1 == counts0, f"a kernel launched on the gluon path: "
          f"{counts0} -> {counts1}")
    log("oneshot_serving " + json.dumps({
        "buckets": SERVE_BUCKETS, "max_wait_ms": SERVE_MAX_WAIT_MS,
        "executables": n_exec, "register_s": reg_s,
        "warmup_s": st["warmup_seconds"], "bursts": bursts,
        "fp32_vs_predictor_max_err": fp32_err,
        "fp32_vs_predictor_bitwise": bitwise,
        "bf16_vs_fp32_max_err": bf16_err, "int8_vs_fp32_max_err": int8_err,
        "logit_scale": serve_scale, "fp32_burst_profile": burst_profile}))
    log("quantize_net " + json.dumps({
        "batch": QNET_BATCH, "quantize_net_s": qnet_s,
        "forward_ms": q_s * 1e3, "max_err_vs_fp32": qerr,
        "calib_ranges": len(qtable),
        "calib_table_equals_gateway": qtable == gw_table,
        "calib_max_rel_diff_vs_gateway": table_diff(qtable, gw_table),
        "kernel_launches_in_phase": {k: counts1[k] - counts0[k]
                                     for k in counts0}}))
    del net, data, qparams
    torch.cuda.empty_cache()


# -- phase 11: gluon training through the imperative tape --------------------
# bench.py build_train's loop through gluon's own API: hybridized
# resnet50_v1, SoftmaxCrossEntropyLoss, Trainer(SGD), on one seeded batch;
# phase 8's optimizer settings (lr 0.01 falls on one fixed batch)
GLUON_TRAIN_STEPS = 10
GLUON_SGD = {"learning_rate": SGD_HYPER["lr"],
             "momentum": SGD_HYPER["momentum"], "wd": SGD_HYPER["wd"]}
# the first step's loss against phase 8's executor on the same weights
# and batch (the same cuDNN kernels, two sums of the 128 row losses)
GLUON_EXEC_LOSS_RTOL = 1e-5


def gluon_train_loop(mx, net, trainer, loss_fn, x, y, steps):
    """``steps`` of record -> forward -> loss -> backward -> Trainer.step;
    returns (mean losses as device tensors, step seconds ended by a
    sync, host seconds of each Trainer.step call)."""
    losses, secs, host = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        t1 = time.perf_counter()
        trainer.step(x.shape[0])
        host.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss._data.detach().float().mean())
    return losses, secs, host


def gluon_train_run(mx, weights, ctx, x, y, dtype):
    """GLUON_TRAIN_STEPS at batch 128 in ``dtype`` (bf16: the net cast,
    fp32 masters in the optimizer); the measurements as a dict."""
    net, _ = gluon_resnet(mx, weights, ctx)
    multi = dtype == "bfloat16"
    if multi:
        net.cast("bfloat16")
        x = x.astype("bfloat16")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(GLUON_SGD, multi_precision=multi))
    dev = ctx.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs, host = gluon_train_loop(mx, net, trainer, loss_fn, x, y,
                                          GLUON_TRAIN_STEPS)
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"gluon {dtype}: loss {losses}")
    check(losses[-1] < losses[0], f"gluon {dtype}: loss did not fall: "
          f"{losses}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_s = float(np.median(secs[-5:]))
    prof = profile_step(lambda: gluon_train_loop(mx, net, trainer, loss_fn,
                                                 x, y, 1))
    # the optimizer alone: one Trainer.step after a backward
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    opt_prof = profile_step(lambda: trainer.step(x.shape[0]))
    params = net.collect_params().values()
    check(all(torch.isfinite(p.data()._data).all() for p in params),
          f"gluon {dtype}: non-finite weights after training")
    del net, trainer, loss
    torch.cuda.empty_cache()
    return {"dtype": dtype, "multi_precision": multi, "losses": losses,
            "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in secs],
            "images_per_s": x.shape[0] / step_s, "peak_memory_gb": peak_gb,
            "trainer_step_host_ms": float(np.median(host[-5:])) * 1e3,
            "trainer_step_host_ms_all": [t * 1e3 for t in host],
            "optimizer_device_ms": opt_prof["device_busy_ms"],
            "optimizer_launches": sum(opt_prof["by_group_launches"]
                                      .values()),
            "optimizer_profile": opt_prof, "step_profile": prof}


def gluon_train_parity(mx, weights, x_np, y_np):
    """One step at PARITY_BATCH on the card and on the CPU gluon path
    from the same weights: in f32 with the Trainer's update, in f64
    forward and backward only (the f64 run is the stem's reference, as
    in phase 8)."""
    conv_w = GLUON_PREFIX + "conv2d0_weight"
    fc_w = GLUON_PREFIX + "dense0_weight"
    got = {}
    for dt in ("float32", "float64"):
        for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            t0 = time.perf_counter()
            with ctx:
                net, _ = gluon_resnet(mx, weights, ctx)
                if dt == "float64":
                    net.cast("float64")
                params = net.collect_params()
                x = mx.nd.array(x_np[:PARITY_BATCH], dtype=dt)
                y = mx.nd.array(y_np[:PARITY_BATCH], dtype=dt)
                with mx.autograd.record():
                    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x),
                                                                   y)
                loss.backward()
                res = {"loss": float(loss.asnumpy().mean()),
                       "stem_grad": params[conv_w].grad().asnumpy(),
                       "fc_grad": params[fc_w].grad().asnumpy()}
                if dt == "float32":
                    mx.gluon.Trainer(params, "sgd", dict(GLUON_SGD)).step(
                        PARITY_BATCH)
                    res["fc_updated"] = params[fc_w].data().asnumpy()
                res["s"] = time.perf_counter() - t0
                got[where, dt] = res
            del net, params

    def rel(a, b, key):
        return float(np.abs(a[key].astype(np.float64) - b[key]).max()
                     / np.abs(b[key]).max())

    card32, cpu32 = got["card", "float32"], got["cpu", "float32"]
    card64, cpu64 = got["card", "float64"], got["cpu", "float64"]
    res = {"loss_card": card32["loss"], "loss_cpu": cpu32["loss"],
           "loss_f64": cpu64["loss"], "cpu_s": cpu32["s"] + cpu64["s"]}
    check(abs(card64["loss"] - cpu64["loss"]) <= PARITY_F64_TOL
          * abs(cpu64["loss"]), "gluon f64 loss card vs CPU")
    for key in ("stem_grad", "fc_grad"):
        res[key + "_f64_rel"] = r = rel(card64, cpu64, key)
        check(r <= PARITY_F64_TOL, f"gluon f64 {key}: card vs CPU {r}")
    check(abs(card32["loss"] - cpu32["loss"]) <= PARITY_LOSS_RTOL
          * abs(cpu32["loss"]), f"gluon batch-{PARITY_BATCH} loss card "
          f"{card32['loss']} vs CPU {cpu32['loss']}")
    for key in ("fc_grad", "fc_updated"):
        res[key + "_rel"] = r = rel(card32, cpu32, key)
        check(r <= PARITY_TENSOR_TOL, f"gluon f32 {key}: card vs CPU "
              f"differ by {r} of the largest (> {PARITY_TENSOR_TOL})")
    res["stem_grad_card_vs_f64"] = card_err = rel(card32, cpu64,
                                                  "stem_grad")
    res["stem_grad_cpu_vs_f64"] = cpu_err = rel(cpu32, cpu64, "stem_grad")
    check(card_err <= PARITY_STEM_RATIO * cpu_err,
          f"gluon f32 stem gradient: card {card_err} vs CPU {cpu_err} of "
          "the largest off the f64 run")
    log(f"gluon train parity: batch {PARITY_BATCH} step on the card "
        f"matches the CPU gluon path in f64 and f32 ({res['cpu_s']:.1f}s "
        "on the CPU)")
    return res


def sgd_class_vs_fma32(mx, dev):
    """The SGD class's update on the card (``torch.add`` with ``alpha``:
    one FMA in PyTorch's CUDA kernel) against ``fma32`` (f64, rounded
    once) on the same tensors, at ResNet-50's largest tensor: the
    contraction the CPU tests hold bitwise to the JAX package's jitted
    step. Returns the largest difference of the weight and the momentum
    in units of the last place."""
    from mxnet_tpu_torch.ops.fused_opt import f32, fma32

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    w, g, m = (torch.randn(K2_LARGEST, generator=gen, device=dev)
               for _ in range(3))
    lr, wd, mu, rs = (SGD_HYPER["lr"], SGD_HYPER["wd"],
                      SGD_HYPER["momentum"], 1.0 / TRAIN_BATCH)
    mom_ref = fma32(m, f32(mu), fma32(w, f32(wd), g * f32(rs)) * -f32(lr))
    w_ref = w + mom_ref
    opt = mx.optimizer.SGD(learning_rate=lr, momentum=mu, wd=wd,
                           rescale_grad=rs)
    weight, mom = mx.nd.NDArray(w.clone()), mx.nd.NDArray(m.clone())
    opt.update(0, weight, mx.nd.NDArray(g), mom)

    def ulps(got, ref):
        unit = torch.nextafter(ref.abs(), torch.full_like(ref, np.inf)) \
            - ref.abs()
        return float(((got - ref).abs() / unit).max())

    return max(ulps(weight._data, w_ref), ulps(mom._data, mom_ref))


def phase_gluon_train(att, i8, fo, dev, rng, here):
    """Gluon ResNet-50 v1 training at batch 128, fp32 and bf16 with fp32
    masters, through autograd.record / backward / Trainer.step; the
    first step's loss against the symbolic executor, one batch-4 step
    against the CPU. The Trainer's SGD class computes its own update:
    no kernel of the port may launch in the phase."""
    import mxnet_tpu_torch as mx

    counts0 = kernel_counts(att, i8, fo)
    ctx = mx.Context(dev)
    net, weights = gluon_resnet(mx, None, ctx)
    x_np = rng.standard_normal(GLUON_SHAPE, dtype=np.float32)
    y_np = rng.integers(0, 1000, GLUON_SHAPE[0]).astype(np.float32)
    x, y = mx.nd.array(x_np, ctx=ctx), mx.nd.array(y_np, ctx=ctx)

    # the first step's loss through export -> simple_bind (phase 8's path)
    prefix = os.path.join(here, "build", "chip_smoke", "gluon_r50_train")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    net.export(prefix)
    del net
    sym, arg_p, aux_p = mx.model.load_checkpoint(prefix, 0, ctx=ctx)
    ex = train_executor(mx, mx.sym.SoftmaxOutput(sym, name="softmax"),
                        GLUON_SHAPE[0], arg_p, aux_p, ctx)
    out = ex.forward(is_train=True, data=x, softmax_label=y)[0]
    exec_loss = float(cross_entropy(out._data, y._data))
    del ex, out, arg_p, aux_p
    torch.cuda.empty_cache()

    runs = [gluon_train_run(mx, weights, ctx, x, y, dt)
            for dt in ("float32", "bfloat16")]
    fp32, bf16 = runs
    loss_err = abs(fp32["losses"][0] - exec_loss)
    check(loss_err <= GLUON_EXEC_LOSS_RTOL * abs(exec_loss),
          f"gluon first-step loss {fp32['losses'][0]} vs executor "
          f"{exec_loss}")
    parity = gluon_train_parity(mx, weights, x_np, y_np)
    fma_ulps = sgd_class_vs_fma32(mx, dev)
    check(fma_ulps <= 1, f"SGD class on the card {fma_ulps} ulp off one "
          "rounding of each multiply-add")
    counts1 = kernel_counts(att, i8, fo)
    check(counts1 == counts0, f"a kernel launched on the gluon training "
          f"path: {counts0} -> {counts1}")
    log("gluon_train " + json.dumps({
        "batch": GLUON_SHAPE[0], "steps": GLUON_TRAIN_STEPS,
        "optimizer": dict(GLUON_SGD, name="sgd"),
        "executor_first_loss": exec_loss,
        "first_loss_rel_err_vs_executor": loss_err / abs(exec_loss),
        "runs": runs, "parity_batch4": parity,
        "sgd_class_max_ulps_vs_fma32": fma_ulps,
        "kernel_launches_in_phase": {k: counts1[k] - counts0[k]
                                     for k in counts0}}))
    del x, y
    torch.cuda.empty_cache()


# -- phase 12: decoder-LM training through gluon ----------------------------
LM_LOSS_RTOL = 1e-5
# one step's gradients, kernels vs the plain attention. Elementwise, at
# rtol 1e-4 and an atol of 1e-5 of each gradient's largest value, the two
# fp32 runs part on the MLP's first layer and the embedding: those
# gradients are sums over 16,384 tokens that cancel to ~1e-3 of their
# terms, so each run's own rounding (and a few dozen ReLU inputs per
# layer that round to the other side) moves them by ~1e-3 of their norm.
# So both fp32 runs are held to an f64 run of the plain step: the
# kernels' gradient no further from it (relative L2 norm, per parameter)
# than twice the fp32 plain version's, as phase 8 holds its
# ill-conditioned stem; the elementwise comparison is printed. A control
# shows the bound rejects a lower precision: the plain step with TF32
# products must exceed it.
LM_GRAD_RTOL, LM_GRAD_ATOL_OF_SCALE = 1e-4, 1e-5
LM_F64_RATIO = 2.0


def plain_attention_op(att):
    """The ``_contrib_flash_attention`` op on the plain attention and its
    plain gradient (the kernels' oracles, on the card), for the
    comparison step."""

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, scale):
            out = att.flash_attention_plain(q, k, v, causal, scale)
            ctx.save_for_backward(q, k, v, out)
            ctx.causal, ctx.scale = causal, scale
            return out

        @staticmethod
        def backward(ctx, d_out):
            q, k, v, out = ctx.saved_tensors
            grads = att.flash_attention_bwd_plain(q, k, v, out, d_out,
                                                  ctx.causal, ctx.scale)
            return (*grads, None, None)

    def op(q, k, v, causal=False, scale=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return PlainAttention.apply(q, k, v, bool(causal), float(scale))

    return op


def lm_step(mx, block, loss_fn, x, y, trainer=None):
    with mx.autograd.record():
        loss = loss_fn(block(x), y)
    loss.backward()
    if trainer is not None:
        trainer.step(x.shape[0])
    return loss


def lm_kernel_group(name):
    low = name.lower()
    if "flash_attention_kernel" in low \
            or "flash_attention_bf16_kernel" in low:
        return "flash_fwd"
    if any(k in low for k in ("dkdv_f32_kernel", "dq_f32_kernel",
                              "dkdv_bf16_kernel", "dq_bf16_kernel",
                              "bwd_dot_kernel")):
        return "flash_bwd"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "nvjet", "xmma")):
        return "matmul"
    return None


def _range_group(e, seq):
    """The ``mx_group:`` range an op ran in, or for a backward op the
    group of the forward op whose gradient it computes."""
    while e is not None:
        if e.name.startswith("mx_group:"):
            return e.name[len("mx_group:"):]
        if e.name.startswith("autograd::engine::evaluate_function") \
                and e.sequence_nr in seq:
            return seq[e.sequence_nr]
        e = e.cpu_parent
    return None


def lm_step_groups(registry, loss_fn, step):
    """One step's device ms by group: flash_fwd, flash_bwd and matmul by
    kernel name; layernorm and softmax_ce by the ops run inside the
    LayerNorm op and the loss block (forward ranges, and their backward
    ops through autograd's sequence numbers); the rest
    elementwise_other."""
    ln = registry.get("LayerNorm")
    ln_fn = ln.fn

    def ln_ranged(*a, **kw):
        with torch.profiler.record_function("mx_group:layernorm"):
            return ln_fn(*a, **kw)

    loss_hf = loss_fn.hybrid_forward

    def loss_ranged(*a, **kw):
        with torch.profiler.record_function("mx_group:softmax_ce"):
            return loss_hf(*a, **kw)

    ln.fn, loss_fn.hybrid_forward = ln_ranged, loss_ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        ln.fn = ln_fn
        del loss_fn.hybrid_forward
    groups = dict.fromkeys(("flash_fwd", "flash_bwd", "matmul", "layernorm",
                            "softmax_ce", "elementwise_other"), 0.0)
    events = prof.events()
    for e in events:      # the device's own events: kernels, copies
        if e.device_type == DeviceType.CUDA:
            g = lm_kernel_group(e.name) or "elementwise_other"
            groups[g] += e.time_range.elapsed_us() / 1e3
    seq = {}
    for e in events:
        if e.sequence_nr is not None and e.sequence_nr >= 0:
            g = _range_group(e, {})
            if g:
                seq[e.sequence_nr] = g
    for e in events:
        for kern in e.kernels:
            if lm_kernel_group(kern.name) is None:
                g = _range_group(e, seq)
                if g in ("layernorm", "softmax_ce"):
                    groups[g] += kern.duration / 1e3
                    groups["elementwise_other"] -= kern.duration / 1e3
    return groups


def phase_lm_train(att, i8, fo, dev, rng):
    """Decoder-LM training at GPT-2 small's widths through gluon: the
    plain-attention comparison step, then LM_STEPS counted steps (12
    flash forward and 12 flash backward launches each)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder

    ctx = mx.Context(dev)
    t0 = time.perf_counter()
    dec = GenerativeDecoder(vocab_size=LM_VOCAB, d_model=LM_D_MODEL,
                            num_layers=LM_LAYERS, num_heads=LM_HEADS,
                            ff_mult=LM_FF, max_prompt_tokens=LM_SEQ,
                            device=dev, seed=SEED)
    block = dec.block
    params = list(block.collect_params().values())
    n_params = sum(p.data()._data.numel() for p in params)
    log(f"lm decoder: {n_params} parameters on {dec.device} "
        f"({time.perf_counter() - t0:.2f}s)")
    tokens = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ + 1))
    x = mx.nd.array(tokens[:, :-1].astype(np.int32), ctx=ctx)
    y = mx.nd.array(tokens[:, 1:].astype(np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    # the comparison steps: the plain attention and its plain gradient,
    # from the initial weights, in fp32, in f64 and in fp32 with TF32
    # products (the control); no kernel launches
    counts0 = kernel_counts(att, i8, fo)
    op = registry.get("_contrib_flash_attention")
    op_fn, op.fn = op.fn, plain_attention_op(att)
    try:
        loss = lm_step(mx, block, loss_fn, x, y)
        plain_loss = float(loss._data.detach().mean())
        plain_grads = [p.grad()._data.clone() for p in params]
        del loss
        block.cast("float64")
        loss = lm_step(mx, block, loss_fn, x, y)
        f64_loss = float(loss._data.detach().mean())
        f64_grads = [p.grad()._data.clone() for p in params]
        del loss
        block.cast("float32")     # exact: the values were fp32
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            loss = lm_step(mx, block, loss_fn, x, y)
            tf32_grads = [p.grad()._data.clone() for p in params]
            del loss
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    finally:
        op.fn = op_fn
    torch.cuda.empty_cache()
    check(kernel_counts(att, i8, fo) == counts0,
          "a kernel launched in the plain-attention steps")

    trainer = mx.gluon.Trainer(block.collect_params(), "adam",
                               {"learning_rate": LM_LR})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    att.reset_launches()
    losses, secs, per_step = [], [], []
    for i in range(LM_STEPS):
        f0, b0 = att.flash_attention.launches, att.flash_attention_bwd.launches
        t0 = time.perf_counter()
        loss = lm_step(mx, block, loss_fn, x, y)
        if i == 0:
            grads = [p.grad()._data.clone() for p in params]
        trainer.step(LM_BATCH)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss._data.detach().mean()))
        per_step.append((att.flash_attention.launches - f0,
                         att.flash_attention_bwd.launches - b0))
    fwd_n, bwd_n = att.flash_attention.launches, \
        att.flash_attention_bwd.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del loss
    check(all(s == (LM_LAYERS, LM_LAYERS) for s in per_step),
          f"lm_train: flash forward / backward launches per step "
          f"{per_step}, want {LM_LAYERS} each")
    check(fwd_n == bwd_n == LM_LAYERS * LM_STEPS,
          f"lm_train: {fwd_n} / {bwd_n} launches in {LM_STEPS} steps")
    check(all(np.isfinite(losses)), f"lm_train: losses {losses}")
    check(losses[-1] < losses[0], f"lm_train: loss did not fall: {losses}")
    check(abs(losses[0] - np.log(LM_VOCAB)) < 1.0,
          f"lm_train: first loss {losses[0]} far from ln {LM_VOCAB}")

    loss_err = abs(losses[0] - plain_loss) / abs(plain_loss)
    check(loss_err <= LM_LOSS_RTOL, f"lm_train: first loss {losses[0]} vs "
          f"the plain attention's {plain_loss}")
    grad_rows = []
    for p, a, b, c, w in zip(params, grads, plain_grads, tf32_grads,
                             f64_grads):
        scale = b.abs().max().item()
        e = (a - b).abs()
        share = (e / (LM_GRAD_ATOL_OF_SCALE * scale
                      + LM_GRAD_RTOL * b.abs())).max().item()
        w_norm = torch.linalg.vector_norm(w).item()
        rel = [(torch.linalg.vector_norm(g.double() - w).item()
                / max(w_norm, 1e-300)) for g in (a, b, c)]
        grad_rows.append({
            "name": p.name, "share_of_elementwise_bound": share,
            "over_elementwise_bound": int((e > LM_GRAD_ATOL_OF_SCALE * scale
                                           + LM_GRAD_RTOL * b.abs()).sum()),
            "numel": b.numel(),
            "rel_l2_vs_plain": (torch.linalg.vector_norm(a - b).item()
                                / max(torch.linalg.vector_norm(b).item(),
                                      1e-30)),
            "kernel_rel_l2_vs_f64": rel[0], "plain_rel_l2_vs_f64": rel[1],
            "ratio": rel[0] / max(rel[1], 1e-300),
            "tf32_control_ratio": rel[2] / max(rel[1], 1e-300)})
    worst = max(grad_rows, key=lambda r: r["ratio"])
    control = max(grad_rows, key=lambda r: r["tf32_control_ratio"])
    check(control["tf32_control_ratio"] > LM_F64_RATIO,
          f"lm_train: the plain step with TF32 products is within "
          f"{LM_F64_RATIO}x of the fp32 plain step's distance from f64 "
          f"(worst {control['tf32_control_ratio']:.3f}): the gradient "
          f"check cannot tell a lower precision")
    check(worst["ratio"] <= LM_F64_RATIO,
          f"lm_train: gradient of {worst['name']} "
          f"{worst['kernel_rel_l2_vs_f64']:.3e} off the f64 plain step "
          f"(relative L2), more than "
          f"{LM_F64_RATIO}x the fp32 plain version's "
          f"{worst['plain_rel_l2_vs_f64']:.3e}")
    f64_loss_err = [abs(v - f64_loss) / abs(f64_loss)
                    for v in (losses[0], plain_loss)]
    del grads, plain_grads, tf32_grads, f64_grads

    step = lambda: lm_step(mx, block, loss_fn, x, y, trainer)  # noqa: E731
    prof = profile_step(step)
    groups = lm_step_groups(registry, loss_fn, step)
    check(all(torch.isfinite(p.data()._data).all() for p in params),
          "lm_train: non-finite weights after training")
    step_s = float(np.median(secs[-3:]))
    log("lm_train " + json.dumps({
        "config": {"vocab": LM_VOCAB, "d_model": LM_D_MODEL,
                   "layers": LM_LAYERS, "heads": LM_HEADS,
                   "ff_mult": LM_FF, "batch": LM_BATCH, "seq": LM_SEQ,
                   "parameters": n_params, "dtype": "float32",
                   "optimizer": {"name": "adam", "learning_rate": LM_LR}},
        "losses": losses, "ln_vocab": float(np.log(LM_VOCAB)),
        "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in secs],
        "tokens_per_s": LM_BATCH * LM_SEQ / step_s,
        "peak_memory_gb": peak_gb,
        "flash_launches_per_step": per_step,
        "plain_attention_first_loss": plain_loss,
        "first_loss_rel_err_vs_plain": loss_err,
        "f64_plain_first_loss": f64_loss,
        "first_loss_rel_err_vs_f64_kernel_plain": f64_loss_err,
        "grad_f64_ratio_max": worst["ratio"],
        "grad_f64_ratio_max_param": worst["name"],
        "tf32_control_ratio_max": control["tf32_control_ratio"],
        "tf32_control_ratio_max_param": control["name"],
        "tf32_control_ratio_min": min(r["tf32_control_ratio"]
                                      for r in grad_rows),
        "grad_rel_l2_vs_plain_max": max(r["rel_l2_vs_plain"]
                                        for r in grad_rows),
        "grad_elementwise_worst": sorted(
            grad_rows, key=lambda r: -r["share_of_elementwise_bound"])[:6],
        "grad_params_within_elementwise_bound": sum(
            r["share_of_elementwise_bound"] <= 1 for r in grad_rows),
        "grad_params": len(grad_rows),
        "device_idle_share": prof["device_idle_share"],
        "profiled_step_wall_ms": prof["wall_ms"],
        "device_busy_ms": prof["device_busy_ms"],
        "by_group_ms": groups, "top": prof["top"]}))
    del trainer, block, dec, params, x, y
    torch.cuda.empty_cache()
    return {"flash_attention_bwd": bwd_n}


# -- phase 13: bf16 through the decoder ---------------------------------------
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 on the tensor cores, dense
# tests/test_pallas_attention.py's bound for the bf16 Pallas kernel against
# an f32 dense run on the same bf16 inputs; and the f64 rule of phases 3
# and 12: a kernel no further (relative L2) from an f64 run on the same
# bf16 inputs than twice the plain bf16 version
BF16_RTOL, BF16_ATOL, BF16_F64_RATIO = 0.1, 0.05, 2.0
# the bf16 forward computes in f32 and rounds its output once (P to bf16
# for the second product adds under half of that): no further from the f64
# run than 1.5x the f64 output's own bf16 rounding, as the CPU emulation
# test of its arithmetic (tests/test_torch_attention.py) derives; rounding
# S to bf16 or truncating P would not pass
BF16_ROUND_RATIO = 1.5
# the bf16 backward against its plain version given the same forward
# output: both compute in f32 from the bf16 inputs (within the fp32
# backward's rtol 1e-4 / atol 1e-5) and round each gradient once, which
# may land one bf16 ulp (2^-7 of the value at most) apart
BF16_ULP = 2.0 ** -7
BF16_BWD_RTOL, BF16_BWD_ATOL = BWD_RTOL + BF16_ULP, BWD_ATOL
# the bf16 K3 kernels' earlier designs at the LM shape, measured by this
# script on an NVIDIA H100 80GB HBM3 at 700 W: the forward on 16-row
# mma.sync CTAs, the backward on the fp32 FMA pipes reading bf16
BF16_FWD_EARLIER_MS, BF16_BWD_EARLIER_MS = 0.5900, 6.476


def rel_l2(a, b):
    b = b.double()
    return (torch.linalg.vector_norm(a.double() - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


def bound_share(a, b, rtol, atol):
    """The largest |a - b| as a share of atol + rtol |b|: at most 1 where
    ``within`` holds."""
    a, b = a.double(), b.double()
    return ((a - b).abs() / (atol + rtol * b.abs())).max().item()


def within(a, b, rtol, atol):
    """Whether |a - b| <= atol + rtol |b| everywhere, and the largest
    |a - b|."""
    a, b = a.double(), b.double()
    e = (a - b).abs()
    return bool((e <= atol + rtol * b.abs()).all()), e.max().item()


def lm_qkv_bf16(b, t, h, d, dev, gen, requires_grad=False):
    """bf16 (B, H, T, D) views into one (B, T, 3, H, D) projection, as
    the cast decoder block hands them to the kernels."""
    qkv = torch.randn((b, t, 3, h, d), generator=gen).to(dev).bfloat16()
    qkv.requires_grad_(requires_grad)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def flash_bf16_cost(b, h, t, d):
    """Causal forward with its log-sum-exp: q, k, v read and out written
    once in bf16, lse f32; 4 D flops per visible query-key pair."""
    nbytes = b * h * (4 * t * d * 2 + t * 4)
    return nbytes, 4 * d * b * h * t * (t + 1) // 2


def phase_flash_bf16(att, build, dev):
    """bf16 K3 forward: every prefill bucket at every head size and the
    decoder-LM shape against the plain bf16 version and an f64 run on the
    same inputs; timed at the LM shape."""
    flash_sass(build, kernel="flash_attention_bf16_kernel", kind="HGMMA")
    gen = torch.Generator().manual_seed(SEED + 13)
    cases = [(1, D_MODEL // hd, t, hd, False) for hd in (16, 32, 64, 128)
             for t in (16, 32, 64, 128, 256, 512)]
    cases += [(1, HEADS, 100, HEAD_DIM, False),
              (LM_BATCH, LM_HEADS, LM_SEQ, LM_HEAD_DIM, True)]
    err, worst, worst_round = 0.0, 0.0, 0.0
    for b, h, t, d, lm in cases:
        if lm:
            q, k, v = lm_qkv_bf16(b, t, h, d, dev, gen)
        else:    # (1, H, T, D) views of the prefill's (1, T, 3 d) output
            qkv = torch.randn((1, t, 3 * h * d), generator=gen).to(
                dev).bfloat16()
            q, k, v = (y.view(1, t, h, d).transpose(1, 2)
                       for y in qkv.chunk(3, dim=-1))
        got = att.flash_attention(q, k, v, causal=True)
        want = att.flash_attention_plain(q, k, v, causal=True)
        exact = att.flash_attention_plain(q.double(), k.double(),
                                          v.double(), causal=True)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16, f"flash bf16 output {got.dtype}")
        ok_plain, e = within(got, want, BF16_RTOL, BF16_ATOL)
        ok_exact, _ = within(got, exact, BF16_RTOL, BF16_ATOL)
        r_kernel, r_plain = rel_l2(got, exact), rel_l2(want, exact)
        r_round = rel_l2(exact.to(torch.bfloat16), exact)
        log(f"flash_attention bf16 B={b} H={h} T={t} D={d}: max abs err "
            f"{e:.3e} vs plain bf16; vs f64 (relative L2) kernel "
            f"{r_kernel:.3e}, plain bf16 {r_plain:.3e}, f64 output rounded "
            f"to bf16 {r_round:.3e}")
        check(ok_plain and ok_exact, f"flash_attention bf16 B={b} T={t} "
              f"D={d}: outside rtol {BF16_RTOL} / atol {BF16_ATOL}")
        check(r_kernel <= BF16_F64_RATIO * r_plain,
              f"flash_attention bf16 B={b} T={t} D={d}: {r_kernel:.3e} off "
              f"f64, more than {BF16_F64_RATIO}x the plain bf16 version's "
              f"{r_plain:.3e}")
        check(r_kernel <= BF16_ROUND_RATIO * r_round,
              f"flash_attention bf16 B={b} T={t} D={d}: {r_kernel:.3e} off "
              f"f64, more than {BF16_ROUND_RATIO}x the f64 output's own "
              f"bf16 rounding {r_round:.3e}")
        err = max(err, e)
        worst = max(worst, r_kernel / r_plain)
        worst_round = max(worst_round, r_kernel / r_round)
        del q, k, v, got, want, exact
    log(f"flash_attention bf16: {len(cases)} cases, largest ratio of the "
        f"kernel's f64 distance to the plain bf16 version's {worst:.3f}, "
        f"to the f64 output's bf16 rounding {worst_round:.3f} (bound "
        f"{BF16_ROUND_RATIO})")

    q, k, v = lm_qkv_bf16(LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM, dev, gen)
    row = {"shape": {"B": LM_BATCH, "H": LM_HEADS, "T": LM_SEQ,
                     "D": LM_HEAD_DIM, "causal": True},
           "f64_ratio_max": worst, "rounding_ratio_max": worst_round,
           "earlier_ms": BF16_FWD_EARLIER_MS}
    row["ms"], row["launch_ms"] = measure(
        lambda: att.flash_attention(q, k, v, True), iters=20)
    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
    row["lse_ms"], _ = measure(
        lambda: att.flash_attention(qs, ks, vs, True), iters=20)
    row["plain_ms"], _ = measure(
        lambda: att.flash_attention_plain(q, k, v, True), iters=5)
    with torch.no_grad():
        row["library_ms"], _ = measure(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            iters=20)
    nbytes, flops = flash_bf16_cost(LM_BATCH, LM_HEADS, LM_SEQ, LM_HEAD_DIM)
    mem_s, op_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    row["bound_ms"] = max(mem_s, op_s) * 1e3
    row["bound_by"] = "bytes" if mem_s >= op_s else "operations"
    row["bytes"], row["flops"] = nbytes, flops
    log("flash_bf16_timing " + json.dumps(row))
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return {"name": "flash_attention_bf16", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:43",
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "launch_ms": row["launch_ms"],
            "shape": row["shape"]}


def unaligned_bwd(att, dev, gen, dtype):
    """The backward's cp.async loads need 16-byte aligned inputs: given
    views that are not (a narrow of a wider tensor, as autograd hands
    back the gradient of a concatenation), it gives the bits it gives on
    aligned copies, within its bound of the plain backward (fp32: phase
    3's rtol / atol; bf16: phase 13's)."""
    bf16 = dtype == torch.bfloat16
    rtol, atol = (BF16_BWD_RTOL, BF16_BWD_ATOL) if bf16 else (BWD_RTOL,
                                                              BWD_ATOL)
    tag = "bf16" if bf16 else "f32"
    b, h, t, d, pad = 2, 4, 100, 64, 3
    q, k, v = (torch.randn((b, h, t, d), generator=gen).to(dev, dtype)
               .requires_grad_(True) for _ in range(3))
    head = torch.randn((b, h, t, pad), generator=gen).to(dev, dtype)
    out = att.flash_attention(q, k, v, True)
    g_cat = torch.randn((b, h, t, pad + d), generator=gen).to(dev, dtype)
    got = torch.autograd.grad(torch.cat([head, out], -1), (q, k, v), g_cat)
    d_out = g_cat[..., pad:]
    check(not att._aligned(d_out), "the narrowed d_out is aligned")
    q, k, v, out = (x.detach() for x in (q, k, v, out))
    want = att.flash_attention_bwd_plain(q, k, v, out, d_out, True)
    _, lse = att._flash_fwd(q, k, v, True, d ** -0.5, with_lse=True)
    aligned = att.flash_attention_bwd(q, k, v, out, d_out.contiguous(), lse,
                                      True)
    views = []
    for x in (q, k, v):
        wide = torch.zeros((b, h, t, pad + d), dtype=x.dtype, device=dev)
        wide[..., pad:] = x
        views.append(wide[..., pad:])
    direct = att.flash_attention_bwd(*views, out, d_out, lse, True)
    torch.cuda.synchronize()
    for name, a, dr, al, w in zip(("dq", "dk", "dv"), got, direct, aligned,
                                  want):
        ok, e = within(a, w, rtol, atol)
        check(ok, f"flash_attention_bwd {tag} unaligned d_out: {name} off "
              f"the plain backward by {e:.3e}")
        check(torch.equal(a, al) and torch.equal(dr, al),
              f"flash_attention_bwd {tag}: {name} from unaligned views "
              f"differs from the aligned call's bits")
    log(f"flash_attention_bwd {tag} B={b} H={h} T={t} D={d} causal: "
        f"unaligned views (d_out through autograd; q, k, v and d_out "
        f"called directly) give the aligned call's bits")


def phase_flash_bwd_bf16(att, build, dev):
    """bf16 K3 backward through the path's autograd Function, against
    the plain backward given the same forward output, and both pipelines
    (kernels; plain bf16 forward and backward) against an f64 run; the
    same bits from two calls at the LM shape; timed there beside SDPA's
    bf16 backward. Both passes run their products on the tensor cores
    at every head size."""
    flash_sass(build, "flash_attention_bwd", "_bf16_kernel", "BF16", 8)
    gen = torch.Generator().manual_seed(SEED + 14)
    # the forward's grid (every prefill bucket at every head size, as
    # views of one projection), the LM shape, and rectangular / ragged
    cases = [(1, D_MODEL // hd, t, t, hd, True, "prefill")
             for hd in (16, 32, 64, 128) for t in (16, 32, 64, 128, 256, 512)]
    cases += [(LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ, LM_HEAD_DIM, True, "lm"),
              (2, 4, 128, 192, 64, False, "dense"),
              (2, 4, 100, 100, 64, True, "dense")]
    err, worst, share = 0.0, 0.0, 0.0
    for b, h, t_q, t_k, d, causal, layout in cases:
        if layout == "lm":
            q, k, v = lm_qkv_bf16(b, t_q, h, d, dev, gen, requires_grad=True)
        elif layout == "prefill":
            qkv = torch.randn((1, t_q, 3 * h * d), generator=gen).to(
                dev).bfloat16().requires_grad_(True)
            q, k, v = (y.view(1, t_q, h, d).transpose(1, 2)
                       for y in qkv.chunk(3, dim=-1))
        else:
            q = torch.randn((b, h, t_q, d), generator=gen).to(dev).bfloat16()
            k, v = (torch.randn((b, h, t_k, d), generator=gen).to(
                dev).bfloat16() for _ in range(2))
            for x in (q, k, v):
                x.requires_grad_(True)
        out = att.flash_attention(q, k, v, causal)
        d_out = torch.randn((b, h, t_q, d), generator=gen).to(dev).bfloat16()
        got = torch.autograd.grad(out, (q, k, v), d_out)
        torch.cuda.synchronize()
        q, k, v, out = (x.detach() for x in (q, k, v, out))
        want = att.flash_attention_bwd_plain(q, k, v, out, d_out, causal)
        qd, kd, vd = (x.double() for x in (q, k, v))
        exact = att.flash_attention_bwd_plain(
            qd, kd, vd, att.flash_attention_plain(qd, kd, vd, causal),
            d_out.double(), causal)
        plain = att.flash_attention_bwd_plain(
            q, k, v, att.flash_attention_plain(q, k, v, causal), d_out,
            causal)
        errs, ratios = [], []
        for name, a, w, x, p in zip(("dq", "dk", "dv"), got, want, exact,
                                    plain):
            check(a.dtype == torch.bfloat16, f"bf16 {name} is {a.dtype}")
            ok, e = within(a, w, BF16_BWD_RTOL, BF16_BWD_ATOL)
            share = max(share, bound_share(a, w, BF16_BWD_RTOL,
                                           BF16_BWD_ATOL))
            ok_x, _ = within(a, x, BF16_RTOL, BF16_ATOL)
            r_kernel, r_plain = rel_l2(a, x), rel_l2(p, x)
            errs.append(e)
            ratios.append(r_kernel / r_plain)
            check(ok and ok_x, f"flash_attention_bwd bf16 B={b} Tq={t_q} "
                  f"Tk={t_k} D={d}: {name} off by {e:.3e}")
            check(r_kernel <= BF16_F64_RATIO * r_plain,
                  f"flash_attention_bwd bf16 B={b} Tq={t_q} D={d}: {name} "
                  f"{r_kernel:.3e} off f64, more than {BF16_F64_RATIO}x the "
                  f"plain bf16 pipeline's {r_plain:.3e}")
        log(f"flash_attention_bwd bf16 B={b} H={h} Tq={t_q} Tk={t_k} D={d} "
            f"causal={causal} {layout}: max abs err dq/dk/dv vs "
            f"plain {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e}; f64 "
            f"distance ratio to plain bf16 "
            f"{' / '.join(f'{r:.3f}' for r in ratios)}")
        err = max(err, *errs)
        worst = max(worst, *ratios)
        del q, k, v, out, d_out, got, want, exact, plain
    unaligned_bwd(att, dev, gen, torch.bfloat16)
    torch.cuda.empty_cache()

    q, k, v = lm_qkv_bf16(LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM, dev, gen)
    out, lse = att._flash_fwd(q, k, v, True, LM_HEAD_DIM ** -0.5,
                              with_lse=True)
    d_out = torch.randn(out.shape, generator=gen).to(dev).bfloat16()
    # no atomics: every gradient is written once, in a fixed order
    first = att.flash_attention_bwd(q, k, v, out, d_out, lse, True)
    again = att.flash_attention_bwd(q, k, v, out, d_out, lse, True)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    check(same, "flash_attention_bwd bf16: two calls at the LM shape "
          "differ in their bits")
    del first, again
    row = {"shape": {"B": LM_BATCH, "H": LM_HEADS, "T": LM_SEQ,
                     "D": LM_HEAD_DIM, "causal": True},
           "f64_ratio_max": worst, "bound_share_max": share,
           "bitwise_run_to_run": same, "earlier_ms": BF16_BWD_EARLIER_MS}
    row["ms"], row["launch_ms"] = measure(
        lambda: att.flash_attention_bwd(q, k, v, out, d_out, lse, True),
        iters=20)
    row["passes_ms"] = bwd_passes_ms(
        lambda: att.flash_attention_bwd(q, k, v, out, d_out, lse, True),
        ("bwd_dot_kernel", "dkdv_bf16_kernel", "dq_bf16_kernel"))
    row["plain_ms"], _ = measure(
        lambda: att.flash_attention_bwd_plain(q, k, v, out, d_out, True),
        iters=5)
    ql, kl, vl = (x.detach().clone().requires_grad_(True)
                  for x in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        torch.autograd.grad(o, (ql, kl, vl), d_out)

    with torch.no_grad():
        sdpa_fwd, _ = measure(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=20)
    sdpa_both, _ = measure(sdpa_fwd_bwd, iters=20)
    row["library_ms"] = sdpa_both - sdpa_fwd
    row["library_fwd_ms"], row["library_fwd_bwd_ms"] = sdpa_fwd, sdpa_both
    nbytes, flops = flash_bwd_cost(LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ,
                                   LM_HEAD_DIM, True)
    # bf16 tensors move half the bytes of the f32 count (lse stays f32)
    nbytes = (nbytes - 4 * LM_BATCH * LM_HEADS * LM_SEQ) // 2 \
        + 4 * LM_BATCH * LM_HEADS * LM_SEQ
    mem_s, op_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    row["bound_ms"] = max(mem_s, op_s) * 1e3
    row["bound_by"] = "bytes" if mem_s >= op_s else "operations"
    row["bytes"], row["flops"] = nbytes, flops
    # the kernel's own floor on the tensor cores: 10 products of 2 D flops
    # a visible pair (S and dP twice, dV, dK and dQ from two bf16 pieces
    # of P and dS each) against the function's 5
    row["kernel_floor_ms"] = max(mem_s, 2 * op_s) * 1e3
    log("flash_bwd_bf16_timing " + json.dumps(row))
    del q, k, v, out, lse, d_out, ql, kl, vl
    torch.cuda.empty_cache()
    return {"name": "flash_attention_bwd_bf16", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:144",
            "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "launch_ms": row["launch_ms"], "shape": row["shape"]}


def phase_lm_train_bf16(att, i8, fo, dev, rng):
    """Decoder-LM training in bf16 at GPT-2 small's widths: the seeded
    block cast to bf16, Adam with f32 masters (multi_precision); the
    first step against the same step with the plain attention and an
    f32 run of it; LM_STEPS counted steps, each 12 bf16 flash forward and
    12 bf16 flash backward launches and no f32 one."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder

    ctx = mx.Context(dev)
    dec = GenerativeDecoder(vocab_size=LM_VOCAB, d_model=LM_D_MODEL,
                            num_layers=LM_LAYERS, num_heads=LM_HEADS,
                            ff_mult=LM_FF, max_prompt_tokens=LM_SEQ,
                            device=dev, seed=SEED)
    block = dec.block
    block.cast("bfloat16")
    params = list(block.collect_params().values())
    check(all(p.data()._data.dtype == torch.bfloat16 for p in params),
          "lm bf16: a parameter is not bf16 after cast")
    tokens = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ + 1))
    x = mx.nd.array(tokens[:, :-1].astype(np.int32), ctx=ctx)
    y = mx.nd.array(tokens[:, 1:].astype(np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    # the comparison steps: the plain attention in bf16, then the same
    # step in f32 on the bf16-rounded weights (exact both ways); no kernel
    counts0 = kernel_counts(att, i8, fo)
    op = registry.get("_contrib_flash_attention")
    op_fn, op.fn = op.fn, plain_attention_op(att)
    try:
        loss = lm_step(mx, block, loss_fn, x, y)
        check(loss._data.dtype == torch.bfloat16, "lm bf16: loss not bf16")
        plain_loss = loss._data.detach().float()
        plain_grads = [p.grad()._data.clone() for p in params]
        del loss
        block.cast("float32")
        loss = lm_step(mx, block, loss_fn, x, y)
        f32_loss = loss._data.detach().float()
        f32_grads = [p.grad()._data.clone() for p in params]
        del loss
        block.cast("bfloat16")
    finally:
        op.fn = op_fn
    torch.cuda.empty_cache()
    check(kernel_counts(att, i8, fo) == counts0,
          "a kernel launched in the plain-attention steps")

    trainer = mx.gluon.Trainer(block.collect_params(), "adam",
                               {"learning_rate": LM_LR,
                                "multi_precision": True})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    att.reset_launches()
    losses, secs, host, per_step = [], [], [], []
    for i in range(LM_STEPS):
        before = (att.flash_attention.launches_bf16,
                  att.flash_attention_bwd.launches_bf16)
        t0 = time.perf_counter()
        loss = lm_step(mx, block, loss_fn, x, y)
        if i == 0:
            first_loss = loss._data.detach().float()
            grads = [p.grad()._data.clone() for p in params]
        t1 = time.perf_counter()
        trainer.step(LM_BATCH)
        host.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss._data.detach().float().mean()))
        per_step.append((att.flash_attention.launches_bf16 - before[0],
                         att.flash_attention_bwd.launches_bf16 - before[1]))
    fwd_n = att.flash_attention.launches_bf16
    bwd_n = att.flash_attention_bwd.launches_bf16
    f32_n = (att.flash_attention.launches, att.flash_attention_bwd.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del loss
    check(all(s == (LM_LAYERS, LM_LAYERS) for s in per_step),
          f"lm bf16: bf16 flash forward / backward launches per step "
          f"{per_step}, want {LM_LAYERS} each")
    check(f32_n == (0, 0), f"lm bf16: f32 flash launches {f32_n}")
    check(all(np.isfinite(losses)), f"lm bf16: losses {losses}")
    check(losses[-1] < losses[0], f"lm bf16: loss did not fall: {losses}")
    check(abs(losses[0] - np.log(LM_VOCAB)) < 1.0,
          f"lm bf16: first loss {losses[0]} far from ln {LM_VOCAB}")
    check(all(torch.isfinite(p.data()._data).all() for p in params),
          "lm bf16: non-finite weights after training")

    # the first loss: each row's bf16 loss no further from the f32 run's
    # than twice the plain attention's, or than half a bf16 ulp of it
    half_ulp = torch.exp2(torch.floor(torch.log2(f32_loss.abs())) - 8)
    loss_bound = BF16_F64_RATIO * torch.maximum(
        (plain_loss - f32_loss).abs(), half_ulp)
    loss_ok = bool(((first_loss - f32_loss).abs() <= loss_bound).all())
    check(loss_ok, f"lm bf16: first loss {first_loss.tolist()} vs f32 "
          f"{f32_loss.tolist()}, plain bf16 {plain_loss.tolist()}")
    grad_rows = []
    for p, a, b, w in zip(params, grads, plain_grads, f32_grads):
        check(a.dtype == torch.bfloat16, f"lm bf16: {p.name} grad {a.dtype}")
        ok, e = within(a, b, BF16_RTOL, BF16_ATOL * b.abs().max().item())
        r_kernel, r_plain = rel_l2(a, w), rel_l2(b, w)
        grad_rows.append({"name": p.name, "elementwise_ok": ok,
                          "max_abs_err_vs_plain": e,
                          "kernel_rel_l2_vs_f32": r_kernel,
                          "plain_rel_l2_vs_f32": r_plain,
                          "ratio": r_kernel / max(r_plain, 1e-300)})
    worst = max(grad_rows, key=lambda r: r["ratio"])
    check(worst["ratio"] <= BF16_F64_RATIO,
          f"lm bf16: gradient of {worst['name']} "
          f"{worst['kernel_rel_l2_vs_f32']:.3e} off the f32 step, more than "
          f"{BF16_F64_RATIO}x the plain bf16 step's "
          f"{worst['plain_rel_l2_vs_f32']:.3e}")
    del grads, plain_grads, f32_grads

    step = lambda: lm_step(mx, block, loss_fn, x, y, trainer)  # noqa: E731
    prof = profile_step(step)
    groups = lm_step_groups(registry, loss_fn, step)
    with mx.autograd.record():
        loss = loss_fn(block(x), y)
    loss.backward()
    opt_prof = profile_step(lambda: trainer.step(LM_BATCH))
    del loss
    step_s = float(np.median(secs[-3:]))
    log("lm_train_bf16 " + json.dumps({
        "config": {"vocab": LM_VOCAB, "d_model": LM_D_MODEL,
                   "layers": LM_LAYERS, "heads": LM_HEADS,
                   "ff_mult": LM_FF, "batch": LM_BATCH, "seq": LM_SEQ,
                   "dtype": "bfloat16", "masters": "float32",
                   "optimizer": {"name": "adam", "learning_rate": LM_LR,
                                 "multi_precision": True}},
        "losses": losses, "ln_vocab": float(np.log(LM_VOCAB)),
        "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in secs],
        "tokens_per_s": LM_BATCH * LM_SEQ / step_s,
        "peak_memory_gb": peak_gb,
        "trainer_step_host_ms": float(np.median(host[-3:])) * 1e3,
        "trainer_step_host_ms_all": [t * 1e3 for t in host],
        "optimizer_device_ms": opt_prof["device_busy_ms"],
        "optimizer_launches": sum(opt_prof["by_group_launches"].values()),
        "bf16_flash_launches_per_step": per_step,
        "first_loss": first_loss.tolist(),
        "plain_attention_first_loss": plain_loss.tolist(),
        "f32_first_loss": f32_loss.tolist(),
        "grad_f32_ratio_max": worst["ratio"],
        "grad_f32_ratio_max_param": worst["name"],
        "grad_params_within_elementwise_bound": sum(
            r["elementwise_ok"] for r in grad_rows),
        "grad_params": len(grad_rows),
        "grad_elementwise_worst": sorted(
            grad_rows, key=lambda r: -r["max_abs_err_vs_plain"])[:4],
        "device_idle_share": prof["device_idle_share"],
        "profiled_step_wall_ms": prof["wall_ms"],
        "device_busy_ms": prof["device_busy_ms"],
        "by_group_ms": groups, "top": prof["top"]}))
    del trainer, block, dec, params, x, y
    torch.cuda.empty_cache()
    return {"flash_attention_bf16": fwd_n, "flash_attention_bwd_bf16": bwd_n}


def phase_serve_bf16(att, dev, burst, f32_main):
    """bf16-KV serving: GenerativeDecoder(dtype="bfloat16") at the
    quickstart widths (Dense and Embedding weights bf16, LayerNorm f32), a
    bf16 pool, phase 5's burst; 8 bf16-cache K4 launches a decode step.
    Gate: the tokens equal those of the same lane with the plain paged
    attention on the same bf16 pool. Printed beside phase 5's f32 numbers
    of this run (``f32_main``)."""
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                                  reference_generate)
    from mxnet_tpu_torch.serving.generate import model as gen_model

    plens, new, prompts = burst
    n_req = len(prompts)
    dec = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                            num_layers=LAYERS, num_heads=HEADS,
                            max_prompt_tokens=MAX_PROMPT, device=dev,
                            seed=SEED, dtype="bfloat16")
    att.reset_launches()
    gw = Gateway(device=dev)
    try:
        gen = gw.register_generator(
            "lm16", dec, block_tokens=BLOCK_TOKENS, max_blocks=MAX_BLOCKS,
            max_new_tokens=MAX_NEW, max_decode_batch=MAX_BATCH)
        pool = gen.lane.pool
        pool_bytes = pool.bytes_total
        check(pool.k.dtype == torch.bfloat16 and pool_bytes == 2 * LAYERS
              * MAX_BLOCKS * BLOCK_TOKENS * HEADS * HEAD_DIM * 2,
              f"bf16 pool {pool.k.dtype} {pool_bytes} bytes")
        t_start = time.perf_counter()
        reqs = [gw.generate("lm16", p, max_new_tokens=int(n), stream=True)
                for p, n in zip(prompts, new)]
        results = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t_start
        stats = gw.stats()["lm16"]
        counts = {"paged_bf16": att.paged_attention.launches_bf16,
                  "paged_f32": att.paged_attention.launches,
                  "flash_f32": att.flash_attention.launches,
                  "flash_bf16": att.flash_attention.launches_bf16}
        # the same lane and pool with the plain paged attention
        paged = gen_model.paged_attention
        gen_model.paged_attention = att.paged_attention_plain
        try:
            plain = [gw.generate("lm16", p, max_new_tokens=int(n))
                     for p, n in zip(prompts, new)]
        finally:
            gen_model.paged_attention = paged
    finally:
        gw.close()
    lane = stats["lanes"][0]
    calls = lane["step_calls"]
    for i, (res, n) in enumerate(zip(results, new)):
        check(len(res) == n, f"bf16 request {i}: {len(res)} tokens, want {n}")
    check(counts["paged_bf16"] == calls["decode"] * LAYERS
          and counts["paged_bf16"] > 0,
          f"bf16 paged launches {counts} != {calls['decode']} x {LAYERS}")
    check(counts["paged_f32"] == 0 and counts["flash_bf16"] == 0
          and counts["flash_f32"] == calls["prefill"] * LAYERS,
          f"bf16 serving launches {counts}, calls {calls}")
    same = sum(a == b for a, b in zip(results, plain))
    check(same == n_req, f"bf16 serving: {n_req - same} of {n_req} requests "
          f"differ from the plain paged attention on the same pool")
    t0 = time.perf_counter()
    oracle = sum(reference_generate(dec, p, int(n)) == r
                 for p, n, r in zip(prompts, new, results))
    oracle_s = time.perf_counter() - t0
    gen_tokens = int(sum(new))
    main = {"requests": n_req, "generated_tokens": gen_tokens,
            "wall_s": wall, "tokens_per_s": gen_tokens / wall,
            "mean_prefill_ms": lane["prefill_ns"] / lane["prefills"] / 1e6,
            "mean_decode_step_ms": lane["decode_ns"]
            / lane["decode_steps"] / 1e6,
            "decode_steps": lane["decode_steps"],
            "mean_decode_rows": lane["decode_rows"] / lane["decode_steps"],
            "pool_gb": pool_bytes / 1e9,
            "f32_pool_gb": f32_main["pool_gb"],
            "f32_tokens_per_s": f32_main["tokens_per_s"],
            "f32_mean_decode_step_ms": f32_main["mean_decode_step_ms"],
            "launches": counts, "step_calls": calls,
            "equal_to_plain_paged_lane": same,
            "equal_to_reference_generate": int(oracle),
            "reference_generate_s": oracle_s}
    log("serve_bf16 " + json.dumps(main))
    del dec
    torch.cuda.empty_cache()
    return {"paged_attention_bf16": counts["paged_bf16"]}


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
               phase_flash_bwd(att, _build, dev),
               phase_paged(att, dev, rng),
               phase_int8(i8, dev),
               *phase_fused_opt(fo, dev)]

    burst = generate_burst(rng)
    launches, serve_main = phase_serve(att, dev, burst)
    launches.update(phase_resnet(i8, dev, rng, here))
    launches["fused_sgd_mom"] = phase_train(fo, dev, rng, here)
    launches["fused_adam"] = phase_train_adam(fo, dev, rng, here)
    phase_gluon(att, i8, fo, dev, rng, here)
    phase_gluon_train(att, i8, fo, dev, rng, here)
    launches.update(phase_lm_train(att, i8, fo, dev, rng))
    kernels += [phase_flash_bf16(att, _build, dev),
                phase_flash_bwd_bf16(att, _build, dev),
                phase_paged(att, dev, rng, torch.bfloat16,
                            kernels[2]["shape"]["decode_lens"])]
    launches.update(phase_lm_train_bf16(att, i8, fo, dev, rng))
    launches.update(phase_serve_bf16(att, dev, burst, serve_main))
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
    if len(sys.argv) == 3 and sys.argv[1] == "--time-paged":
        sys.exit(time_paged_tree(sys.argv[2]))
    sys.exit(main())
