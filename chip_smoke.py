#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

To time another commit's paged-attention kernels (K4) the way phase 3
times this checkout's, in the same call (parent against change), unpack
it into a directory and run::

    python3 chip_smoke.py --time-paged DIR

and ``--time-flash DIR`` times K3 forward and backward, f32 and bf16, at
the decoder-LM shape the way phases 3 and 13 time this checkout's.
``--cost-ledger`` builds the kernels and runs phase 25 alone.

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
   and the same bits from two calls at the LM shape. Besides, K3 forward
   and backward at head sizes 8, 80 and 200 (zero-padded by the wrappers
   to the next built size) and 256, and causal with T_q 100 / T_k 256
   and 64 / 1024 (the diagonal shifted by T_k - T_q), and K4 at head
   sizes 8, 16, 80, 256 and 200 over a pool laid out as ``BlockPool``
   lays it out (D 80 at 128, 200 at 256), each under the same bounds
   (SASS checks count the D 256 instances too);
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
14. head size 256 at Gemma-7B's widths: K3 forward and backward, f32
   and bf16 (B 4, H 16, T 2048, causal) held to their plain versions
   there and timed beside them, SDPA and their bounds, and K4 over both
   cache types at H 16, B 32 on phase 3's decode lengths (each kernel's
   row in its ``kernels`` entry under ``d256``); then serving at other
   head sizes: ``Gateway.generate`` on a default
   ``GenerativeDecoder`` (d_model 64, 4 heads: D 16), on the JAX serving
   tests' decoder (d_model 32, 4 heads: D 8), on one of D 80 (its pool
   laid out at 128), of D 256 and of D 200 (laid out at 256), each with
   an f32 and a bf16 pool: f32 tokens
   equal ``reference_generate``, bf16 tokens equal the same lane's with
   the plain paged attention; one K3 launch a layer a prefill, one K4
   launch of the pool's type a layer a decode step; the pools' GB;
15. the Module API: ``train_mnist.py``'s LeNet through ``Module.fit``
   on the card over data/'s idx files (written from the seed when
   missing) through ``MNISTIter``: batch 64, SGD lr 0.1,
   ``Xavier(magnitude=2)``, ``Speedometer``, one epoch; validation
   accuracy from ``score`` at least 0.99; step ms (median), images/s
   and the idle share of a traced window of 10 steps. The card's first
   3 ``forward_backward`` + ``update`` steps against the port's CPU
   Module on the same batches, each from the card's parameters (phase
   8's bounds). Then a Module over phase 8's ResNet-50 training symbol
   at batch 128 with SGD momentum, 5 steps, its step ms beside phase
   8's executor + K2 step. No kernel of the port launches in this phase;
16. the KVStore and the gradient allreduce through the port's launcher
   (``mxnet_tpu_torch/tools/launch.py``; the workers run this script
   with ``--dist-worker``): gluon ResNet-50 v1 (25.6M parameters in 161
   trainable tensors) at batch 64 a worker, ``Trainer("sgd", momentum)``;
   ``dist_sync`` with 1 server (its optimizer on this card) and 2
   workers, 3 steps with ``update_on_kvstore`` and a second job of 3
   without: the workers' parameters the same bits after every step, and
   step 1 the SGD class on the sum of the two workers' own gradients
   (phase 8's bound); step ms, images/s, push and pull MB/s, the
   server's update ms. Then ``dist_device_sync`` with ``-s 0``: one
   worker over NCCL at world size 1, its 3 steps the same bits as a
   ``kvstore="device"`` Trainer's from the same weights (cuDNN
   deterministic), and the allreduce of 25M f32 as ``bench.py``
   ``_bench_allreduce`` reports it at one rank (2 x bytes / s, CUDA
   events; no bus bandwidth). No kernel of the port launches here;
17. the serving planes on the one card, at phase 5's decoder widths
   (2.147 GB f32 pool a lane) and burst: ``Gateway(devices=
   [cuda:0])`` with ``register_generator(replicas=2)`` (degraded, its
   warning logged once), lane 0 killed mid-stream with ``GenLane.kill``:
   every stream equal to ``reference_generate`` (the burst's references
   computed once, from the first scenario's streams: one causal forward
   over prompt + stream checks each emitted token's argmax, and a
   position whose top-two logits are within ``REF_MARGIN`` is
   recomputed over its prefix alone), at least one KV-block
   migration with ``bytes_moved`` = blocks x ``bytes_per_block``, K4
   still launching on the survivor and ``memory_allocated`` down by one
   pool; the same kill under ``MXNET_KVSTORE_FAULT_PLAN=replay_storm``
   (every rescue a replay: K3, then K4 at batch 1) and under
   ``migrate_wedge@round=1``; one lane scaled to 3 and back to 1 while
   streams run (two pools released); a bf16 pool killed mid-stream,
   tokens equal to the plain paged lane's; ``MXTPU_GEN_MAX_RECOVERIES=0``,
   a fast ``RejectedError(reason="lane_lost")``; phase 10's exported
   ResNet-50 with two replicas, a fault injected into replica 0 (its
   batch redistributes, replies bitwise the one-replica replies),
   ``check_health(revive=True)``, ``scale`` 2 -> 3 -> 1 leaving one lane
   thread. Each scenario's K3 / K4 launches equal its lanes' prefill and
   decode calls (warmups, prefills, replays, batched and batch-1 steps) x
   layers. Prints tokens/s, kill-to-next-token ms, migrated bytes and
   migration / replay ms per scenario; 60 s at most;
18. the record input pipeline: a seeded ``.rec`` / ``.idx`` of 128 x N
   x 4 JPEGs of 256 x 256 (N the decode workers the host's cores allow:
   its cores less two) written under ``build/`` with ``recordio``; then
   ``ImageRecordIter(num_workers=N)`` at batch 128, ``data_shape`` (3,
   224, 224), ``rand_crop``, ``rand_mirror``, ``shuffle``, the ImageNet
   mean and std, through the pinned-memory device feeder
   (``PrefetchingIter(prefetch_to_device=True)``): its first two batches
   on the card the bits of the same iterator's built for the CPU; the
   pipeline's images/s at N = 1 and at N, with the decoder the workers
   ran (libjpeg where the host has it, else PIL) and the parent's
   seconds blocked on a slot, allocating pinned memory and copying the
   slot into it; one worker SIGKILLed
   mid-epoch, the epoch after its respawn the undisturbed run's batches
   (CRC-32 of each batch's bytes); then ``Module.fit`` over phase 8's
   ResNet-50 training symbol on the card (SGD momentum, one epoch of 4N
   steps) fed by that pipeline through the feeder: step ms (median and
   the window's mean), the parent's work inside each step, the data
   wait's share of the step (the consumer's blocked time in the feeder)
   and the step ms of the same Module fed a batch already on the card.
   No kernel of the port launches here; 60 s at most;
19. gluon.data over phase 18's records (written if missing):
   ``ImageRecordDataset(...).transform_first(Compose([
   RandomFlipLeftRight(), CenterCrop(224), ToTensor(), Normalize(the
   ImageNet mean and std)]))`` through ``DataLoader(batch_size=128,
   num_workers=N)`` on each path: the thread pool's Python path, the
   native plan (libjpeg where the host has it; the line says whether it
   ran, or "libjpeg absent: Python path") and ``thread_pool=False`` over
   the sharded decode workers. On each, the first two batches through
   the device feeder (``prefetch_to_device=True``) on the card against
   the same loader's built on the CPU (the sharded workers' the same
   bits; the pool's threads draw the mirror from numpy's global
   generator in no fixed order, so each image is the CPU's bits or
   their exact mirror), and images/s on the host (the pool at one
   thread too). Then phase 11's gluon ResNet-50 v1 step at batch 128
   fed by the native-plan and the sharded loader through the feeder,
   against the same step on a batch already on the card: step ms
   (median and window mean) and the data wait's share of the step;
   then ``contrib.io.DataLoaderIter`` over the sharded loader for one
   short ``Module.fit`` epoch (a batch a worker, over a copy of the
   first records) of phase 8's ResNet-50 training symbol. No kernel of
   the port launches here; 60 s at most;
20. the SSD detector of ``examples/ssd`` (the port's block
   ``ssd_class``: 2 classes, 64 x 64 images, 344 anchors) on the card
   from seeded weights: a seeded ``.rec`` of ``train_ssd.py``'s
   synthetic rectangles through ``ImageDetIter(rand_crop, rand_mirror,
   max_objects=8)`` into ``train_ssd.py``'s step (``MultiBoxTarget``
   with 3:1 hard negatives, softmax cross-entropy and the masked L1
   loss, SGD momentum 0.9, wd 5e-4) at batch 8: the first step's class
   targets the CPU's bits, its loss, gradients and updated weights
   within phase 11's fp32 bounds of the port's CPU step on the same
   batch and weights; ``MultiBoxDetection`` (NMS 0.45, threshold 0.01)
   on the card against the CPU on the same inputs (kept ids, scores and
   order the same bits, boxes within 1e-6), ``MultiBoxTarget`` on tied
   inputs the CPU's bits; step ms, data wait, and the ms of
   ``box_nms``, ``MultiBoxDetection`` and ``MultiBoxTarget`` at the
   path's shapes. No kernel of the port launches here; 60 s at most;
21. the parallel layouts, every shard on the one card (a slice or mesh
   that lists ``cuda:0`` twice, reported ``degraded``): a tp 2 paged pool
   at phase 5's widths, each shard one K and one V tensor of half the
   2.147 GB (``torch.cuda.memory_allocated`` before, after and on
   close); ``Gateway.register_generator(tp=2)`` serving phase 5's burst
   over the tp mesh slice (weights split by the layout table, K3 prefill
   and K4 decode on each shard's 4 heads, row-parallel allreduces),
   its tokens equal to the tp 1 lane's and to ``reference_generate``
   (phase 17's, one of them recomputed), exactly 2 x 8 K3 launches a
   prefill call and 2 x 8 K4 launches a decode call (warmups included);
   tokens/s of both lanes; ``ulysses_attention`` at sp 2 over phase 12's
   LM shape (8 x 2048 tokens, 12 heads, D 64, causal), fp32 and bf16,
   bitwise equal to one K3 call over all the heads and within K3's
   bounds of ``flash_attention_plain`` (fp32 1e-4; bf16 rtol 0.1 / atol
   0.05 and no more than twice the plain bf16 version's relative L2
   distance from an f64 run), one K3 launch a shard a call, and
   ``ring_attention_sharded`` at the same shape (plain ops: no launch)
   within the same bounds, each timed beside one K3 call over all the
   heads; ``tp_mlp`` at 768
   / 3072 over the same tokens within the JAX package's 5e-5 of the
   scale of one device's MLP, timed; 120 s at most;
22. data parallelism and ZeRO over the mesh, every position on the card
   (a mesh that lists ``cuda:0`` twice): at phase 12's widths (vocab
   50304, 12 x 768, (8, 2048) tokens, fp32) a functional decoder loss
   after ``tools/layout_report.py``'s with its attention through the
   flash kernel, one SGD-momentum step each of the dp 1 step, the
   replicated dp 2 step and ZeRO stages 1, 2 and 3 from the same seeded
   weights: the stages the replicated step's bits (else held to the
   rule below), dp 2 within phase 12's fp32 rule of dp 1 (the loss to
   1e-5, each gradient no further, relative L2, from a float64 step of
   the same loss than twice dp 1's), exactly 2 x 12 flash forward and 2
   x 12 flash backward launches a dp 2 step, each position's momentum
   (and, at stage 3, parameter) bytes half the replicated step's, read
   from the shards' storage, and step ms; the model-zoo ResNet-50 v1
   symbol at batch 128 through ``simple_bind(mesh=)`` over a dp 2 mesh,
   its batch from ``PrefetchingIter(sharding=)`` (the bits of the
   unsharded batch, used in place), one training step against the
   one-device executor (outputs, gradients and moving-statistic updates
   no further, relative L2, from a float64 step than twice the
   one-device step's distance), step ms of both; ResNet-50 v1 served
   over a tp 2 slice (``register(tp=2)``, fp32 and bf16) against a
   one-device lane on a 64-request burst each: fp32 within the JAX
   package's 5e-5, bf16 no further from the fp32 lane than twice the
   one-device bf16 lane, each position's parameter bytes the placement
   report's, images/s of both; 60 s at most;
23. the observability planes (telemetry, tracing, the profiler and the
   Monitor) on the card: phase 5's decoder (2.147 GB pool) serving the
   burst's first 8 requests through ``Gateway.generate``, all admitted
   at once (the lane takes none until every one is queued, so every run
   decodes the same batches), with the planes on (telemetry, every trace
   sampled) and off (``MXTPU_TELEMETRY=0``'s and ``MXTPU_TRACE_SAMPLE=0``'s
   settings): each request one ``serving.generate`` root with one
   ``generate.prefill`` and one ``generate.token`` a new token under it,
   each with the JAX package's attributes; the ``mx_serving_generate_*``
   counters the requests and tokens served; the same K3 / K4 launches
   and tokens with the planes off; then phase 12's
   decoder-LM step (Adam, fp32) under ``profiler.set_state("run")``, 3
   steps after a warm one: 3 ``trainer_step`` spans with consecutive
   ``step`` attrs, 3 step breakdowns, 12 K3 forward and 12 K3 backward
   launches a step and 12 profiled ``_contrib_flash_attention``
   dispatches a step in the chrome JSON ``profiler.dump()`` writes; the
   synchronizing CUDA calls (``torch.cuda.set_sync_debug_mode("warn")``)
   of one serving call and of one training step equal with the planes on
   and off; ``Monitor(interval=1)`` on LeNet's ``Module.fit`` for 2
   batches of 64 on the card and on the CPU from the same parameters: the
   same names in the same order, each statistic within phase 8's tensor
   bound; tokens/s of phase 5's whole burst (32 requests) and LM step
   ms (2 steps a turn) with the planes off and on in 3 turns each
   (``observability_cost``); 60 s at most;
24. the model-health and memory planes and tail attribution on the
   card (``health_and_tails``): phase 12's decoder-LM (fp32) through
   ``Trainer("adam")`` with the planes on, 6 steps then 3 counted ones
   (12 K3 forward and 12 backward launches a step): the probe's
   nonfinite counts exactly, and its norms within 1e-5 relative, of an
   f64 host run over the same tensors; every counted ``trainer_step``
   span with ``health_nonfinite``, ``loss_ewma`` and ``grad_norm``; the
   census's ``mx_memory_live_bytes`` on the card equal to the
   parameters' and Adam states' bytes, ``activation`` at least 0; 0
   synchronizing calls a step with the planes on and off; the probe's
   launches a step (torch.profiler) and device ms; LeNet bound with
   ``simple_bind`` on the card and on the CPU, one weight poisoned at
   step 2 under ``MXTPU_HEALTH=raise``: ``NonfiniteError`` at the
   boundary after the fold lag (later on the card while the count's
   copy is in flight), both postmortems naming step 2 and the same first
   node; a tensor larger than the card requested inside a ``Trainer``
   step: the OOM postmortem (census, ``memory_stats``, flight dump)
   written, the step after it fine; phase 5's decoder serving the
   burst's first 8 requests (admitted at once) with the tail plane on
   and with ``MXTPU_TAIL_ENABLE=0``: the same tokens and K3 / K4
   launches, every request's bins conserving (residual within 0.10),
   the ``tail/v1`` document through ``tools/tail_report.py``; LM step
   ms and serving tokens/s with the planes off and on
   (``health_cost``); 40 s at most;
25. the cost ledger and its device capture (``cost_ledger``; alone:
   ``python3 chip_smoke.py --cost-ledger``): phase 12's decoder-LM
   step (fp32, Adam) through ``profiling.ledger.from_fn``: exactly 12
   K3-forward and 12 K3-backward rows at the function's FLOPs (51.56
   and 128.91 GFLOP a call), the step's FLOPs beside the hand count
   (6 x the product parameters x tokens + the 12 K3 calls); then
   ``profiling.attribution_run`` over 3 steps under torch.profiler: the
   reconciliation (the table's device time no more than 1.05 x the
   CUDA-event step time, a hard limit; a ratio under 0.9 is printed),
   ``mfu`` at 67 TFLOP/s, the top 10 ops, what the profiler lost
   (kernel events against launches) and the measured K3 rows against 12
   x their CUDA-event time a call; ``memory.from_fn`` over the step,
   its peak live bytes beside ``max_memory_allocated`` less the
   baseline; the K3 / K4 launches and synchronizing calls of a step and
   a decode call with no recorder or capture, the same before and after;
   phase 6's INT8 ResNet-50 v1 forward at batch 128: 53 K1 rows and 53
   ``_sg_xla_quant_conv`` scopes, every fused row under the
   ``XLA/quantize_conv_requantize`` rule, K1 at 5 B and 2 flops an
   element; phase 8's symbolic training step at batch 128: 161 K2 rows
   at 20 B an element; 40 s at most;
26. one ``{"kernels": [...]}`` line (the D 256 rows in their kernels'
   entries, phase 17's launches as ``planes_launches``, phase 21's as
   ``parallel_launches``, phase 22's as ``data_parallel_launches``,
   phase 23's as ``observability_launches``, phase 24's as
   ``health_launches``, phase 25's as ``cost_ledger_launches``), then
   the result line ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout (no ``mxnet_tpu_torch`` beside this
file), it exits with a non-zero code.
"""
from __future__ import annotations

import gc
import io
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import zlib

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
# numbers one phase prints that a later one prints beside its own
RESULTS = {}
# wall seconds of each phase function, summed over its calls
PHASE_S = {}


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
def paged_inputs(lens, layers, nb, dev, rng, width=TABLE_WIDTH,
                 hd=HEAD_DIM):
    """q, per-layer pool views, tables of ``width`` blocks, seq_lens for
    one decode step: each row's live blocks are distinct pool blocks, the
    rest pad sink."""
    b = len(lens)
    q = torch.from_numpy(rng.standard_normal(
        (b, HEADS, hd), dtype=np.float32)).to(dev)
    shape = (layers, nb, BLOCK_TOKENS, HEADS, hd)
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


# head sizes of the repo's small decoders (8: the JAX serving tests'; 16:
# a default GenerativeDecoder's), Gemma-7B's 256, and two the kernels are
# not built for, served from a pool laid out at the next built size (80
# -> 128, 200 -> 256)
EXTRA_HEAD_DIMS = (8, 16, 80, 256, 200)


def paged_head_sizes(att, dev, cache, name):
    """K4 at EXTRA_HEAD_DIMS over a pool laid out as BlockPool lays it out
    (``paged_head_dim``: zero columns past D), against the plain version
    over the unpadded pool (PAGED_TOL), lengths about the 64- and
    128-token splits, a padding row held to zeros. A generator of its
    own leaves the phase's draws as they were."""
    hrng = np.random.default_rng(SEED + 21)
    # about the 32-, 64- and 128-token splits (32: bf16 at D 256)
    lens = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 300,
            TABLE_WIDTH * BLOCK_TOKENS, 0]
    live = torch.from_numpy(np.asarray(lens) > 0).to(dev)
    for hd in EXTRA_HEAD_DIMS:
        pd = att.paged_head_dim(hd)
        q, k, v, tab, sl = paged_inputs(lens, 1, 512, dev, hrng, hd=hd)
        k, v = k[0].to(cache), v[0].to(cache)
        kp, vp = (torch.nn.functional.pad(x, (0, pd - hd)) for x in (k, v))
        got = att.paged_attention(q, kp, vp, tab, sl)
        want = att.paged_attention_plain(q, k, v, tab, sl)
        torch.cuda.synchronize()
        e = (got - want).abs()[live].max().item()
        log(f"{name} D={hd} (pool laid out at D {pd}): max abs err "
            f"{e:.3e} (tol {PAGED_TOL})")
        check(got.shape == q.shape and e <= PAGED_TOL,
              f"{name} D={hd}: error {e} (shape {tuple(got.shape)})")
        check(bool(torch.all(got[~live] == 0)), f"{name} D={hd}: "
              "seq_len-0 row not zeros")
        del q, k, v, kp, vp, got, want


def time_flash_tree(root):
    """K3's timing rows at the decoder-LM shape (B 8, H 12, T 2048, D 64,
    causal): the forward and the backward, f32 and bf16, for the checkout
    at ``root``, as phases 3 and 13 time this one's (``measure``, 20
    calls): another commit's kernels timed the same way in the same
    call."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = os.path.abspath(root)
    check(os.path.isdir(os.path.join(root, "mxnet_tpu_torch")),
          f"no mxnet_tpu_torch package in {root}")
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.ops import attention as att
    dev = torch.device("cuda", 0)
    log(card_line())
    log(f"flash timing of {att.__file__}")
    gen = torch.Generator().manual_seed(SEED)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        make = lm_qkv if dtype == torch.float32 else lm_qkv_bf16
        q, k, v = make(LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM, dev, gen)
        out, lse = att._flash_fwd(q, k, v, True, LM_HEAD_DIM ** -0.5,
                                  with_lse=True)
        d_out = torch.randn(out.shape, generator=gen).to(dev, dtype)
        tag = "f32" if dtype == torch.float32 else "bf16"
        rows[f"fwd_{tag}_ms"], _ = measure(
            lambda: att.flash_attention(q, k, v, True), iters=20)
        rows[f"bwd_{tag}_ms"], _ = measure(
            lambda: att.flash_attention_bwd(q, k, v, out, d_out, lse, True),
            iters=20)
        del q, k, v, out, lse, d_out
        torch.cuda.empty_cache()
    log("flash_timing " + json.dumps(rows))
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
    # the wrapper's launches, once a call, and which kernels run
    # (torch.profiler: it may lose records, so each kernel at most once a
    # call; a window that recorded nothing is taken again, so the calls
    # it makes are not the ones counted here)
    bf16 = cache == torch.bfloat16
    count = "launches_bf16" if bf16 else "launches"
    counted = getattr(att.paged_attention, count)
    for _ in range(PAGED_RUN):
        att.paged_attention(q, k[0], v[0], tab, sl)
    counted = getattr(att.paged_attention, count) - counted
    launched = kernels_launched(
        lambda: att.paged_attention(q, k[0], v[0], tab, sl), PAGED_RUN)
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

    paged_head_sizes(att, dev, cache, name)

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


# K3 at the head sizes of EXTRA_HEAD_DIMS that no kernel is built for
# (padded to the next built size), causal with T_q < T_k (the diagonal
# shifted by T_k - T_q), and the D 256 instances (200 padded to them):
# (T_q, T_k, D, causal), dense (B 2, H 3 or 4)
FLASH_EXTRA_CASES = [(100, 100, 8, True), (256, 256, 8, False),
                     (100, 100, 80, True), (256, 256, 80, False),
                     (100, 256, 64, True), (64, 1024, 64, True),
                     (100, 256, 8, True), (100, 256, 80, True),
                     (256, 256, 256, True), (130, 70, 256, False),
                     (100, 256, 256, True), (160, 160, 200, True)]


def extra_qkv(t_q, t_k, d, dev, rnd):
    """Dense (2, H, T, D) q and (2, H, T_k, D) k, v from ``rnd(shape)``
    (H 4 at D 64, else 3)."""
    h = 4 if d == 64 else 3
    return (rnd((2, h, t_q, d)).to(dev),
            *(rnd((2, h, t_k, d)).to(dev) for _ in range(2)))


def phase_flash(att, build, dev, rng):
    flash_sass(build, count=5)
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
    xrng = np.random.default_rng(SEED + 20)

    def inputs():
        for t, hd, causal in cases:
            yield f"T={t} D={hd}", (*prefill_qkv(t, dev, rng, hd), causal)
        # a generator of their own: the phase's later draws stay as they
        # were
        for t_q, t_k, hd, causal in FLASH_EXTRA_CASES:
            yield f"Tq={t_q} Tk={t_k} D={hd}", (*extra_qkv(
                t_q, t_k, hd, dev, lambda shape: torch.from_numpy(
                    xrng.standard_normal(shape, dtype=np.float32))), causal)

    for tag, (q, k, v, causal) in inputs():
        got = att.flash_attention(q, k, v, causal=causal)
        want = att.flash_attention_plain(q, k, v, causal=causal)
        exact = att.flash_attention_plain(q.double(), k.double(),
                                          v.double(), causal=causal)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        e_kernel = (got.double() - exact).abs().max().item()
        e_plain = (want.double() - exact).abs().max().item()
        log(f"flash_attention {tag} causal={causal}: max abs err "
            f"{e:.3e} (tol {FLASH_TOL}); vs f64 kernel {e_kernel:.3e}, "
            f"fp32 plain {e_plain:.3e}")
        check(got.shape == q.shape and e <= FLASH_TOL,
              f"flash_attention {tag} causal={causal} error {e} > "
              f"{FLASH_TOL}")
        err = max(err, e)
        err_kernel = max(err_kernel, e_kernel)
        err_plain = max(err_plain, e_plain)
        worst_ratio = max(worst_ratio, e_kernel / e_plain)
    log(f"flash_attention vs f64 over "
        f"{len(cases) + len(FLASH_EXTRA_CASES)} cases: kernel "
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
    flash_sass(build, "flash_attention_bwd", "_f32_kernel", "TF32", 10)
    gen = torch.Generator().manual_seed(SEED)
    cases = [(LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ, LM_HEAD_DIM, True, True),
             (2, 4, 256, 256, 16, True, False),
             (2, 4, 256, 256, 32, True, False),
             (2, 4, 256, 256, 128, True, False),
             (2, 4, 128, 192, 64, False, False),
             (2, 4, 100, 100, 64, True, False),
             (2, 4, 100, 100, 64, False, True)]
    cases += [(2, 4 if d == 64 else 3, t_q, t_k, d, causal, False)
              for t_q, t_k, d, causal in FLASH_EXTRA_CASES]
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
        pool_bytes = gen.lanes[0].pool.bytes_total
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
    # phase 25 prices this graph's forward
    RESULTS["int8_graph"] = (fused, qarg, qaux)
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
    RESULTS["resnet50_train_step_ms"] = main["step_ms"]
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


def serve_burst(gw, xs, variant, name="r50"):
    """``len(xs)`` requests submitted back to back (the lane coalesces
    them under max_wait); returns the replies, per-request latencies in
    ms (submit to reply on the host clock), the burst's wall seconds
    and the model's batch / row / padding counts over it."""
    before = gw.stats()[name]
    t0 = time.perf_counter()
    reqs = [gw.submit(name, x, variant=variant) for x in xs]
    replies = [r.result(timeout=600)[0] for r in reqs]
    wall = time.perf_counter() - t0
    after = gw.stats()[name]
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
    RESULTS["gluon_train_step_ms"] = fp32["step_ms"]
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
    flash_sass(build, kernel="flash_attention_bf16_kernel", kind="HGMMA",
               count=5)
    gen = torch.Generator().manual_seed(SEED + 13)
    cases = [(1, D_MODEL // hd, t, t, hd, True, "prefill")
             for hd in (16, 32, 64, 128) for t in (16, 32, 64, 128, 256, 512)]
    cases += [(1, HEADS, 100, 100, HEAD_DIM, True, "prefill"),
              (LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ, LM_HEAD_DIM, True, "lm")]
    cases += [(2, None, t_q, t_k, d, causal, "dense")
              for t_q, t_k, d, causal in FLASH_EXTRA_CASES]
    err, worst, worst_round = 0.0, 0.0, 0.0
    for b, h, t, t_k, d, causal, layout in cases:
        if layout == "lm":
            q, k, v = lm_qkv_bf16(b, t, h, d, dev, gen)
        elif layout == "prefill":
            # (1, H, T, D) views of the prefill's (1, T, 3 d) output
            qkv = torch.randn((1, t, 3 * h * d), generator=gen).to(
                dev).bfloat16()
            q, k, v = (y.view(1, t, h, d).transpose(1, 2)
                       for y in qkv.chunk(3, dim=-1))
        else:
            q, k, v = extra_qkv(t, t_k, d, dev, lambda shape: torch.randn(
                shape, generator=gen).bfloat16())
            h = q.shape[1]
        got = att.flash_attention(q, k, v, causal=causal)
        want = att.flash_attention_plain(q, k, v, causal=causal)
        exact = att.flash_attention_plain(q.double(), k.double(),
                                          v.double(), causal=causal)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16, f"flash bf16 output {got.dtype}")
        ok_plain, e = within(got, want, BF16_RTOL, BF16_ATOL)
        ok_exact, _ = within(got, exact, BF16_RTOL, BF16_ATOL)
        r_kernel, r_plain = rel_l2(got, exact), rel_l2(want, exact)
        r_round = rel_l2(exact.to(torch.bfloat16), exact)
        check(got.shape == q.shape, f"flash bf16 output {tuple(got.shape)}")
        log(f"flash_attention bf16 B={b} H={h} T={t} Tk={t_k} D={d} "
            f"causal={causal}: max abs err "
            f"{e:.3e} vs plain bf16; vs f64 (relative L2) kernel "
            f"{r_kernel:.3e}, plain bf16 {r_plain:.3e}, f64 output rounded "
            f"to bf16 {r_round:.3e}")
        check(ok_plain and ok_exact, f"flash_attention bf16 B={b} T={t} "
              f"Tk={t_k} D={d}: outside rtol {BF16_RTOL} / atol "
              f"{BF16_ATOL}")
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
    flash_sass(build, "flash_attention_bwd", "_bf16_kernel", "BF16", 10)
    gen = torch.Generator().manual_seed(SEED + 14)
    # the forward's grid (every prefill bucket at every head size, as
    # views of one projection), the LM shape, and rectangular / ragged
    cases = [(1, D_MODEL // hd, t, t, hd, True, "prefill")
             for hd in (16, 32, 64, 128) for t in (16, 32, 64, 128, 256, 512)]
    cases += [(LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ, LM_HEAD_DIM, True, "lm"),
              (2, 4, 128, 192, 64, False, "dense"),
              (2, 4, 100, 100, 64, True, "dense")]
    cases += [(2, 4 if d == 64 else 3, t_q, t_k, d, causal, "dense")
              for t_q, t_k, d, causal in FLASH_EXTRA_CASES]
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
        pool = gen.lanes[0].pool
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

# -- phase 14: serving at every head size --------------------------------
# decoders whose heads the K3 / K4 kernels serve at sizes other than the
# quickstart's 64: a default GenerativeDecoder (d_model 64, 4 heads: D
# 16), the JAX package's serving tests' (d_model 32, 4 heads: D 8), and
# D 80, which no kernel is built for (K3 pads it, the pool is laid out at
# 128): (name, constructor arguments, register_generator arguments)
SMALL_DECODERS = (
    ("default", dict(vocab_size=VOCAB),
     dict(block_tokens=16, max_blocks=256, max_new_tokens=24,
          max_decode_batch=8)),
    ("jax_tests", dict(vocab_size=50, d_model=32, num_layers=2,
                       num_heads=4, max_prompt_tokens=12),
     dict(block_tokens=4, max_blocks=64, max_new_tokens=12,
          max_decode_batch=4)),
    ("d80", dict(vocab_size=VOCAB, d_model=160, num_layers=2, num_heads=2,
                 max_prompt_tokens=64),
     dict(block_tokens=16, max_blocks=256, max_new_tokens=24,
          max_decode_batch=8)),
    ("d256", dict(vocab_size=VOCAB, d_model=512, num_layers=2, num_heads=2,
                  max_prompt_tokens=64),
     dict(block_tokens=16, max_blocks=256, max_new_tokens=24,
          max_decode_batch=8)),
    ("d200", dict(vocab_size=VOCAB, d_model=400, num_layers=2, num_heads=2,
                  max_prompt_tokens=64),
     dict(block_tokens=16, max_blocks=256, max_new_tokens=24,
          max_decode_batch=8)))


def phase_serve_heads(att, i8, fo, dev):
    """``Gateway.generate`` on SMALL_DECODERS with an f32 and a bf16 pool:
    f32 tokens equal ``reference_generate`` (the unpaged plain-attention
    oracle) for every request; bf16 tokens equal the same lane's with the
    plain paged attention on the same pool (phase 13's rule: the oracle's
    K/V are not rounded to bf16). One flash launch a layer a prefill and
    one paged launch a layer a decode step, of the pool's type; the pool's
    bytes at the head size it was laid out with. Returns the D 256
    decoder's launches ({dtype: kernel counts}), the head size's launches
    on a serving path."""
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import (GenerativeDecoder,
                                                  reference_generate)
    from mxnet_tpu_torch.serving.generate import model as gen_model

    prng = np.random.default_rng(SEED + 22)
    rows, d256 = [], {}
    for name, cfg, lane_cfg in SMALL_DECODERS:
        max_prompt = cfg.get("max_prompt_tokens", 64)
        vocab = cfg["vocab_size"]
        plens = [1, 3, max_prompt // 2, max_prompt - 1, max_prompt, 7]
        prompts = [prng.integers(0, vocab, n).tolist() for n in plens]
        new = [lane_cfg["max_new_tokens"] - i for i in range(len(plens))]
        for dtype in ("float32", "bfloat16"):
            dec = GenerativeDecoder(**cfg, device=dev, seed=SEED,
                                    dtype=dtype)
            bf16 = dtype == "bfloat16"
            att.reset_launches()
            gw = Gateway(device=dev)
            try:
                gen = gw.register_generator("lm", dec, **lane_cfg)
                pool = gen.lanes[0].pool
                pool_d, pool_bytes = pool.pool_head_dim, pool.bytes_total
                check(pool_bytes == 2 * pool.num_layers * pool.max_blocks
                      * pool.block_tokens * pool.num_heads * pool_d
                      * pool.k.element_size(), f"serve {name}: pool bytes")
                reqs = [gw.submit_generate("lm", p, max_new_tokens=n)
                        for p, n in zip(prompts, new)]
                got = [r.result(300) for r in reqs]
                calls = gw.stats()["lm"]["lanes"][0]["step_calls"]
                counts = kernel_counts(att, i8, fo)
                if bf16:
                    # the plain version over the pool's first D columns
                    def plain(q, kc, vc, *a):
                        d = q.shape[-1]
                        return att.paged_attention_plain(
                            q, kc[..., :d], vc[..., :d], *a)

                    paged = gen_model.paged_attention
                    gen_model.paged_attention = plain
                    try:
                        want = [gw.generate("lm", p, max_new_tokens=n)
                                for p, n in zip(prompts, new)]
                    finally:
                        gen_model.paged_attention = paged
            finally:
                gw.close()
            if not bf16:
                want = [reference_generate(dec, p, n)
                        for p, n in zip(prompts, new)]
            layers = dec.num_layers
            paged_key = "paged_attention_bf16" if bf16 else "paged_attention"
            check(all(len(g) == n for g, n in zip(got, new)),
                  f"serve {name} {dtype}: lengths {[len(g) for g in got]}")
            check(got == want, f"serve {name} {dtype} (D {dec.head_dim}): "
                  f"tokens differ from the "
                  f"{'plain paged lane' if bf16 else 'reference_generate'}"
                  f":\n{got}\n{want}")
            check(counts["flash_attention"] == calls["prefill"] * layers
                  and counts[paged_key] == calls["decode"] * layers
                  and counts[paged_key] > 0
                  and counts["flash_attention_bf16"] == 0,
                  f"serve {name} {dtype}: launches {counts}, calls {calls}")
            row = {"decoder": name, "dtype": dtype, "head_dim": dec.head_dim,
                   "pool_head_dim": pool_d, "pool_gb": pool_bytes / 1e9,
                   "requests": len(prompts), "tokens": int(sum(new)),
                   "flash_launches": counts["flash_attention"],
                   "paged_launches": counts[paged_key], "step_calls": calls}
            log(f"serve_heads {name} {dtype} D={dec.head_dim}: pool laid "
                f"out at D {pool_d}, {pool_bytes / 1e9:.6f} GB; "
                f"{len(prompts)} requests token-exact")
            rows.append(row)
            if name == "d256":
                d256[dtype] = counts
            del dec
    log("serve_heads " + json.dumps(rows))
    torch.cuda.empty_cache()
    return d256


# -- phase 15: the Module API ---------------------------------------------
MODULE_BATCH, MODULE_LR = 64, 0.1
MODULE_PARITY_STEPS, MODULE_TRACED_STEPS = 3, 10
MODULE_R50_STEPS = 5
MODULE_MIN_ACCURACY = 0.99


def lenet(sym):
    """examples/image-classification/train_mnist.py's ``lenet()``, on the
    port's ``sym``."""
    data = sym.var("data")
    c1 = sym.Convolution(data, name="conv1", kernel=(5, 5), num_filter=20)
    a1 = sym.Activation(c1, act_type="tanh")
    p1 = sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(p1, name="conv2", kernel=(5, 5), num_filter=50)
    a2 = sym.Activation(c2, act_type="tanh")
    p2 = sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    fl = sym.Flatten(p2)
    f1 = sym.FullyConnected(fl, name="fc1", num_hidden=500)
    a3 = sym.Activation(f1, act_type="tanh")
    f2 = sym.FullyConnected(a3, name="fc2", num_hidden=10)
    return sym.SoftmaxOutput(f2, name="softmax")


def mnist_iters(mx, here, batch, ctx):
    """train_mnist.py's data: the idx files in the checkout's data/
    (written there from the seed by ``test_utils.get_mnist_ubyte`` when
    missing, the bytes the JAX package writes) through the port's
    MNISTIter (train shuffled, validation in order)."""
    data = os.path.join(here, "data")
    mx.test_utils.get_mnist_ubyte(data)
    with ctx:
        train = mx.io.MNISTIter(
            image=os.path.join(data, "train-images-idx3-ubyte"),
            label=os.path.join(data, "train-labels-idx1-ubyte"),
            batch_size=batch, shuffle=True)
        val = mx.io.MNISTIter(
            image=os.path.join(data, "t10k-images-idx3-ubyte"),
            label=os.path.join(data, "t10k-labels-idx1-ubyte"),
            batch_size=batch, shuffle=False)
    return train, val


def module_parity(mx, net, arg_p, batches):
    """The card's first MODULE_PARITY_STEPS ``forward_backward`` +
    ``update`` steps of the fit's Module against the port's CPU Module
    on the same batches, each step from the card's parameters before it
    (phase 8's bounds, TF32 off: the loss to PARITY_LOSS_RTOL, every
    gradient and updated parameter to PARITY_TENSOR_TOL of its largest
    value)."""
    mods = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        m = mx.mod.Module(net, context=ctx)
        m.bind([("data", (MODULE_BATCH, 1, 28, 28))],
               [("softmax_label", (MODULE_BATCH,))])
        m.init_params(None, arg_params=arg_p, aux_params={})
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": MODULE_LR})
        mods[where] = m
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step, (x, y) in enumerate(batches):
        arg, aux = mods["card"].get_params()
        mods["cpu"].set_params({k: v.asnumpy() for k, v in arg.items()}, {})
        got = {}
        for where, m in mods.items():
            ctx = mx.gpu(0) if where == "card" else mx.cpu()
            with ctx:
                batch = mx.io.DataBatch(data=[mx.nd.array(x)],
                                        label=[mx.nd.array(y)])
            m.forward_backward(batch)
            loss = float(cross_entropy(m.get_outputs()[0]._data,
                                       batch.label[0]._data))
            grads = {n: m._exec.grad_dict[n].asnumpy()
                     for n in m._param_names}
            m.update()
            got[where] = (loss, grads,
                          {k: v.asnumpy() for k, v in
                           m.get_params()[0].items()})
        (lc, gc, pc), (lu, gu, pu) = got["card"], got["cpu"]
        r = abs(lc - lu) / abs(lu)
        worst["loss"] = max(worst["loss"], r)
        check(r <= PARITY_LOSS_RTOL, f"module step {step}: loss card {lc} "
              f"vs CPU {lu}")
        for kind, a, b in (("grad", gc, gu), ("param", pc, pu)):
            for n in b:
                e = float(np.abs(a[n].astype(np.float64) - b[n]).max()
                          / max(np.abs(b[n]).max(), 1e-30))
                worst[kind] = max(worst[kind], e)
                check(e <= PARITY_TENSOR_TOL, f"module step {step}: {kind} "
                      f"{n} card vs CPU {e} of its largest value")
    log(f"module parity: {len(batches)} steps on the card within phase 8's "
        f"bounds of the CPU Module (worst loss {worst['loss']:.3e}, "
        f"gradient {worst['grad']:.3e}, parameter {worst['param']:.3e})")
    return worst


def phase_module(att, i8, fo, dev, here):
    """train_mnist.py's LeNet through ``Module.fit`` on the card over
    data/'s idx files (MNISTIter, batch 64, SGD lr 0.1, Xavier(2),
    Speedometer, one epoch, validation by ``score``); the card's first
    steps against the CPU Module; then a Module over phase 8's ResNet-50
    training symbol at batch 128 (SGD momentum through the optimizer
    class). No kernel of the port launches: the Module's update is the
    optimizer class's own, not K2."""
    import logging

    import mxnet_tpu_torch as mx

    # fit's and Speedometer's lines, on stdout like the rest
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout)
    logging.getLogger().setLevel(logging.INFO)
    before = kernel_counts(att, i8, fo)
    net = lenet(mx.sym)
    train, val = mnist_iters(mx, here, MODULE_BATCH, mx.gpu(0))
    mod = mx.mod.Module(net, context=mx.gpu(0))
    stamps = []

    def stamp(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, eval_metric="acc", optimizer="sgd",
            optimizer_params={"learning_rate": MODULE_LR},
            initializer=mx.initializer.Xavier(magnitude=2.0),
            batch_end_callback=[mx.callback.Speedometer(MODULE_BATCH, 50),
                                stamp],
            num_epoch=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = np.diff(stamps)
    step_ms = float(np.median(steps)) * 1e3
    acc = dict(mod.score(val, "acc"))["accuracy"]
    check(acc >= MODULE_MIN_ACCURACY, f"LeNet validation accuracy {acc} "
          f"< {MODULE_MIN_ACCURACY}")
    # a traced window of steps: the device's idle share
    batches = []
    train.reset()
    for _ in range(MODULE_TRACED_STEPS):
        batches.append(train.next())

    def window():
        for b in batches:
            mod.forward_backward(b)
            mod.update()

    window()
    prof = profile_step(window)
    main = {"batch": MODULE_BATCH, "steps": len(stamps),
            "step_ms": step_ms, "images_per_s": MODULE_BATCH / step_ms * 1e3,
            "epoch_train_s": stamps[-1] - stamps[0] if stamps else None,
            "fit_s": fit_s, "validation_accuracy": acc,
            "traced_steps": MODULE_TRACED_STEPS,
            "traced_idle_share": prof["device_idle_share"],
            "traced_busy_ms": prof["device_busy_ms"],
            "traced_wall_ms": prof["wall_ms"],
            "traced_by_group_ms": prof["by_group_ms"]}

    # the card's first steps against the CPU Module, from one draw
    init = mx.mod.Module(net, context=mx.cpu())
    init.bind([("data", (MODULE_BATCH, 1, 28, 28))],
              [("softmax_label", (MODULE_BATCH,))])
    init.init_params(mx.initializer.Xavier(magnitude=2.0))
    arg_p = {k: v.asnumpy() for k, v in init.get_params()[0].items()}
    ptrain, _ = mnist_iters(mx, here, MODULE_BATCH, mx.cpu())
    parity_batches = []
    for _ in range(MODULE_PARITY_STEPS):
        b = ptrain.next()
        parity_batches.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    main["parity"] = module_parity(mx, net, arg_p, parity_batches)

    # ResNet-50 through the Module at phase 8's batch: the optimizer
    # class's per-parameter update against phase 8's K2 step
    rnet, params, r_arg, r_aux = train_net(mx, here)
    rmod = mx.mod.Module(rnet, context=mx.gpu(0))
    rmod.bind([("data", (TRAIN_BATCH,) + R50_SHAPE[1:])],
              [("softmax_label", (TRAIN_BATCH,))])
    rmod.init_params(None, arg_params=r_arg, aux_params=r_aux)
    rmod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": SGD_HYPER["lr"], "momentum": SGD_HYPER["momentum"],
        "wd": SGD_HYPER["wd"]})
    mrng = np.random.default_rng(SEED + 23)
    rbatch = mx.io.DataBatch(
        data=[mx.nd.array(mrng.standard_normal(
            (TRAIN_BATCH,) + R50_SHAPE[1:], dtype=np.float32))],
        label=[mx.nd.array(mrng.integers(0, 1000, TRAIN_BATCH)
                           .astype(np.float32))])
    secs, losses = [], []
    for _ in range(MODULE_R50_STEPS):
        t0 = time.perf_counter()
        rmod.forward_backward(rbatch)
        rmod.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(cross_entropy(rmod.get_outputs()[0]._data,
                                          rbatch.label[0]._data)))
    check(all(np.isfinite(losses)), f"ResNet-50 Module losses {losses}")
    r50 = {"batch": TRAIN_BATCH, "steps": MODULE_R50_STEPS,
           "step_ms": float(np.median(secs[1:])) * 1e3,
           "step_ms_all": [t * 1e3 for t in secs], "losses": losses,
           "phase8_executor_k2_step_ms":
               RESULTS.get("resnet50_train_step_ms")}
    r50["update_profile"] = profile_step(rmod.update)
    main["resnet50_module"] = r50
    after = kernel_counts(att, i8, fo)
    check(after == before, f"the Module phase launched kernels of the port: "
          f"{before} -> {after}")
    logging.getLogger().setLevel(logging.WARNING)
    log("module_fit " + json.dumps(main))
    del mod, rmod, rbatch
    torch.cuda.empty_cache()


# -- phases 3/4 and 13: head size 256, timed at Gemma-7B's widths ----------
# Gemma-7B's attention (16 heads of 256): K3 causal at B 4 x T 2048, K4 at
# B 32 over phase 3's decode lengths
GEMMA_B, GEMMA_H, GEMMA_T, GEMMA_D = 4, 16, 2048, 256


def d256_flash_rows(att, dev):
    """K3 forward and backward, f32 and bf16, at the Gemma widths: held to
    the plain versions at that shape (the f32 forward FLASH_TOL, the
    backward BWD_RTOL / BWD_ATOL plus one bf16 ulp in bf16, the bf16
    forward the JAX bf16 bound), then timed beside the plain versions,
    SDPA and their bounds. {kernel name: row}."""
    gen = torch.Generator().manual_seed(SEED + 32)
    scale = GEMMA_D ** -0.5
    shape = {"B": GEMMA_B, "H": GEMMA_H, "T": GEMMA_T, "D": GEMMA_D,
             "causal": True}
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        make = lm_qkv_bf16 if bf16 else lm_qkv
        q, k, v = make(GEMMA_B, GEMMA_T, GEMMA_H, GEMMA_D, dev, gen)
        out, lse = att._flash_fwd(q, k, v, True, scale, with_lse=True)
        d_out = torch.randn(out.shape, generator=gen).to(dev, dtype)
        plain = att.flash_attention_plain(q, k, v, True)
        if bf16:
            ok, e = within(out, plain, BF16_RTOL, BF16_ATOL)
        else:
            e = (out - plain).abs().max().item()
            ok = e <= FLASH_TOL
        check(ok, f"flash_attention D 256 {dtype}: error {e}")
        del plain
        grads = att.flash_attention_bwd(q, k, v, out, d_out, lse, True)
        want = att.flash_attention_bwd_plain(q, k, v, out, d_out, True)
        rtol = BWD_RTOL + (BF16_ULP if bf16 else 0.0)
        e_bwd = 0.0
        for name, a, w in zip(("dq", "dk", "dv"), grads, want):
            ok, e_g = within(a, w, rtol, BWD_ATOL)
            check(ok, f"flash_attention_bwd D 256 {dtype}: {name} off by "
                  f"{e_g:.3e} beyond rtol {rtol} / atol {BWD_ATOL}")
            e_bwd = max(e_bwd, e_g)
        del grads, want
        torch.cuda.empty_cache()
        fwd = {"shape": shape, "max_abs_err": e}
        fwd["ms"], _ = measure(lambda: att.flash_attention(q, k, v, True),
                               iters=10)
        fwd["plain_ms"], _ = measure(
            lambda: att.flash_attention_plain(q, k, v, True), iters=3)
        with torch.no_grad():
            fwd["library_ms"], _ = measure(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                iters=10)
        bwd = {"shape": shape, "max_abs_err": e_bwd}
        bwd["ms"], _ = measure(
            lambda: att.flash_attention_bwd(q, k, v, out, d_out, lse, True),
            iters=5)
        bwd["plain_ms"], _ = measure(
            lambda: att.flash_attention_bwd_plain(q, k, v, out, d_out, True),
            iters=2)
        ql, kl, vl = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            torch.autograd.grad(o, (ql, kl, vl), d_out)

        both, _ = measure(sdpa_fwd_bwd, iters=5)
        bwd["library_ms"] = both - fwd["library_ms"]
        # bounds: f32 on the card's fp32-accurate route (3xTF32), bf16 on
        # its bf16 tensor cores; bytes each input read and output written
        # once
        fb, ff = flash_bf16_cost(GEMMA_B, GEMMA_H, GEMMA_T, GEMMA_D)
        bb, bf = flash_bwd_cost(GEMMA_B, GEMMA_H, GEMMA_T, GEMMA_T, GEMMA_D,
                                True)
        # the timed forward writes no lse (no gradient asked for)
        lse_b = 4 * GEMMA_B * GEMMA_H * GEMMA_T
        fb -= lse_b
        if bf16:
            bb = (bb - lse_b) // 2 + lse_b
            rate = BF16_FLOPS_PER_S
        else:
            fb *= 2
            rate = TF32_FLOPS_PER_S / 3
        for row, nbytes, flops in ((fwd, fb, ff), (bwd, bb, bf)):
            mem_s, op_s = nbytes / HBM_BYTES_PER_S, flops / rate
            row["bound_ms"] = max(mem_s, op_s) * 1e3
            row["bound_by"] = "bytes" if mem_s >= op_s else "operations"
            row["bytes"], row["flops"] = nbytes, flops
        tag = "_bf16" if bf16 else ""
        rows["flash_attention" + tag] = fwd
        rows["flash_attention_bwd" + tag] = bwd
        del q, k, v, out, lse, d_out, ql, kl, vl
        torch.cuda.empty_cache()
    return rows


def d256_paged_row(att, dev, cache):
    """K4 over ``cache``-typed pools at GEMMA_H heads of GEMMA_D, B 32 at
    PAGED_DECODE_LENS, one pool per layer (as paged_row: consecutive
    calls find the L2 cold), each call within PAGED_TOL of the plain
    version; timed beside it and its bound."""
    prng = np.random.default_rng(SEED + 31)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)
    lens = PAGED_DECODE_LENS
    need = [-(-n // BLOCK_TOKENS) for n in lens]
    nb = 1 + sum(need)
    ids = prng.permutation(np.arange(1, nb))
    tab = np.zeros((len(lens), TABLE_WIDTH), np.int32)
    at = 0
    for i, n in enumerate(need):
        tab[i, :n] = ids[at:at + n]
        at += n
    tab = torch.from_numpy(tab).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((len(lens), GEMMA_H, GEMMA_D), generator=gen, device=dev)
    pools = [[torch.randn((nb, BLOCK_TOKENS, GEMMA_H, GEMMA_D), generator=gen,
                          device=dev).to(cache) for _ in range(2)]
             for _ in range(LAYERS)]
    err = 0.0
    for kc, vc in pools:
        got = att.paged_attention(q, kc, vc, tab, sl)
        want = att.paged_attention_plain(q, kc, vc, tab, sl)
        err = max(err, (got - want).abs().max().item())
    name = "paged_attention" + ("_bf16" if cache == torch.bfloat16 else "")
    check(err <= PAGED_TOL, f"{name} D 256: error {err}")
    layer = [0]

    def run(fn):
        def go():
            li = layer[0] = (layer[0] + 1) % LAYERS
            fn(q, *pools[li], tab, sl)
        return go

    row = {"shape": {"B": len(lens), "H": GEMMA_H, "D": GEMMA_D,
                     "BT": BLOCK_TOKENS, "W": TABLE_WIDTH,
                     "live_tokens": sum(lens)},
           "max_abs_err": err,
           "chunk": att._paged_chunk(
               len(lens), GEMMA_H, GEMMA_D, TABLE_WIDTH, BLOCK_TOKENS,
               cache == torch.bfloat16,
               torch.cuda.get_device_properties(dev).multi_processor_count),
           "library_ms": None}
    row["ms"], _ = measure(run(att.paged_attention))
    row["plain_ms"], _ = measure(run(att.paged_attention_plain), iters=10)
    live = sum(lens)
    nbytes = (2 * live * GEMMA_H * GEMMA_D * pools[0][0].element_size()
              + 2 * q.numel() * 4 + tab.numel() * 4 + sl.numel() * 4)
    flops = 4 * live * GEMMA_H * GEMMA_D
    mem_s, op_s = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    row["bound_ms"] = max(mem_s, op_s) * 1e3
    row["bound_by"] = "bytes" if mem_s >= op_s else "operations"
    del pools
    torch.cuda.empty_cache()
    return name, row


def phase_d256(att, dev, kernels):
    """The D 256 instances of K3 and K4 at Gemma-7B's widths: each
    kernel's row goes into its entry of ``kernels`` under "d256"."""
    rows = d256_flash_rows(att, dev)
    for cache in (torch.float32, torch.bfloat16):
        name, row = d256_paged_row(att, dev, cache)
        rows[name] = row
    log("d256_timing " + json.dumps(rows))
    for k in kernels:
        if k["name"] in rows:
            k["d256"] = rows[k["name"]]


# -- phase 16: the KVStore and the gradient allreduce -----------------------
# bench.py's gluon ResNet-50 v1 through gluon.Trainer over the port's
# kvstore: 2 workers at batch 64 each, through 1 parameter server
# (dist_sync) on this card, 3 steps with the optimizer on the server
# (update_on_kvstore) and 3 on the workers; then one worker over
# torch.distributed (dist_device_sync, -s 0: NCCL at world size 1)
DIST_BATCH, DIST_STEPS = 64, 3
# bench.py _bench_allreduce's payload: 25M f32, about one ResNet-50
# gradient
ALLREDUCE_ELEMS = 25 * 1000 * 1000
DIST_JOB_TIMEOUT_S = 180


def params_digest(params):
    """sha256 of the trainable parameters' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for p in params:
        h.update(p.data()._data.detach().contiguous().cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def dist_worker(mode, out_dir):
    """The program of the dist phase's workers (``--dist-worker MODE
    DIR``, started by mxnet_tpu_torch/tools/launch.py): ResNet-50 v1 on
    the card from ``gluon_resnet``'s seeded weights, one seeded batch of
    DIST_BATCH per worker, DIST_STEPS Trainer steps. ``ps_true`` /
    ``ps_false``: kvstore dist_sync with update_on_kvstore True / False;
    ``coll``: dist_device_sync beside a kvstore="device" Trainer from the
    same weights on the same batch, cuDNN deterministic, and the
    allreduce bandwidth. Writes DIR/MODE_WORKER.json."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wid = int(os.environ["DMLC_WORKER_ID"])
    ctx = mx.gpu(0)
    dev = ctx.device
    if mode == "coll":
        # the two Trainers' steps must be the same bits: no
        # nondeterministic cuDNN algorithm
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    rng = np.random.default_rng(SEED + 60 + wid)
    x = mx.nd.array(rng.standard_normal((DIST_BATCH,) + GLUON_SHAPE[1:],
                                        dtype=np.float32), ctx=ctx)
    y = mx.nd.array(rng.integers(0, 1000, DIST_BATCH).astype(np.float32),
                    ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nets = {"dist": gluon_resnet(mx, None, ctx)[0]}
    if mode == "coll":
        nets["device"] = gluon_resnet(mx, None, ctx)[0]
    trainable = {k: [p for p in n.collect_params().values()
                     if p.grad_req != "null"] for k, n in nets.items()}
    kvtype = "dist_device_sync" if mode == "coll" else "dist_sync"
    trainers = {"dist": mx.gluon.Trainer(
        nets["dist"].collect_params(), "sgd", GLUON_SGD, kvstore=kvtype,
        update_on_kvstore=mode != "ps_false")}
    if mode == "coll":
        trainers["device"] = mx.gluon.Trainer(
            nets["device"].collect_params(), "sgd", GLUON_SGD,
            kvstore="device")
    res = {"mode": mode, "worker": wid, "digests": {k: [] for k in nets},
           "step_ms": [], "losses": []}
    # the kvstore's push and pull, timed on the host (a pull ends with the
    # values written on the card) with the bytes each moves
    comm = {"push_s": 0.0, "pull_s": 0.0, "push_bytes": 0, "pull_bytes": 0}

    def wrap(kv):
        for op in ("push", "pull"):
            fn = getattr(kv, op)

            def timed(key, value=None, *a, _fn=fn, _op=op, **kw):
                t0 = time.perf_counter()
                r = _fn(key, value, *a, **kw)
                if _op == "pull" and dev.type == "cuda":
                    torch.cuda.synchronize()
                comm[_op + "_s"] += time.perf_counter() - t0
                v = kw.get("out") if value is None else value
                v = v[0] if isinstance(v, (list, tuple)) else v
                comm[_op + "_bytes"] += v.size * 4
                return r
            setattr(kv, op, timed)

    total = DIST_BATCH * (1 if mode == "coll" else 2)
    for step in range(DIST_STEPS):
        for k, net in nets.items():
            t0 = time.perf_counter()
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            if k == "dist" and step == 0:
                res["loss0"] = float(loss._data.float().mean())
                if mode == "ps_true":
                    # the worker's own step-1 gradients and the weights
                    # before, for the summed-gradient check
                    torch.save({"grads": [p.grad()._data.detach().cpu()
                                          for p in trainable[k]],
                                "weights": [p.data()._data.detach().cpu()
                                            for p in trainable[k]]},
                               os.path.join(out_dir, f"grads_{wid}.pt"))
            tr = trainers[k]
            if tr._kvstore is None and k == "dist":
                # the kvstore made as step() makes it (the optimizer it
                # ships scaled for the batch), then its push and pull timed
                tr._optimizer.rescale_grad = tr._scale / total
                tr._init_kvstore()
                wrap(tr._kvstore)
            t1 = time.perf_counter()
            tr.step(total)
            torch.cuda.synchronize()
            if k == "dist":
                res["step_ms"].append((time.perf_counter() - t0) * 1e3)
                res["trainer_step_ms"] = (time.perf_counter() - t1) * 1e3
                res["losses"].append(float(loss._data.float().mean()))
            res["digests"][k].append(params_digest(trainable[k]))
        if mode == "ps_true" and step == 0:
            torch.save([p.data()._data.detach().cpu()
                        for p in trainable["dist"]],
                       os.path.join(out_dir, f"step1_{wid}.pt"))
    res["comm"] = comm
    res["params"] = sum(p.data().size for p in trainable["dist"])
    res["tensors"] = len(trainable["dist"])
    kv = trainers["dist"]._kvstore
    res["rank"], res["num_workers"] = kv.rank, kv.num_workers
    if mode == "coll":
        res["backend"] = kv._coll.backend
        # bench.py _bench_allreduce at n = 1: raw 2 x bytes / s of one
        # rank's allreduce (no bus bandwidth at one rank), CUDA events
        buf = torch.ones(ALLREDUCE_ELEMS, device=dev)
        for _ in range(3):
            kv._coll.allreduce(buf)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        iters = 10
        start.record()
        for _ in range(iters):
            kv._coll.allreduce(buf)
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / iters / 1e3
        res["allreduce"] = {"elems": ALLREDUCE_ELEMS, "ranks": 1,
                            "ms": sec * 1e3,
                            "gb_per_s": 2 * ALLREDUCE_ELEMS * 4 / sec / 1e9}
    kv.close()
    with open(os.path.join(out_dir, f"{mode}_{wid}.json"), "w") as f:
        json.dump(res, f)
    return 0


def dist_job(here, out, mode, workers, servers):
    """One job of the port's launcher: ``workers`` processes running
    ``dist_worker(mode)`` and ``servers`` parameter servers (their
    optimizer on this card); (the workers' results, the job's output)."""
    cmd = [sys.executable, os.path.join(here, "mxnet_tpu_torch", "tools",
                                        "launch.py"),
           "-n", str(workers), "-s", str(servers), sys.executable,
           os.path.join(here, "chip_smoke.py"), "--dist-worker", mode, out]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=DIST_JOB_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        fail(f"dist {mode}: the job ran over {DIST_JOB_TIMEOUT_S} s:\n"
             f"{e.stdout}\n{e.stderr}")
    log_text = p.stdout + p.stderr
    check(p.returncode == 0, f"dist {mode}: job exit {p.returncode}:\n"
          + log_text[-6000:])
    res = []
    for i in range(workers):
        with open(os.path.join(out, f"{mode}_{i}.json")) as f:
            res.append(json.load(f))
    return res, log_text, time.perf_counter() - t0


def server_line(log_text):
    """The server's closing line (``kvstore server: {...}``)."""
    for line in log_text.splitlines():
        if line.startswith("kvstore server: {"):
            return json.loads(line.split(": ", 1)[1])
    fail("dist: no closing line of the kvstore server in the job's output")


def phase_dist(here, dev):
    """dist_sync (1 server, 2 workers, all on this card) with the
    optimizer on the server, then on the workers; then dist_device_sync
    over NCCL at world size 1."""
    import mxnet_tpu_torch as mx
    out = os.path.join(here, "build", "chip_smoke", "dist")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    report = {}
    for mode in ("ps_true", "ps_false"):
        res, text, wall = dist_job(here, out, mode, 2, 1)
        srv = server_line(text)
        a, b = res
        check(sorted(r["rank"] for r in res) == [0, 1]
              and a["num_workers"] == 2, f"dist {mode}: ranks "
              f"{[r['rank'] for r in res]}")
        check(a["digests"]["dist"] == b["digests"]["dist"],
              f"dist {mode}: the workers' parameters differ after a step")
        check(all(np.isfinite(r["losses"]).all() for r in res),
              f"dist {mode}: losses {[r['losses'] for r in res]}")
        check(srv["device"].startswith("cuda"),
              f"dist {mode}: server optimizer on {srv['device']}")
        if mode == "ps_true":
            check(srv["updates"] == DIST_STEPS * a["tensors"],
                  f"dist {mode}: {srv['updates']} server updates, want "
                  f"{DIST_STEPS} x {a['tensors']}")
            # step 1 on the server: the SGD class on the sum of the two
            # workers' own gradients, from the weights before
            g = [torch.load(os.path.join(out, f"grads_{i}.pt")) for i in
                 range(2)]
            step1 = torch.load(os.path.join(out, "step1_0.pt"))
            opt = mx.optimizer.SGD(learning_rate=GLUON_SGD["learning_rate"],
                                   momentum=GLUON_SGD["momentum"],
                                   wd=GLUON_SGD["wd"],
                                   rescale_grad=1.0 / (2 * DIST_BATCH))
            worst = 0.0
            for i, (w0, g0, g1, got) in enumerate(zip(
                    g[0]["weights"], g[0]["grads"], g[1]["grads"], step1)):
                w = mx.nd.NDArray(w0.to(dev))
                opt.update(i, w, mx.nd.NDArray((g0 + g1).to(dev)),
                           opt.create_state(i, w))
                want = w._data.cpu()
                r = float((got - want).abs().max()
                          / want.abs().max().clamp_min(1e-30))
                worst = max(worst, r)
            check(worst <= PARITY_TENSOR_TOL, f"dist {mode}: step 1 off the "
                  f"SGD class on the summed gradients by {worst} of the "
                  f"largest (> {PARITY_TENSOR_TOL})")
            del g, step1
            for f in ("grads_0.pt", "grads_1.pt", "step1_0.pt", "step1_1.pt"):
                os.remove(os.path.join(out, f))
        step_ms = float(np.median([t for r in res for t in r["step_ms"]]))
        push_s = max(r["comm"]["push_s"] for r in res)
        pull_s = max(r["comm"]["pull_s"] for r in res)
        row = {"workers": 2, "servers": 1, "batch_per_worker": DIST_BATCH,
               "params": a["params"], "tensors": a["tensors"],
               "steps": DIST_STEPS, "step_ms": step_ms,
               "step_ms_all": [r["step_ms"] for r in res],
               "images_per_s": 2 * DIST_BATCH / step_ms * 1e3,
               "push_mb_per_s": a["comm"]["push_bytes"] / 1e6 / push_s,
               "pull_mb_per_s": a["comm"]["pull_bytes"] / 1e6 / pull_s,
               "comm": [r["comm"] for r in res],
               "server": srv, "job_s": wall,
               "losses": [r["losses"] for r in res],
               "bitwise_equal_workers": True}
        if mode == "ps_true":
            row["server_update_ms_per_step"] = srv["update_ms"] / DIST_STEPS
            row["step1_vs_sgd_on_sum"] = worst
        report[mode] = row
        log(f"dist_sync update_on_kvstore={mode == 'ps_true'}: "
            f"{json.dumps(row)}")
    res, text, wall = dist_job(here, out, "coll", 1, 0)
    c = res[0]
    check(c["backend"] == "nccl" and c["num_workers"] == 1,
          f"dist_device_sync: backend {c['backend']}, "
          f"{c['num_workers']} ranks")
    check(c["digests"]["dist"] == c["digests"]["device"],
          "dist_device_sync: its steps are not the device Trainer's bits")
    report["coll"] = {"workers": 1, "backend": c["backend"],
                      "step_ms": float(np.median(c["step_ms"])),
                      "step_ms_all": c["step_ms"], "job_s": wall,
                      "bitwise_equal_device_trainer": True,
                      "allreduce_one_rank": c["allreduce"]}
    log(f"dist_device_sync: {json.dumps(report['coll'])}")
    log("dist_train " + json.dumps({"card": card_line(), **report}))
    return report


# -- phase 17: the serving planes ------------------------------------------
# a lane is killed once one of its streams has decoded PLANES_KILL_AFTER
# tokens and has at least PLANES_KILL_BEFORE still to come, so the kill
# lands mid-stream
PLANES_KILL_AFTER, PLANES_KILL_BEFORE = 4, 8
# a position of a stream whose top-two logits are closer than this share
# of the top one's magnitude (at least 1) is recomputed the unpaged way
# (one forward over exactly that prefix): only there could a forward
# over the longer sequence round to another argmax
REF_MARGIN = 1e-3
PLANES_REPLICA_ROWS, PLANES_ONESHOT_REQUESTS = 4, 6
# the gateway's degraded-placement warning, counted over the phase
PLANES_WARNINGS = []


class _WarningCount(logging.Handler):
    def emit(self, record):
        if record.getMessage().startswith("serving: 2 replicas requested"):
            PLANES_WARNINGS.append(record.getMessage())


def planes_submit(gw, name, prompts, new):
    """The burst streamed, a consumer thread a request stamping each
    token's arrival (host monotonic ns). Returns (requests, stamps,
    consumer threads, errors by request index)."""
    reqs, stamps, threads, errors = [], [], [], {}

    def consume(i, req):
        try:
            for _ in req.stream():
                stamps[i].append(time.monotonic_ns())
        except Exception as e:  # noqa: BLE001 — read by the caller
            errors[i] = (e, time.monotonic_ns())

    for i, (p, n) in enumerate(zip(prompts, new)):
        req = gw.generate(name, p, max_new_tokens=int(n), stream=True)
        stamps.append([])
        th = threading.Thread(target=consume, args=(i, req), daemon=True)
        th.start()
        reqs.append(req)
        threads.append(th)
    return reqs, stamps, threads, errors


def planes_join(threads):
    for th in threads:
        th.join(timeout=600)
        check(not th.is_alive(), "stream consumer still running")


def planes_kill(gen, lane, cause):
    """Kill ``lane`` with ``GenLane.kill`` while one of its streams is
    mid-decode; returns the kill's host time (monotonic ns)."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        with gen.cond:
            mid = [r for r in lane.running
                   if len(r.tokens) >= PLANES_KILL_AFTER
                   and r.max_new_tokens - len(r.tokens) >= PLANES_KILL_BEFORE]
        if mid:
            t_kill = time.monotonic_ns()
            lane.kill(cause)
            return t_kill
        time.sleep(0.0005)
    fail(f"serving_planes: no stream of lane {lane.idx} seen mid-decode")


def planes_wait_finalized(lane):
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not lane.finalized:
        time.sleep(0.001)
    check(lane.finalized and lane.pool.closed and lane.pool.k is None,
          f"serving_planes: lane {lane.idx} not finalized")


def planes_calls(gen, lanes, layers, counts, bf16=False):
    """Hold the kernels' launch counts of a scenario to its lanes' step
    calls (finalized lanes included): K3 one a layer a prefill call
    (warmups, prefills, replays' re-prefills), K4 one a layer a decode
    call (warmups, batched steps, replays' batch-1 re-decodes)."""
    tot = {"prefill_calls": 0, "decode_calls": 0, "warmup_prefills": 0,
           "warmup_decodes": 0, "prefills": 0, "replays": 0,
           "decode_steps": 0, "replay_decodes": 0, "migrations": 0}
    for ln in lanes:
        tot["prefill_calls"] += ln.steps.prefills
        tot["decode_calls"] += ln.steps.decodes
        tot["warmup_prefills"] += len(gen.prompt_buckets)
        tot["warmup_decodes"] += len(gen.decode_buckets)
        for key in ("prefills", "replays", "decode_steps", "replay_decodes",
                    "migrations"):
            tot[key] += getattr(ln, key)
    check(tot["prefill_calls"] == tot["warmup_prefills"] + tot["prefills"]
          + tot["replays"] and tot["decode_calls"] == tot["warmup_decodes"]
          + tot["decode_steps"] + tot["replay_decodes"],
          f"serving_planes: step calls {tot}")
    paged = "paged_attention_bf16" if bf16 else "paged_attention"
    other = "paged_attention" if bf16 else "paged_attention_bf16"
    check(counts["flash_attention"] == tot["prefill_calls"] * layers
          and counts[paged] == tot["decode_calls"] * layers
          and counts[other] == 0 and counts["flash_attention_bf16"] == 0
          and counts[paged] > 0,
          f"serving_planes: launches {counts} against calls {tot} x "
          f"{layers} layers")
    return tot


def planes_recoveries(reqs, stamps, t_kill):
    """Recovery spans of the evacuated streams: modes, host ms of each
    migration (salvage on the dying lane to landing on the survivor) and
    each replay, migrated bytes, and the kill-to-next-token ms of each
    evacuated stream (its first token after its rescue landed)."""
    out = {"migrate_ms": [], "replay_ms": [], "land_call_ms": [],
           "migrated_bytes": [], "migrated_blocks": [], "next_token_ms": []}
    modes = set()
    for req, st in zip(reqs, stamps):
        for t0, t1, a in req.recover_spans:
            modes.add(a["mode"])
            out[f"{a['mode']}_ms"].append((t1 - t0) / 1e6)
            if a["mode"] == "migrate":
                out["migrated_bytes"].append(a["bytes_moved"])
                out["migrated_blocks"].append(a["blocks"])
                out["land_call_ms"].append(a["wall_ns"] / 1e6)
        if req.recover_spans:
            end = req.recover_spans[-1][1]
            nxt = [s for s in st if s >= end]
            check(nxt, "serving_planes: an evacuated stream emitted no "
                  "token after its rescue")
            out["next_token_ms"].append((nxt[0] - t_kill) / 1e6)
    summary = {"recovered_streams": len(out["next_token_ms"]),
               "modes": sorted(modes)}
    for key, vals in out.items():
        vals = sorted(vals)
        summary[key] = ({"n": len(vals), "p50": vals[len(vals) // 2],
                         "max": vals[-1]} if vals and key.endswith("ms")
                        else sum(vals) if vals else 0)
    return summary, modes


def reference_next(dec, params, toks):
    """``reference_generate``'s next token after ``toks``: one causal
    forward over exactly that prefix (plain attention, no cache)."""
    from mxnet_tpu_torch.serving.generate import model as gen_model
    x = gen_model._hidden_plain(params, torch.tensor(
        [toks], device=dec.device), dec.num_heads)
    return int(torch.argmax(gen_model._final_logits(params, x[0, -1])))


def verified_refs(dec, prompts, new, streams):
    """``reference_generate``'s tokens for each request, in fewer
    forwards: a position's logits depend on its prefix alone, so one
    causal forward over prompt + stream checks every emitted token's
    argmax at once. Where the top-two margin is under REF_MARGIN, that
    prefix is recomputed the old way (``reference_next``); from the
    first position that disagrees, or where the stream stopped short,
    the rest is generated the old way. Returns (references, counts)."""
    from mxnet_tpu_torch.serving.generate import model as gen_model
    stats = {"stream_forwards": 0, "recomputed": 0, "diverged": 0,
             "continued": 0}
    refs = []
    eos = dec.eos_id
    with torch.inference_mode():
        params = dec.param_tree()
        for p, n, got in zip(prompts, new, streams):
            toks = [int(t) for t in np.asarray(p).ravel()]
            got = [int(t) for t in got][:int(n)]
            ref, stopped = [], False
            if got:
                x = gen_model._hidden_plain(params, torch.tensor(
                    [toks + got[:-1]], device=dec.device), dec.num_heads)
                top = torch.topk(gen_model._final_logits(
                    params, x[0, len(toks) - 1:]), 2, dim=-1)
                stats["stream_forwards"] += 1
                args = top.indices[:, 0].tolist()
                vals = top.values.tolist()
                for j, want in enumerate(got):
                    t = args[j]
                    if vals[j][0] - vals[j][1] < REF_MARGIN * max(
                            abs(vals[j][0]), 1.0):
                        t = reference_next(dec, params, toks + ref)
                        stats["recomputed"] += 1
                    ref.append(t)
                    stopped = eos is not None and t == eos
                    if t != want:
                        stats["diverged"] += 1
                        break
                    if stopped:
                        break
            while len(ref) < int(n) and not stopped:
                t = reference_next(dec, params, toks + ref)
                stats["continued"] += 1
                ref.append(t)
                stopped = eos is not None and t == eos
            refs.append(ref)
    return refs, stats


def planes_kill_scenario(att, i8, fo, gw, dec, name, burst, refs,
                         plan=None):
    """Two lanes on the one card, lane 0 killed mid-stream (under fault
    plan ``plan`` when given): every stream equal to ``refs``, the dead
    lane's pool gone from the card, K4 still launching on the survivor,
    K3 / K4 launches equal to the lanes' step calls. Returns the printed
    row, the recovery modes, the migrator's totals and the launches."""
    plens, new, prompts = burst
    bf16 = dec.dtype == torch.bfloat16
    att.reset_launches()
    if plan:
        os.environ["MXNET_KVSTORE_FAULT_PLAN"] = plan
    try:
        gen = gw.register_generator(
            name, dec, block_tokens=BLOCK_TOKENS, max_blocks=MAX_BLOCKS,
            max_new_tokens=MAX_NEW, max_decode_batch=MAX_BATCH, replicas=2)
        check(gen.degraded and len(gen.lanes) == 2
              and len({str(ln.device) for ln in gen.lanes}) == 1,
              f"serving_planes {name}: two lanes not degraded onto one card")
        lanes = list(gen.lanes)
        pool = lanes[0].pool
        pool_bytes, block_bytes = pool.bytes_total, pool.bytes_per_block
        # no cyclic collection inside the window: one would free an
        # earlier scenario's garbage (a deleted decoder's parameters) on
        # the card and count it as the dead lane's pool
        gc.disable()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        reqs, stamps, threads, errors = planes_submit(gw, name, prompts, new)
        t_kill = planes_kill(gen, lanes[0], f"chip_smoke: {name} kill")
        decodes_at_kill = lanes[1].steps.decodes
        results = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        planes_join(threads)
        check(not errors, f"serving_planes {name}: stream errors {errors}")
        planes_wait_finalized(lanes[0])
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        gc.enable()
        counts = kernel_counts(att, i8, fo)
        mig = gen.stats()["recovery"]
        calls = planes_calls(gen, lanes, dec.num_layers, counts, bf16)
    finally:
        gc.enable()
        os.environ.pop("MXNET_KVSTORE_FAULT_PLAN", None)
        gw.unregister(name)
    if refs is not None:
        bad = [i for i, (r, w) in enumerate(zip(results, refs)) if r != w]
        check(not bad, f"serving_planes {name}: requests {bad} differ "
              "from reference_generate")
    rec, modes = planes_recoveries(reqs, stamps, t_kill)
    check(rec["recovered_streams"] >= 1, f"serving_planes {name}: the kill "
          "crossed no live stream")
    check(mig["bytes_moved"] == rec["migrated_bytes"]
          == rec["migrated_blocks"] * block_bytes
          and mig["migrations"] == rec["migrate_ms"]["n"]
          if rec["migrate_ms"] else mig["migrations"] == 0,
          f"serving_planes {name}: migrator {mig}, spans {rec}")
    check(lanes[1].steps.decodes > decodes_at_kill,
          f"serving_planes {name}: K4 stopped on the survivor")
    check(abs((mem0 - mem1) - pool_bytes) <= 2 ** 20,
          f"serving_planes {name}: memory_allocated fell by {mem0 - mem1} "
          f"bytes, the dead lane's pool is {pool_bytes}")
    gen_tokens = int(sum(new))
    paged = "paged_attention_bf16" if bf16 else "paged_attention"
    row = {"scenario": name, "fault_plan": plan,
           "tokens_per_s": gen_tokens / wall, "wall_s": wall,
           "generated_tokens": gen_tokens, "recovery": rec,
           "migrator": mig, "calls": calls,
           "launches": {"flash_attention": counts["flash_attention"],
                        paged: counts[paged]},
           "memory_freed_bytes": mem0 - mem1, "pool_bytes": pool_bytes}
    return row, modes, mig, counts, results


def planes_scale(att, i8, fo, gw, dec, burst, refs):
    """One lane, scaled to 3 while the first half of the burst decodes
    (the new lanes built and warmed on their own streams), the second
    half submitted, then scaled to 1 while streams run on the two new
    lanes: every stream equal to ``refs``, two pools released."""
    plens, new, prompts = burst
    half = len(prompts) // 2
    att.reset_launches()
    try:
        gen = gw.register_generator(
            "lm_scale", dec, block_tokens=BLOCK_TOKENS,
            max_blocks=MAX_BLOCKS, max_new_tokens=MAX_NEW,
            max_decode_batch=MAX_BATCH)
        torch.cuda.synchronize()
        mem_base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        first = planes_submit(gw, "lm_scale", prompts[:half], new[:half])
        t1 = time.perf_counter()
        out = gw.scale("lm_scale", 3)
        scale_out_s = time.perf_counter() - t1
        check(out["added"] == 2 and gw.replica_count("lm_scale") == 3,
              f"serving_planes scale out: {out}")
        lanes = list(gen.lanes)
        second = planes_submit(gw, "lm_scale", prompts[half:], new[half:])
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with gen.cond:
                busy = all(any(len(r.tokens) >= PLANES_KILL_AFTER
                               for r in ln.running) for ln in lanes[1:])
            if busy:
                break
            time.sleep(0.0005)
        check(busy, "serving_planes scale: the new lanes never decoded")
        t_in = time.monotonic_ns()
        t2 = time.perf_counter()
        back = gw.scale("lm_scale", 1)
        scale_in_s = time.perf_counter() - t2
        reqs = first[0] + second[0]
        results = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        for part in (first, second):
            planes_join(part[2])
            check(not part[3], f"serving_planes scale: errors {part[3]}")
        torch.cuda.synchronize()
        mem_end = torch.cuda.memory_allocated()
        counts = kernel_counts(att, i8, fo)
        calls = planes_calls(gen, lanes, dec.num_layers, counts)
        pool_bytes = lanes[0].pool.bytes_total
    finally:
        gw.unregister("lm_scale")
    check(back["retired"] == 2 and back["freed_bytes"] == 2 * pool_bytes
          and all(ln.finalized and ln.pool.k is None for ln in lanes[1:]),
          f"serving_planes scale in: {back}, pool {pool_bytes}")
    # idle before the scale-out and after the scale-in: the same one pool
    # (the new lanes' threads leave their cuBLAS workspaces, 32 MiB each)
    check(mem_end - mem_base <= pool_bytes // 16,
          f"serving_planes scale: memory_allocated {mem_end - mem_base} "
          f"bytes above the one-lane start, a pool is {pool_bytes}")
    bad = [i for i, (r, w) in enumerate(zip(results, refs)) if r != w]
    check(not bad, f"serving_planes scale: requests {bad} differ from "
          "reference_generate")
    rec, _ = planes_recoveries(reqs, first[1] + second[1], t_in)
    gen_tokens = int(sum(new))
    return {"scenario": "scale_1_3_1", "tokens_per_s": gen_tokens / wall,
            "wall_s": wall, "generated_tokens": gen_tokens,
            "scale_out_s": scale_out_s, "scale_in_s": scale_in_s,
            "freed_bytes": back["freed_bytes"],
            "memory_after_vs_before_bytes": mem_end - mem_base,
            "recovery": rec,
            "calls": calls,
            "launches": {k: counts[k] for k in ("flash_attention",
                                                "paged_attention")}}, counts


def planes_budget(att, i8, fo, gw, dec, burst):
    """MXTPU_GEN_MAX_RECOVERIES=0: the killed lane's token-holding
    streams end in a fast RejectedError(reason="lane_lost")."""
    from mxnet_tpu_torch.serving import RejectedError

    plens, new, prompts = burst
    os.environ["MXTPU_GEN_MAX_RECOVERIES"] = "0"
    try:
        gen = gw.register_generator(
            "lm_budget", dec, block_tokens=BLOCK_TOKENS,
            max_blocks=MAX_BLOCKS, max_new_tokens=MAX_NEW,
            max_decode_batch=MAX_BATCH, replicas=2)
    finally:
        os.environ.pop("MXTPU_GEN_MAX_RECOVERIES")
    try:
        check(gen.max_recoveries == 0, "serving_planes budget: knob unread")
        n = 8
        reqs, stamps, threads, errors = planes_submit(
            gw, "lm_budget", prompts[:n], new[:n])
        t_kill = planes_kill(gen, gen.lanes[0], "chip_smoke: budget kill")
        planes_join(threads)
        rejected = gen.lane_lost_rejections
    finally:
        gw.unregister("lm_budget")
    check(errors and all(isinstance(e, RejectedError)
                         and e.reason == "lane_lost"
                         for e, _ in errors.values())
          and rejected == len(errors),
          f"serving_planes budget: errors {errors}, {rejected} rejected")
    reject_ms = sorted((t - t_kill) / 1e6 for _, t in errors.values())
    check(reject_ms[-1] < 2000, f"serving_planes budget: lane_lost after "
          f"{reject_ms[-1]} ms")
    return {"scenario": "no_recovery_budget", "requests": n,
            "lane_lost": len(errors), "kill_to_reject_ms":
            {"p50": reject_ms[len(reject_ms) // 2], "max": reject_ms[-1]}}


def planes_oneshot(gw, here, rng):
    """Phase 10's exported ResNet-50 with two replicas on the one card:
    a fault injected into replica 0 drains it and its batch
    redistributes (replies bitwise the one-replica ones), check_health
    revives it, and scale 2 -> 3 -> 1 leaves one lane thread."""
    prefix = os.path.join(here, "build", "chip_smoke", "gluon_r50")
    shape = GLUON_SHAPE[1:]
    xs = [rng.standard_normal((PLANES_REPLICA_ROWS,) + shape,
                              dtype=np.float32)
          for _ in range(PLANES_ONESHOT_REQUESTS)]
    kw = dict(variants=("fp32",), buckets=(PLANES_REPLICA_ROWS,),
              max_wait_ms=0.0)
    t0 = time.perf_counter()
    gw.register_checkpoint("r50_one", prefix, 0, {"data": shape}, **kw)
    want = [gw.infer("r50_one", x)[0] for x in xs]
    gw.unregister("r50_one")
    gw.register_checkpoint("r50_two", prefix, 0, {"data": shape},
                           replicas=2, **kw)
    reg_s = time.perf_counter() - t0
    try:
        m = gw._get_model("r50_two")
        rep0, rep1 = m.replicas
        check(rep0.variant_set is not rep1.variant_set
              and rep0.variant_set._fns == rep1.variant_set._fns,
              "serving_planes one-shot: replicas do not share weights")
        release = threading.Event()
        run1 = rep1.variant_set.run

        def parked(variant, batch):
            release.wait(60)
            return run1(variant, batch)

        def broken(variant, batch):
            raise RuntimeError("chip_smoke: injected replica fault")

        run0 = rep0.variant_set.run
        rep1.variant_set.run = parked
        rep0.variant_set.run = broken
        t1 = time.perf_counter()
        reqs = []
        for x in xs:
            reqs.append(gw.submit("r50_two", x))
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and rep0.healthy \
                    and m.queue.depth():
                time.sleep(0.0005)
            if not rep0.healthy:
                break
        check(not rep0.healthy, "serving_planes one-shot: the fault never "
              "drained replica 0")
        release.set()
        rep1.variant_set.run = run1
        reqs += [gw.submit("r50_two", x) for x in xs[len(reqs):]]
        got = [r.result(timeout=120)[0] for r in reqs]
        redistribute_s = time.perf_counter() - t1
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              "serving_planes one-shot: redistributed replies differ from "
              "the one-replica replies")
        check(gw.health()["r50_two"] == [False, True]
              and max(r.attempts for r in reqs) == 2,
              f"serving_planes one-shot: health {gw.health()}")
        rep0.variant_set.run = run0
        check(gw.check_health("r50_two", revive=True)["r50_two"]
              == [True, True], "serving_planes one-shot: no revive")
        again = [gw.infer("r50_two", x)[0] for x in xs]
        check(all(np.array_equal(g, w) for g, w in zip(again, want)),
              "serving_planes one-shot: revived replies differ")
        up = gw.scale("r50_two", 3)
        down = gw.scale("r50_two", 1)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            lanes = [t for t in threading.enumerate()
                     if t.name.startswith("mxtpu-serve-r50_two-r")]
            if len(lanes) == 1:
                break
            for x in xs[:2]:      # wake parked lanes so they exit
                gw.infer("r50_two", x)
        check(len(lanes) == 1 and up["added"] == 1 and down["retired"] == 2,
              f"serving_planes one-shot: {len(lanes)} lane threads after "
              f"scale {up} {down}")
        st = gw.stats()["r50_two"]
    finally:
        gw.unregister("r50_two")
    return {"scenario": "oneshot_replicas", "requests": len(xs),
            "rows": PLANES_REPLICA_ROWS, "register_s": reg_s,
            "redistribute_s": redistribute_s,
            "failures": st["failures"], "replicas_after_scale": 1}


def phase_serving_planes(att, i8, fo, dev, burst, here, rng):
    """Several lanes per generator and per model on the one card, decode
    failover over K3 and K4, health probes with revival, and scale: see
    the module docstring's phase 17. Returns the phase's K3 / K4
    launches."""
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder
    from mxnet_tpu_torch.serving.generate import model as gen_model

    t_phase = time.perf_counter()
    plens, new, prompts = burst
    handler = _WarningCount()
    gw_log = logging.getLogger("mxnet_tpu_torch.serving.gateway")
    gw_log.addHandler(handler)
    dec = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                            num_layers=LAYERS, num_heads=HEADS,
                            max_prompt_tokens=MAX_PROMPT, device=dev,
                            seed=SEED)
    rows, totals = [], {"flash_attention": 0, "paged_attention": 0,
                        "paged_attention_bf16": 0}

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    gw = Gateway(devices=[dev])
    try:
        row, modes, mig, counts, got = planes_kill_scenario(
            att, i8, fo, gw, dec, "lm_kill", burst, None)
        # the references, checked against this scenario's streams
        t0 = time.perf_counter()
        refs, ref_stats = verified_refs(dec, prompts, new, got)
        ref_s = time.perf_counter() - t0
        # phase 21 serves the same decoder and burst
        RESULTS["burst_refs"] = refs
        bad = [i for i, (r, w) in enumerate(zip(got, refs)) if r != w]
        check(not bad, f"serving_planes lm_kill: requests {bad} differ "
              "from reference_generate")
        check("migrate" in modes and mig["migrations"] >= 1,
              f"serving_planes kill: no migration ({modes}, {mig})")
        rows.append(row)
        add(counts)
        row, modes, mig, counts, _ = planes_kill_scenario(
            att, i8, fo, gw, dec, "lm_storm", burst, refs,
            plan="replay_storm")
        check(modes == {"replay"} and mig["attempts"] == 0,
              f"serving_planes replay_storm: modes {modes}, {mig}")
        rows.append(row)
        add(counts)
        row, modes, mig, counts, _ = planes_kill_scenario(
            att, i8, fo, gw, dec, "lm_wedge", burst, refs,
            plan="migrate_wedge@round=1")
        check("replay" in modes and mig["wedged"] == 1,
              f"serving_planes migrate_wedge: modes {modes}, {mig}")
        rows.append(row)
        add(counts)
        row, counts = planes_scale(att, i8, fo, gw, dec, burst, refs)
        rows.append(row)
        add(counts)
        rows.append(planes_budget(att, i8, fo, gw, dec, burst))
        del dec
        # a bf16 pool: the killed run's tokens against the same survivor
        # lane with the plain paged attention (phase 13's rule)
        dec16 = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                                  num_layers=LAYERS, num_heads=HEADS,
                                  max_prompt_tokens=MAX_PROMPT, device=dev,
                                  seed=SEED, dtype="bfloat16")
        row, modes, mig, counts, got16 = planes_kill_scenario(
            att, i8, fo, gw, dec16, "lm_bf16", burst, None)
        check("migrate" in modes, f"serving_planes bf16: modes {modes}")
        add(counts)
        gw.register_generator("lm_plain16", dec16, block_tokens=BLOCK_TOKENS,
                              max_blocks=MAX_BLOCKS, max_new_tokens=MAX_NEW,
                              max_decode_batch=MAX_BATCH)
        paged = gen_model.paged_attention
        gen_model.paged_attention = att.paged_attention_plain
        try:
            want16 = [gw.generate("lm_plain16", p, max_new_tokens=int(n))
                      for p, n in zip(prompts, new)]
        finally:
            gen_model.paged_attention = paged
            gw.unregister("lm_plain16")
        bad = [i for i, (a, b) in enumerate(zip(got16, want16)) if a != b]
        check(not bad, f"serving_planes bf16: requests {bad} differ from "
              "the plain paged lane")
        row["equal_to_plain_paged_lane"] = len(got16)
        rows.append(row)
        del dec16
        rows.append(planes_oneshot(gw, here, rng))
    finally:
        gw.close()
        gw_log.removeHandler(handler)
    check(len(PLANES_WARNINGS) == 1, f"serving_planes: the degraded "
          f"placement of two lanes warned {len(PLANES_WARNINGS)} times, "
          "want once")
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log("serving_planes " + json.dumps({
        "card": card_line(), "phase_s": phase_s,
        "reference_generate_s": ref_s, "reference_forwards": ref_stats,
        "scenarios": rows,
        "launches": totals}))
    check(phase_s <= 60.0, f"serving_planes took {phase_s:.1f} s, over 60")
    return totals


# -- phase 18: the record input pipeline ------------------------------------
# ImageNet training's input at phase 8's batch: 256 x 256 JPEGs cropped
# at random to 224, mirrored at random, normalized by the ImageNet mean
# and std (example/image-classification's ImageRecordIter settings)
IO_BATCH, IO_SHAPE, IO_SRC_HW = 128, (3, 224, 224), 256
IO_MEAN, IO_STD = (123.68, 116.28, 103.53), (58.395, 57.12, 57.375)
IO_EPOCH_BATCHES_PER_WORKER = 4
IO_RESIDENT_STEPS = 6
IO_TIMEOUT_S = 60.0


def io_workers():
    """The decode workers the host's cores allow: all but two (the
    training loop and the feeder's thread keep theirs)."""
    return max(1, (os.cpu_count() or 4) - 2)


def io_records(mx, here, n, rng):
    """A seeded .rec / .idx of ``n`` JPEGs (256 x 256, quality 90: a
    smooth random image, bilinear from 8 x 8, plus one of four noise
    fields), labels i % 1000, encoded by a pool of threads (PIL releases
    the GIL) and written in order. Returns (path, seconds, mean
    bytes)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    t0 = time.perf_counter()
    d = os.path.join(here, "build", "chip_smoke", "records")
    os.makedirs(d, exist_ok=True)
    rec = os.path.join(d, "train.rec")
    noise = rng.normal(0, 12, (4, IO_SRC_HW, IO_SRC_HW, 3))
    bases = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
             for _ in range(n)]

    def jpeg(i):
        px = np.asarray(Image.fromarray(bases[i]).resize(
            (IO_SRC_HW, IO_SRC_HW), Image.BILINEAR), np.float64)
        px = np.clip(px + noise[i % 4], 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, format="JPEG", quality=90)
        return buf.getvalue()

    w = mx.recordio.MXIndexedRecordIO(os.path.join(d, "train.idx"), rec,
                                      "w")
    total = 0
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        for i, payload in enumerate(pool.map(jpeg, range(n))):
            total += len(payload)
            w.write_idx(i, mx.recordio.pack(
                mx.recordio.IRHeader(0, float(i % 1000), i, 0), payload))
    w.close()
    return rec, time.perf_counter() - t0, total / n


def io_iter_kwargs(rec, workers, **extra):
    return dict(path_imgrec=rec, data_shape=IO_SHAPE, batch_size=IO_BATCH,
                num_workers=workers, rand_crop=True, rand_mirror=True,
                shuffle=True, seed=SEED, mean_r=IO_MEAN[0],
                mean_g=IO_MEAN[1], mean_b=IO_MEAN[2], std_r=IO_STD[0],
                std_g=IO_STD[1], std_b=IO_STD[2], timeout=IO_TIMEOUT_S,
                **extra)


def io_crc(batch):
    """CRC-32 of a host batch's data and label bytes."""
    crc = zlib.crc32(np.ascontiguousarray(batch.data[0]._data.numpy()).data)
    return zlib.crc32(np.ascontiguousarray(batch.label[0]._data.numpy())
                      .data, crc)


def io_rate(mx, rec, workers, nbatches):
    """Images/s of the pipeline alone (CPU context, nothing trains, each
    batch dropped at once as a training loop drops it), from the first
    batch's arrival to the last's, and the parent's seconds in next()
    over that window."""
    with mx.cpu():
        it = mx.io.ImageRecordIter(**io_iter_kwargs(rec, workers))
        try:
            stamps, parent = [], []
            while len(stamps) < nbatches:
                try:
                    it.next()
                except StopIteration:
                    it.reset()
                    continue
                stamps.append(time.perf_counter())
                parent.append(io_parent(it))
            decoders = it.decoders()
        finally:
            it.close()
    rate = (nbatches - 1) * IO_BATCH / (stamps[-1] - stamps[0])
    return {"workers": workers, "images_per_s": rate,
            "images_per_s_per_worker": rate / workers,
            "batches": nbatches, "decoders": decoders,
            "window_s": stamps[-1] - stamps[0],
            "parent": {k: parent[-1][k] - parent[0][k] for k in parent[0]}}


def io_parent(it):
    """The pipeline parent's seconds in next() so far: blocked on a
    worker's slot, allocating the (pinned) host tensors, copying the
    slot into them; and the minor page faults during those copies."""
    return {"wait_s": it.wait_seconds, "alloc_s": it.alloc_seconds,
            "copy_s": it.copy_seconds, "copy_faults": it.copy_faults}


def io_epoch_crcs(mx, rec, workers, kill_after=None):
    """The CRCs of one epoch's batches, with two ring slots; with
    ``kill_after``, worker 0 SIGKILLed after that many batches (with two
    slots it cannot have decoded the rest of its epoch, so it must
    respawn). Returns (crcs, respawns)."""
    with mx.cpu():
        it = mx.io.ImageRecordIter(**io_iter_kwargs(rec, workers,
                                                    ring_batches=2))
        try:
            crcs = []
            for b in it:
                crcs.append(io_crc(b))
                if len(crcs) == kill_after:
                    proc = it._workers[0].proc
                    proc.send_signal(signal.SIGKILL)
                    proc.wait(timeout=30)
            return crcs, it.respawns
        finally:
            it.close()


def io_respawn(mx, rec, workers):
    """The epoch after a SIGKILL of worker 0 two batches in must be the
    undisturbed run's, batch for batch."""
    want_crcs, _ = io_epoch_crcs(mx, rec, workers)
    crcs, respawns = io_epoch_crcs(mx, rec, workers, kill_after=2)
    check(respawns == 1, f"the killed worker respawned {respawns} times")
    check(crcs == want_crcs, "the batches after a worker's respawn differ "
          "from the undisturbed run's")
    return {"killed_after_batches": 2, "respawns": respawns,
            "batches_equal": len(crcs)}


def phase_records(att, i8, fo, dev, here, rng):
    """The module docstring's phase 18: the record pipeline on the host,
    the device feeder to the card, and ResNet-50's Module.fit fed by it.
    No kernel of the port launches."""
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    before = kernel_counts(att, i8, fo)
    workers = io_workers()
    rec, write_s, jpeg_bytes = io_records(
        mx, here, IO_BATCH * workers * IO_EPOCH_BATCHES_PER_WORKER, rng)

    # the card's first two batches against the same iterator's on the CPU
    kw = io_iter_kwargs(rec, workers)
    feed = mx.io.PrefetchingIter(mx.io.ImageRecordIter(**kw),
                                 prefetch_to_device=True)
    try:
        card = [feed.next() for _ in range(2)]
        for b in card:
            for a in (b.data[0], b.label[0]):
                check(a._data.device == dev, f"a fed batch lies on "
                      f"{a._data.device}, not {dev}")
        card = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in card]
    finally:
        feed.feeder.close()
        feed.iters[0].close()
    with mx.cpu():
        it = mx.io.ImageRecordIter(**kw)
        try:
            host = [it.next() for _ in range(2)]
            host = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                    for b in host]
        finally:
            it.close()
    for (cd, cl), (hd, hl) in zip(card, host):
        check(cd.shape == (IO_BATCH,) + IO_SHAPE and np.isfinite(cd).all(),
              f"fed batch {cd.shape}")
        check(np.array_equal(cd, hd) and np.array_equal(cl, hl),
              "the card's batches differ from the CPU's")

    rates = {"1": io_rate(mx, rec, 1, 8),
             str(workers): io_rate(mx, rec, workers,
                                   IO_EPOCH_BATCHES_PER_WORKER * workers)}
    respawn = io_respawn(mx, rec, workers)

    # ResNet-50's Module.fit on the card, fed through the feeder
    rnet, _, r_arg, r_aux = train_net(mx, here)
    it = mx.io.ImageRecordIter(**kw)
    feed = mx.io.PrefetchingIter(it, prefetch_to_device=True)
    rmod = mx.mod.Module(rnet, context=mx.gpu(0))
    stamps, waits, parent = [], [], []

    def stamp(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        waits.append(feed.feeder.wait_seconds)
        parent.append(io_parent(it))

    opt = {"learning_rate": SGD_HYPER["lr"],
           "momentum": SGD_HYPER["momentum"], "wd": SGD_HYPER["wd"]}
    try:
        t0 = time.perf_counter()
        rmod.fit(feed, optimizer="sgd", optimizer_params=opt,
                 arg_params=r_arg, aux_params=r_aux, num_epoch=1,
                 eval_metric="acc", batch_end_callback=stamp)
        fit_s = time.perf_counter() - t0
        fed_items = feed.feeder.items
    finally:
        feed.feeder.close()
        it.close()
    steps = len(stamps)
    check(steps == len(it) == fed_items,
          f"fit took {steps} steps of a {len(it)}-batch epoch")
    out = rmod.get_outputs()[0]._data
    check(out.device == dev, f"the Module's outputs lie on {out.device}")
    fed_ms = float(np.median(np.diff(stamps))) * 1e3
    fed_mean_ms = (stamps[-1] - stamps[0]) / (steps - 1) * 1e3
    wait_share = (waits[-1] - waits[0]) / (stamps[-1] - stamps[0])
    # the parent's work (pull wait, pinned alloc, copy, the copy's page
    # faults) inside each step
    fed_parent = {k.replace("_s", "_ms") if k.endswith("_s") else k:
                  [(b[k] - a[k]) * (1e3 if k.endswith("_s") else 1)
                   for a, b in zip(parent, parent[1:])]
                  for k in parent[0]}

    # the same Module fed a batch already on the card
    with mx.gpu(0):
        xb = mx.io.DataBatch(data=[mx.nd.array(card[0][0])],
                             label=[mx.nd.array(card[0][1])])
    metric = mx.metric.create("acc")
    secs, losses = [], []
    for _ in range(IO_RESIDENT_STEPS):
        t0 = time.perf_counter()
        rmod.forward_backward(xb)
        rmod.update()
        rmod.update_metric(metric, xb.label)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(cross_entropy(rmod.get_outputs()[0]._data,
                                          xb.label[0]._data)))
    check(all(np.isfinite(losses)), f"ResNet-50 Module losses {losses}")
    resident_ms = float(np.median(secs[1:])) * 1e3
    resident_mean_ms = float(np.mean(secs[1:])) * 1e3
    after = kernel_counts(att, i8, fo)
    check(after == before, f"the record phase launched kernels of the "
          f"port: {before} -> {after}")
    phase_s = time.perf_counter() - t_phase
    main = {"card": card_line(), "workers": workers,
            "host_cpus": os.cpu_count(), "records": len(it) * IO_BATCH,
            "jpeg_mean_bytes": jpeg_bytes, "write_s": write_s,
            "card_vs_cpu_batches_bitwise": 2, "pipeline": rates,
            "respawn": respawn,
            "fit": {"batch": IO_BATCH, "steps": steps, "fit_s": fit_s,
                    "fed_step_ms": fed_ms,
                    "fed_step_ms_mean": fed_mean_ms,
                    "fed_step_ms_all": list(np.diff(stamps) * 1e3),
                    "fed_parent_all": fed_parent,
                    "fed_images_per_s": IO_BATCH / fed_mean_ms * 1e3,
                    "data_wait_share": wait_share,
                    "resident_step_ms": resident_ms,
                    "resident_step_ms_mean": resident_mean_ms,
                    "resident_step_ms_all": [t * 1e3 for t in secs],
                    "resident_losses": losses,
                    "phase8_executor_k2_step_ms":
                        RESULTS.get("resnet50_train_step_ms")},
            "phase_s": phase_s}
    log("record_pipeline " + json.dumps(main))
    check(phase_s <= 60.0, f"record_pipeline took {phase_s:.1f} s, over 60")
    del rmod, xb
    torch.cuda.empty_cache()


# -- phase 19: gluon.data ----------------------------------------------------
# gluon's ImageNet input over phase 18's records: a random mirror, the
# 224 center crop, ToTensor and the ImageNet mean and std in [0, 1] units
GD_MEAN, GD_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
GD_FED_STEPS = 6
GD_ONE_WORKER_BATCHES = 1
# "thread": the pool's per-item Python path (a batchify_fn keeps the
# native plan out); "native": the default loader, whose plan runs the
# libjpeg batch decoder where the host has libjpeg; "sharded":
# thread_pool=False, the sharded decode worker processes
GD_PATHS = ("thread", "native", "sharded")


def gd_records(mx, here, rng):
    """Phase 18's .rec / .idx, written anew where missing or of another
    size."""
    n = IO_BATCH * io_workers() * IO_EPOCH_BATCHES_PER_WORKER
    rec = os.path.join(here, "build", "chip_smoke", "records", "train.rec")
    idx = rec[:-len(".rec")] + ".idx"
    if os.path.exists(rec) and os.path.exists(idx):
        with open(idx) as f:
            if sum(1 for _ in f) == n:
                return rec
    return io_records(mx, here, n, rng)[0]


def gd_loader(mx, rec, path, batches=None, **kw):
    """DataLoader(batch 128, the decode workers phase 18 takes) over
    ImageRecordDataset(rec).transform_first(the ImageNet Compose), on one
    of GD_PATHS. ``batches``: the pool's paths read only the first that
    many batches in order (a pool stopped early still finishes the
    batches its threads hold); the sharded path takes its whole epoch."""
    T = mx.gluon.data.vision.transforms
    ds = mx.gluon.data.vision.ImageRecordDataset(rec).transform_first(
        T.Compose([T.RandomFlipLeftRight(), T.CenterCrop(IO_SHAPE[1]),
                   T.ToTensor(), T.Normalize(GD_MEAN, GD_STD)]))
    if path == "thread":
        kw["batchify_fn"] = mx.gluon.data.dataloader.default_batchify_fn
    if path == "sharded":
        kw["thread_pool"] = False
    elif batches is not None:
        kw["sampler"] = mx.gluon.data.SequentialSampler(batches * IO_BATCH)
    kw.setdefault("num_workers", io_workers())
    loader = mx.gluon.data.DataLoader(ds, batch_size=IO_BATCH, **kw)
    check((loader._native is None) == (path == "thread")
          and (loader._mp_config is not None) == (path == "sharded"),
          f"the {path} loader took another path")
    return loader


def gd_first(loader, n, stamps=None):
    """One pass of ``loader`` over ``n`` batches, each dropped as a
    training loop drops it but the first two, returned as numpy (data,
    label) after the pass; ``stamps`` gets each batch's arrival time."""
    kept = []
    it = iter(loader)
    try:
        for i, batch in enumerate(it):
            if stamps is not None:
                stamps.append(time.perf_counter())
            if i < 2:
                kept.append(batch)
            if i + 1 == n:
                break
    finally:
        it.close()
    return [(d.asnumpy(), lab.asnumpy()) for d, lab in kept]


def gd_host_rate(mx, rec, path):
    """One seeded pass of the path's loader on the CPU: its first two
    batches (numpy) and its images/s. The pool hands each thread a whole
    batch, so its first N batches arrive almost together, a round after
    the start: its rate runs from the start over N batches. The sharded
    workers fill their rings while the parent waits for the first batch:
    their rate runs from the first batch's arrival over GD_FED_STEPS."""
    n = io_workers()
    count = GD_FED_STEPS if path == "sharded" else n
    np.random.seed(SEED)
    stamps = []
    with mx.cpu():
        loader = gd_loader(mx, rec, path, count)
        t0 = time.perf_counter()
        host = gd_first(loader, count, stamps)
        decoders = (loader._mp_pipeline.decoders()
                    if loader._mp_pipeline is not None else None)
        loader.close()
    rate = ((count - 1) * IO_BATCH / (stamps[-1] - stamps[0])
            if path == "sharded" else count * IO_BATCH / (stamps[-1] - t0))
    return host, {"images_per_s": rate, "batches": count,
                  "first_batch_s": stamps[0] - t0, "decoders": decoders}


def gd_card_check(path, card, host):
    """The card's first two batches against the CPU's: the sharded
    workers draw their mirrors from the seed, so the same bits; the
    pool's threads draw them from numpy's global generator in no fixed
    order, so each image the CPU's bits or their exact mirror (the
    crop's margins are even)."""
    mirrored = 0
    for (cd, cl), (hd, hl) in zip(card, host):
        check(cd.shape == (IO_BATCH,) + IO_SHAPE and np.isfinite(cd).all(),
              f"gluon_data {path}: batch {cd.shape}")
        check(np.array_equal(cl, hl), f"gluon_data {path}: labels differ")
        if path == "sharded":
            check(np.array_equal(cd, hd), "gluon_data sharded: the card's "
                  "batches differ from the CPU's")
            continue
        for c, h in zip(cd, hd):
            same = np.array_equal(c, h)
            check(same or np.array_equal(c, h[:, :, ::-1]),
                  f"gluon_data {path}: an image is neither the CPU's nor "
                  "its mirror")
            mirrored += not same
    return "bitwise" if path == "sharded" else (
        f"bitwise up to the mirror draw ({mirrored} of {2 * IO_BATCH} "
        "images mirrored differently)")


def gd_card_batches(batches, dev, path):
    """The next two batches of ``batches`` (fed to the card) as numpy."""
    out = []
    for _ in range(2):
        x, y = next(batches)
        for a in (x, y):
            check(a._data.device == dev, f"gluon_data {path}: a fed batch "
                  f"lies on {a._data.device}")
        out.append((x.asnumpy(), y.asnumpy()))
    return out


def gd_steps(mx, net, trainer, loss_fn, batches, steps):
    """``steps`` gluon training steps (record -> forward -> loss ->
    backward -> Trainer.step, ended by a sync) after a warm one, each on
    the next (x, y) of ``batches``: the steps' ms, the ms each waited
    for its batch, and the losses."""
    secs, waits, losses = [], [], []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        x, y = next(batches)
        t1 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) * 1e3)
        waits.append((t1 - t0) * 1e3)
        losses.append(float(loss._data.detach().float().mean()))
    check(all(np.isfinite(losses)), f"gluon_data losses {losses}")
    return {"step_ms": float(np.median(secs[1:])),
            "step_ms_mean": float(np.mean(secs[1:])),
            "step_ms_all": secs[1:], "wait_ms_all": waits[1:],
            "data_wait_share": sum(waits[1:]) / sum(secs[1:]),
            "losses": losses}


def gd_fit_records(mx, rec):
    """The first batch a worker of ``rec``'s records (the record bytes
    copied), so that a sharded epoch is one batch a worker."""
    n = IO_BATCH * io_workers()
    src = mx.recordio.MXIndexedRecordIO(rec[:-len(".rec")] + ".idx", rec,
                                        "r")
    out = rec[:-len(".rec")] + "_fit.rec"
    dst = mx.recordio.MXIndexedRecordIO(out[:-len(".rec")] + ".idx", out,
                                        "w")
    for i in src.keys[:n]:
        dst.write_idx(i, src.read_idx(i))
    dst.close()
    src.close()
    return out


def gd_fit(mx, here, rec, dev):
    """DataLoaderIter over the sharded loader (through the feeder) for
    one short Module.fit epoch (a batch a worker) of phase 8's ResNet-50
    training symbol."""
    rnet, _, r_arg, r_aux = train_net(mx, here)
    loader = gd_loader(mx, gd_fit_records(mx, rec), "sharded",
                       prefetch_to_device=True)
    it = mx.contrib.io.DataLoaderIter(loader)
    mod = mx.mod.Module(rnet, context=mx.gpu(0))
    stamps = []

    def stamp(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    opt = {"learning_rate": SGD_HYPER["lr"],
           "momentum": SGD_HYPER["momentum"], "wd": SGD_HYPER["wd"]}
    try:
        t0 = time.perf_counter()
        mod.fit(it, optimizer="sgd", optimizer_params=opt,
                arg_params=r_arg, aux_params=r_aux, num_epoch=1,
                eval_metric="acc", batch_end_callback=stamp)
        fit_s = time.perf_counter() - t0
    finally:
        it.reset()
        loader.close()
    check(len(stamps) == len(loader), f"fit took {len(stamps)} steps of a "
          f"{len(loader)}-batch epoch")
    out = mod.get_outputs()[0]._data
    check(out.device == dev and bool(torch.isfinite(out).all()),
          "the Module's outputs after the fit")
    del mod
    return {"steps": len(stamps), "fit_s": fit_s,
            "first_step_s": stamps[0] - t0,
            "step_ms": float(np.median(np.diff(stamps))) * 1e3}


def phase_gluon_data(att, i8, fo, dev, here, rng):
    """The module docstring's phase 19: gluon.data's three loader paths
    on the host and through the device feeder, feeding phase 11's gluon
    ResNet-50 step, and DataLoaderIter under Module.fit. No kernel of
    the port launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native
    t_phase = time.perf_counter()
    before = kernel_counts(att, i8, fo)
    part_s = {}
    rec = gd_records(mx, here, rng)
    part_s["records"] = time.perf_counter() - t_phase
    host, paths = {}, {}
    for path in GD_PATHS:
        host[path], paths[path] = gd_host_rate(mx, rec, path)
    native_taken = _native.load_imgdec() is not None
    paths["native"]["plan"] = ("libjpeg batch decoder" if native_taken
                               else "libjpeg absent: Python path")
    # the pool at one thread: how far N threads scale past it
    with mx.cpu():
        stamps = []
        loader = gd_loader(mx, rec, "thread", GD_ONE_WORKER_BATCHES,
                           num_workers=1)
        t0 = time.perf_counter()
        gd_first(loader, GD_ONE_WORKER_BATCHES, stamps)
    paths["thread"]["images_per_s_one_worker"] = \
        GD_ONE_WORKER_BATCHES * IO_BATCH / (stamps[-1] - t0)
    np.random.seed(SEED)
    loader = gd_loader(mx, rec, "thread", 2, prefetch_to_device=True)
    it = iter(loader)
    try:
        paths["thread"]["card_vs_cpu"] = gd_card_check(
            "thread", gd_card_batches(it, dev, "thread"), host["thread"])
    finally:
        it.close()
    part_s["paths"] = time.perf_counter() - t_phase - part_s["records"]

    # phase 11's gluon ResNet-50 step fed through the feeder by the
    # default loader and by the sharded one (their first two batches the
    # card check), against the step on a batch already on the card
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    net, _ = gluon_resnet(mx, None, ctx)
    part_s["resnet_build"] = time.perf_counter() - t0
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD))
    x = mx.nd.array(np.random.default_rng(SEED).standard_normal(
        (IO_BATCH,) + IO_SHAPE, dtype=np.float32), ctx=ctx)
    y = mx.nd.array(np.arange(IO_BATCH) % 1000, ctx=ctx)
    # the resident steps first: their warm step takes the net's first
    # training step's set-up, which would hide a loader's wait
    resident = gd_steps(mx, net, trainer, loss_fn,
                        iter([(x, y)] * (GD_FED_STEPS + 1)), GD_FED_STEPS)
    fed = {}
    # the pool: 2N batches, all in flight from the start, so its second
    # round of N decodes while the timed steps run
    for path, count in (("native", 2 * io_workers()),
                        ("sharded", GD_FED_STEPS + 3)):
        np.random.seed(SEED)
        loader = gd_loader(mx, rec, path, count, prefetch_to_device=True)
        it = iter(loader)
        try:
            paths[path]["card_vs_cpu"] = gd_card_check(
                path, gd_card_batches(it, dev, path), host[path])
            fed[path] = gd_steps(mx, net, trainer, loss_fn, it, count - 3)
        finally:
            it.close()
            loader.close()
    part_s["steps"] = time.perf_counter() - t0 - part_s["resnet_build"]
    del net, trainer, x, y
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fit = gd_fit(mx, here, rec, dev)
    part_s["fit"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    after = kernel_counts(att, i8, fo)
    check(after == before, f"the gluon_data phase launched kernels of the "
          f"port: {before} -> {after}")
    phase_s = time.perf_counter() - t_phase
    log("gluon_data " + json.dumps({
        "card": card_line(), "batch": IO_BATCH, "workers": io_workers(),
        "host_cpus": os.cpu_count(), "native_plan_taken": native_taken,
        "paths": paths,
        "gluon_resnet50_step": {
            "fed": fed, "resident_step_ms": resident["step_ms"],
            "resident_step_ms_mean": resident["step_ms_mean"],
            "resident_step_ms_all": resident["step_ms_all"],
            "phase11_step_ms": RESULTS.get("gluon_train_step_ms")},
        "module_fit_dataloaderiter": fit, "phase_s": phase_s,
        "phase_part_s": part_s}))
    check(phase_s <= 60.0, f"gluon_data took {phase_s:.1f} s, over 60")


# -- phase 20: the SSD detector ---------------------------------------------
# examples/ssd (BASELINE config 4): 64 x 64 images of one solid rectangle
# whose class is its color channel, 2 classes, 5 pyramid levels of 4
# anchors a pixel (344 anchors), trained with SGD momentum as
# train_ssd.py trains it
SSD_CLASSES, SSD_IMG, SSD_BATCH, SSD_MAX_OBJECTS = 2, 64, 8, 8
SSD_SIZES = [(0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961)]
SSD_RATIOS = [(1.0, 2.0, 0.5)] * 5
SSD_ANCHORS = 344
SSD_PREFIX = "ssd0_"
SSD_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 5e-4}
SSD_RECORDS = 32 * SSD_BATCH
SSD_STEPS = 12


def ssd_class(mx):
    """examples/ssd/model.py's ``SSD`` written over ``mx``'s gluon (the
    port's): a small conv backbone (16 / 32 / 64), three 128-wide
    stages and a global pool, a class head and a box head a level.
    forward(x) -> (anchors (1, N, 4), cls_preds (B, N, C + 1),
    box_preds (B, N * 4))."""
    nn = mx.gluon.nn

    def down_block(channels):
        """Two conv + BN + relu, then a 2 x 2 pool: one pyramid step."""
        blk = nn.HybridSequential()
        for _ in range(2):
            blk.add(nn.Conv2D(channels, 3, padding=1, use_bias=False),
                    nn.BatchNorm(), nn.Activation("relu"))
        blk.add(nn.MaxPool2D(2, 2))
        return blk

    class SSD(mx.gluon.HybridBlock):
        def __init__(self, num_classes, base_channels=(16, 32, 64),
                     **kwargs):
            super().__init__(**kwargs)
            self.num_classes = num_classes
            napp = len(SSD_SIZES[0]) + len(SSD_RATIOS[0]) - 1
            with self.name_scope():
                self.stages = []
                base = nn.HybridSequential(prefix="base_")
                with base.name_scope():
                    for c in base_channels:
                        base.add(down_block(c))
                blocks = [base, down_block(128), down_block(128),
                          down_block(128)]
                self.cls_heads, self.box_heads = [], []
                for i, blk in enumerate(blocks + [None]):
                    if blk is not None:
                        setattr(self, f"stage{i}", blk)
                        self.stages.append(blk)
                    cls = nn.Conv2D(napp * (num_classes + 1), 3, padding=1,
                                    prefix=f"cls{i}_")
                    box = nn.Conv2D(napp * 4, 3, padding=1,
                                    prefix=f"box{i}_")
                    setattr(self, f"clshead{i}", cls)
                    setattr(self, f"boxhead{i}", box)
                    self.cls_heads.append(cls)
                    self.box_heads.append(box)

        def hybrid_forward(self, F, x):
            anchors, cls_preds, box_preds = [], [], []
            feat = x
            for i in range(len(self.cls_heads)):
                if i < len(self.stages):
                    feat = self.stages[i](feat)
                else:  # the last level: one global pixel
                    feat = F.Pooling(feat, global_pool=True, kernel=(1, 1),
                                     pool_type="max")
                anchors.append(F.MultiBoxPrior(feat, sizes=SSD_SIZES[i],
                                               ratios=SSD_RATIOS[i]))
                c = F.transpose(self.cls_heads[i](feat), axes=(0, 2, 3, 1))
                cls_preds.append(F.reshape(
                    c, shape=(0, -1, self.num_classes + 1)))
                b = F.transpose(self.box_heads[i](feat), axes=(0, 2, 3, 1))
                box_preds.append(F.reshape(b, shape=(0, -1)))
            return (F.concat(*anchors, dim=1), F.concat(*cls_preds, dim=1),
                    F.concat(*box_preds, dim=1))

    return SSD


def ssd_synth(rng, n):
    """train_ssd.py's ``synth_batch``: images (n, 3, 64, 64) of noise
    with one rectangle (+1 in the channel of its class), labels (n, 1,
    5) rows [cls, x1, y1, x2, y2] in normalized corners."""
    x = rng.normal(0.0, 0.05, (n, 3, SSD_IMG, SSD_IMG)).astype(np.float32)
    labels = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        cls = int(rng.integers(0, SSD_CLASSES))
        w = int(rng.integers(16, 40))
        h = int(rng.integers(16, 40))
        x0 = int(rng.integers(0, SSD_IMG - w))
        y0 = int(rng.integers(0, SSD_IMG - h))
        x[i, cls, y0:y0 + h, x0:x0 + w] += 1.0
        labels[i, 0] = [cls, x0 / SSD_IMG, y0 / SSD_IMG,
                        (x0 + w) / SSD_IMG, (y0 + h) / SSD_IMG]
    return x, labels


def ssd_step(mx, net, trainer, x, y):
    """train_ssd.py's training step: targets by MultiBoxTarget with
    3:1 hard negatives, softmax cross-entropy plus the masked L1 box
    loss, backward, one SGD step (none without a trainer). Returns
    (loss (B,), class targets)."""
    cls_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    l1_loss = mx.gluon.loss.L1Loss()
    with mx.autograd.record():
        anchors, cls_preds, box_preds = net(x)
        box_t, box_m, cls_t = mx.nd.MultiBoxTarget(
            anchors, y, mx.nd.transpose(cls_preds, axes=(0, 2, 1)),
            negative_mining_ratio=3.0)
        loss = cls_loss(cls_preds, cls_t) \
            + l1_loss(box_preds * box_m, box_t * box_m)
    loss.backward()
    if trainer is not None:
        trainer.step(x.shape[0])
    return loss, cls_t


def ssd_detect(mx, net, x):
    """train_ssd.py's predict: softmax over the classes, then
    MultiBoxDetection (NMS at 0.45, score threshold 0.01). Returns
    (detections (B, N, 6), class probabilities, box predictions,
    anchors)."""
    anchors, cls_preds, box_preds = net(x)
    probs = mx.nd.transpose(mx.nd.softmax(cls_preds, axis=-1),
                            axes=(0, 2, 1))
    dets = mx.nd.MultiBoxDetection(probs, box_preds, anchors,
                                   nms_threshold=0.45, threshold=0.01)
    return dets, probs, box_preds, anchors


def ssd_records(mx, here, rng):
    """SSD_RECORDS of ssd_synth's images (x 255 as HWC uint8 PNGs) with
    their box rows as vector labels: a .rec / .idx under build/."""
    from PIL import Image
    d = os.path.join(here, "build", "chip_smoke", "ssd")
    os.makedirs(d, exist_ok=True)
    rec = os.path.join(d, "train.rec")
    x, labels = ssd_synth(rng, SSD_RECORDS)
    w = mx.recordio.MXIndexedRecordIO(os.path.join(d, "train.idx"), rec, "w")
    for i in range(SSD_RECORDS):
        px = np.clip(x[i].transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, format="PNG")
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, labels[i].ravel(), i, 0),
            buf.getvalue()))
    w.close()
    return rec


def ssd_net(mx, weights, ctx):
    """The SSD on ``ctx`` with ``weights`` ({name: numpy}; None: zeros),
    shapes resolved without a forward, hybridized."""
    from mxnet_tpu_torch.gluon.block import infer_shapes
    net = ssd_class(mx)(SSD_CLASSES, prefix=SSD_PREFIX)
    net.initialize(mx.initializer.Zero(), ctx=ctx)
    infer_shapes(net, (1, 3, SSD_IMG, SSD_IMG))
    if weights is not None:
        for name, p in net.collect_params().items():
            p.set_data(torch.from_numpy(weights[name]))
    net.hybridize()
    return net


def ssd_grads(mx, net, x, y, trainer=None):
    """One ssd_step: (mean loss, class targets, {name: gradient},
    {name: weight after})."""
    params = net.collect_params()
    loss, cls_t = ssd_step(mx, net, trainer, x, y)
    return (float(loss.asnumpy().astype(np.float64).mean()), cls_t.asnumpy(),
            {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"},
            {n: p.data().asnumpy() for n, p in params.items()})


def ssd_parity(mx, weights, card_step, x_np, y_np):
    """The card's first step against the port's CPU step on the same
    batch and weights, at phase 11's fp32 bounds: the loss to 1e-5, each
    gradient and updated weight to 1e-4 of its largest value; a
    gradient past that (an ill-conditioned one) no further from the CPU
    f64 run than PARITY_STEM_RATIO times the CPU's own f32 run."""
    with mx.cpu():
        net = ssd_net(mx, weights, mx.cpu())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(SSD_SGD))
        cpu = ssd_grads(mx, net, mx.nd.array(x_np), mx.nd.array(y_np),
                        trainer)
        net64 = ssd_net(mx, weights, mx.cpu())
        net64.cast("float64")
        f64 = ssd_grads(mx, net64, mx.nd.array(x_np, dtype="float64"),
                        mx.nd.array(y_np, dtype="float64"))
    loss, cls_t, grads, updated = card_step
    check(np.array_equal(cls_t, cpu[1]), "ssd: the card's MultiBoxTarget "
          "class targets differ from the CPU's")
    check(np.array_equal(cls_t, f64[1]), "ssd: the f64 run's class targets "
          "differ")
    loss_rel = abs(loss - cpu[0]) / abs(cpu[0])
    check(loss_rel <= PARITY_LOSS_RTOL, f"ssd loss card {loss} vs CPU "
          f"{cpu[0]}")

    def rel(a, b):
        return float(np.abs(a.astype(np.float64) - b).max()
                     / max(np.abs(b).max(), 1e-30))

    worst, by_f64 = {}, {}
    for n, g in grads.items():
        r = rel(g, cpu[2][n])
        if r > PARITY_TENSOR_TOL:
            card_err, cpu_err = rel(g, f64[2][n]), rel(cpu[2][n], f64[2][n])
            check(card_err <= PARITY_STEM_RATIO * cpu_err,
                  f"ssd gradient {n}: card {card_err} vs CPU {cpu_err} of "
                  "the largest off the f64 run")
            by_f64[n] = {"card_vs_f64": card_err, "cpu_vs_f64": cpu_err}
        worst["grad"] = max(worst.get("grad", 0.0), r)
    for n, w in updated.items():
        r = rel(w, cpu[3][n])
        if n not in by_f64:
            check(r <= PARITY_TENSOR_TOL, f"ssd updated {n}: card vs CPU "
                  f"differ by {r} of the largest")
        worst["updated"] = max(worst.get("updated", 0.0), r)
    return {"loss_card": loss, "loss_cpu": cpu[0], "loss_f64": f64[0],
            "loss_rel": loss_rel, "grad_rel_max": worst["grad"],
            "updated_rel_max": worst["updated"], "tensors": len(grads),
            "grads_held_to_f64": by_f64}


def ssd_ties(mx, anchors):
    """MultiBoxTarget on the card and the CPU on ties: two equal ground
    truths (every matching round ties) and equal class scores (the
    mining sort ties): class targets and masks the same bits, box
    targets within 1e-6."""
    rng = np.random.default_rng(SEED + 21)
    n = anchors.shape[1]
    lab = np.full((4, 3, 5), -1, np.float32)
    lab[:, 0] = [0, 0.1, 0.1, 0.5, 0.6]
    lab[:, 1] = lab[:, 0]
    lab[2:, 2] = [1, 0.4, 0.3, 0.95, 0.9]
    cls = rng.random((4, SSD_CLASSES + 1, n)).astype(np.float32)
    cls[:, :, 20:80] = 0.5
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            outs.append([o.asnumpy() for o in mx.nd.MultiBoxTarget(
                mx.nd.array(anchors), mx.nd.array(lab), mx.nd.array(cls),
                negative_mining_ratio=3.0)])
    (cl, cm, cc), (hl, hm, hc) = outs
    check(np.array_equal(cm, hm) and np.array_equal(cc, hc),
          "ssd: MultiBoxTarget on ties differs between the card and CPU")
    err = float(np.abs(cl - hl).max())
    check(err <= 1e-6, f"ssd: tied box targets differ by {err}")
    return {"box_target_max_abs": err, "positives": int((cc > 0).sum())}


def phase_ssd(att, i8, fo, dev, here, rng):
    """The module docstring's phase 20: ImageDetIter into the SSD's
    training step on the card, its first step against the CPU, the
    detections against the CPU, and the detection ops' times. No kernel
    of the port launches."""
    import mxnet_tpu_torch as mx
    import random as pyrandom

    from mxnet_tpu_torch.ops.detection import decode_detections
    t_phase = time.perf_counter()
    before = kernel_counts(att, i8, fo)
    rec = ssd_records(mx, here, rng)
    ctx = mx.gpu(0)
    wrng = np.random.default_rng(SEED + 20)
    net = ssd_net(mx, None, ctx)
    weights = {n: seeded_value(n, p.shape, wrng)
               for n, p in net.collect_params().items()}
    net = ssd_net(mx, weights, ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SSD_SGD))
    pyrandom.seed(SEED)
    it = mx.image.ImageDetIter(
        batch_size=SSD_BATCH, data_shape=(3, SSD_IMG, SSD_IMG),
        path_imgrec=rec, shuffle=True, rand_crop=1, rand_mirror=True,
        max_objects=SSD_MAX_OBJECTS, mean=True, std=True)

    def batches():
        while True:
            for b in it:
                yield b.data[0], b.label[0]
            it.reset()

    feed = batches()
    x, y = next(feed)
    check(x._data.device == dev and x.shape == (SSD_BATCH, 3, SSD_IMG,
                                                  SSD_IMG)
          and y.shape == (SSD_BATCH, SSD_MAX_OBJECTS, 5),
          f"ImageDetIter batch {x.shape} {y.shape} on {x._data.device}")
    x_np, y_np = x.asnumpy(), y.asnumpy()
    first = ssd_grads(mx, net, x, y, trainer)
    parity = ssd_parity(mx, weights, first, x_np, y_np)

    # the training loop fed by ImageDetIter
    secs, waits, losses = [], [], [first[0]]
    for _ in range(SSD_STEPS):
        t0 = time.perf_counter()
        x, y = next(feed)
        t1 = time.perf_counter()
        loss, _ = ssd_step(mx, net, trainer, x, y)
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) * 1e3)
        waits.append((t1 - t0) * 1e3)
        losses.append(float(loss._data.detach().mean()))
    check(all(np.isfinite(losses)), f"ssd losses {losses}")

    # detections on the card against the CPU on the same inputs
    dets, probs, box_preds, anchors = ssd_detect(mx, net, x)
    with mx.cpu():
        want = mx.nd.MultiBoxDetection(
            mx.nd.array(probs.asnumpy()), mx.nd.array(box_preds.asnumpy()),
            mx.nd.array(anchors.asnumpy()), nms_threshold=0.45,
            threshold=0.01).asnumpy()
    got = dets.asnumpy()
    check(got.shape == (SSD_BATCH, SSD_ANCHORS, 6), f"detections {got.shape}")
    check(np.array_equal(got[..., :2], want[..., :2]), "ssd: the card's "
          "kept cls_id, scores or order differ from the CPU's")
    box_err = float(np.abs(got[..., 2:] - want[..., 2:]).max())
    check(box_err <= 1e-6, f"ssd: detection boxes differ by {box_err}")
    ties = ssd_ties(mx, anchors.asnumpy())

    # the detection ops' times at the path's shapes (host clock, each
    # call ended by a sync: box_nms reads one flag a sweep)
    raw = decode_detections(probs._data, box_preds._data, anchors._data)
    nms_s, _ = timed_forwards(lambda: mx.nd.box_nms(
        mx.nd.NDArray(raw), overlap_thresh=0.45, valid_thresh=0.0,
        coord_start=2, score_index=1, id_index=0), iters=20)
    det_s, _ = timed_forwards(lambda: mx.nd.MultiBoxDetection(
        probs, box_preds, anchors, nms_threshold=0.45, threshold=0.01),
        iters=20)
    tgt_s, _ = timed_forwards(lambda: mx.nd.MultiBoxTarget(
        anchors, y, probs, negative_mining_ratio=3.0), iters=20)
    after = kernel_counts(att, i8, fo)
    check(after == before, f"the ssd phase launched kernels of the port: "
          f"{before} -> {after}")
    phase_s = time.perf_counter() - t_phase
    log("ssd " + json.dumps({
        "card": card_line(), "classes": SSD_CLASSES, "image": SSD_IMG,
        "anchors": SSD_ANCHORS, "batch": SSD_BATCH, "records": SSD_RECORDS,
        "parameters": int(sum(w.size for w in weights.values())),
        "first_step_vs_cpu": parity, "steps": SSD_STEPS,
        "step_ms": float(np.median(secs)), "step_ms_all": secs,
        "data_wait_ms_all": waits,
        "data_wait_share": sum(waits) / sum(secs), "losses": losses,
        "detections_kept": int((got[..., 0] >= 0).sum()),
        "detection_box_max_abs_vs_cpu": box_err, "target_ties": ties,
        "box_nms_ms": nms_s * 1e3, "multibox_detection_ms": det_s * 1e3,
        "multibox_target_ms": tgt_s * 1e3, "phase_s": phase_s}))
    check(phase_s <= 60.0, f"ssd took {phase_s:.1f} s, over 60")
    del net, trainer
    torch.cuda.empty_cache()


# -- phase 21: the parallel layouts ------------------------------------------
# the one card holds every shard: a mesh (or a gateway) that lists cuda:0
# twice, the slice reported degraded
PAR_TP, PAR_SP = 2, 2
# tp_mlp at GPT-2 small's MLP widths over the LM's tokens (phase 12)
PAR_MLP_D, PAR_MLP_H = 768, 3072
# the JAX package's bound on a row-parallel sum's reassociation against
# one device (serving/sharded.py DIVERGENCE_BOUND), of the output's scale
PAR_DIVERGENCE = 5e-5


def parallel_generator(att, i8, fo, dev, burst, tp):
    """The burst served by ``Gateway.register_generator`` at phase 5's
    widths, on one lane of ``tp`` shards (all on ``dev``): the tokens,
    the row printed, the lane's step calls and the launches."""
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder

    plens, new, prompts = burst
    dec = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                            num_layers=LAYERS, num_heads=HEADS,
                            max_prompt_tokens=MAX_PROMPT, device=dev,
                            seed=SEED)
    name = f"lm_tp{tp}"
    att.reset_launches()
    gw = Gateway(devices=[dev] * tp)
    try:
        t0 = time.perf_counter()
        gen = gw.register_generator(
            name, dec, block_tokens=BLOCK_TOKENS, max_blocks=MAX_BLOCKS,
            max_new_tokens=MAX_NEW, max_decode_batch=MAX_BATCH,
            tp=tp if tp > 1 else None)
        warm_s = time.perf_counter() - t0
        lane = gen.lanes[0]
        st = gw.stats()[name]
        shard_bytes = [k.nbytes + v.nbytes for k, v in lane.pool.shards()]
        t0 = time.perf_counter()
        reqs, stamps, threads, errors = planes_submit(gw, name, prompts, new)
        results = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        planes_join(threads)
        check(not errors, f"parallel {name}: stream errors {errors}")
        torch.cuda.synchronize()
        counts = kernel_counts(att, i8, fo)
        calls = {"prefill": lane.steps.prefills, "decode": lane.steps.decodes}
    finally:
        gw.close()
    del dec
    tokens = int(sum(new))
    row = {"tp": st["tp"], "degraded": st["degraded"],
           "lane_device": st["lanes"][0]["device"],
           "tokens_per_s": tokens / wall, "wall_s": wall,
           "generated_tokens": tokens, "register_s": warm_s,
           "pool_bytes": sum(shard_bytes), "shard_bytes": shard_bytes,
           "step_calls": calls,
           "launches": {"flash_attention": counts["flash_attention"],
                        "paged_attention": counts["paged_attention"]}}
    check(counts["flash_attention"] == calls["prefill"] * LAYERS * tp
          and counts["paged_attention"] == calls["decode"] * LAYERS * tp
          and calls["prefill"] > 0 and calls["decode"] > 0
          and counts["flash_attention_bf16"] == 0
          and counts["paged_attention_bf16"] == 0,
          f"parallel {name}: launches {counts} against calls {calls} x "
          f"{LAYERS} layers x {tp} shards")
    return results, row


def parallel_attention(att, par, dev, dtype, gen):
    """Ulysses (K3 on each shard's heads) and ring attention at sp 2 over
    phase 12's LM shape, against ``flash_attention_plain`` on the whole
    heads; timed beside one K3 call over all the heads."""
    import functools

    mesh = par.create_mesh({"sp": PAR_SP}, devices=[dev] * PAR_SP)
    bf16 = dtype == torch.bfloat16
    key = "flash_attention_bf16" if bf16 else "flash_attention"
    # [B, T, H, D] as Ulysses takes it, and its [B, H, T, D] views
    q, k, v = (torch.randn((LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM),
                           generator=gen).to(dev, dtype) for _ in range(3))
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    spec = par.PartitionSpec(None, "sp", None, None)
    ulysses = par.shard_map(
        functools.partial(par.ulysses_attention, axis_name="sp",
                          causal=True), mesh, in_specs=(spec,) * 3,
        out_specs=spec)
    row = {"dtype": str(dtype).replace("torch.", ""),
           "shape": {"B": LM_BATCH, "H": LM_HEADS, "T": LM_SEQ,
                     "D": LM_HEAD_DIM, "causal": True, "sp": PAR_SP}}
    fl = att.flash_attention
    want_counts = (0, PAR_SP) if bf16 else (PAR_SP, 0)
    try:
        att.reset_launches()
        got_u = ulysses(q, k, v)
        torch.cuda.synchronize()
        check((fl.launches, fl.launches_bf16) == want_counts,
              f"ulysses {row['dtype']}: K3 launches (f32, bf16) "
              f"{(fl.launches, fl.launches_bf16)} in one call, want "
              f"{want_counts} (one a shard)")
        got_r = par.ring_attention_sharded(qh, kh, vh, mesh, axis="sp",
                                           causal=True)
        torch.cuda.synchronize()
        check((fl.launches, fl.launches_bf16) == want_counts,
              "ring attention launched K3 (it is plain ops, as in the JAX "
              "package)")
        launches = fl.launches_bf16 if bf16 else fl.launches
        # each shard's K3 call computes its heads' (Q tile, head, batch)
        # CTAs as the one-device call over every head does: bitwise equal
        one = att.flash_attention(qh, kh, vh, True)
        torch.cuda.synchronize()
        check(torch.equal(got_u.transpose(1, 2), one),
              f"ulysses {row['dtype']}: not bitwise equal to one K3 call "
              "over all the heads")
        want = att.flash_attention_plain(qh, kh, vh, causal=True)
        exact = att.flash_attention_plain(qh.double(), kh.double(),
                                          vh.double(), causal=True) \
            if bf16 else None
        for part, got in (("ulysses", got_u.transpose(1, 2)),
                          ("ring", got_r)):
            check(got.dtype == dtype and got.shape == want.shape,
                  f"{part} {row['dtype']}: {got.dtype} {tuple(got.shape)}")
            if bf16:
                ok, e = within(got, want, BF16_RTOL, BF16_ATOL)
                # and K3's f64 rule: no further (relative L2) from an f64
                # run on the same inputs than twice the plain bf16 version
                r_got, r_plain = rel_l2(got, exact), rel_l2(want, exact)
                check(r_got <= BF16_F64_RATIO * r_plain,
                      f"{part} bf16: {r_got:.3e} off f64, more than "
                      f"{BF16_F64_RATIO}x the plain bf16 version's "
                      f"{r_plain:.3e}")
                row[f"{part}_f64_ratio"] = r_got / r_plain
            else:
                e = (got - want).abs().max().item()
                ok = e <= FLASH_TOL
            check(ok, f"{part} {row['dtype']}: max abs err {e:.3e} off the "
                  "plain version, outside K3's bound")
            row[f"{part}_max_abs_err"] = e
        del got_u, got_r, want, exact, one
        row["ulysses_launches"] = launches
        row["ulysses_ms"], _ = measure(lambda: ulysses(q, k, v), iters=10,
                                       warmup=2)
        row["ring_ms"], _ = measure(lambda: par.ring_attention_sharded(
            qh, kh, vh, mesh, axis="sp", causal=True), iters=5, warmup=1)
        row["one_device_k3_ms"], _ = measure(
            lambda: att.flash_attention(qh, kh, vh, True), iters=10)
        row["plain_ms"], _ = measure(
            lambda: att.flash_attention_plain(qh, kh, vh, True), iters=3,
            warmup=1)
    finally:
        mesh.close()
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return row, key, launches


def parallel_mlp(par, dev, gen):
    """``tp_mlp`` at 768 / 3072 over the LM's 8 x 2048 tokens on a tp 2
    mesh of the one card, against the one-device MLP."""
    mesh = par.create_mesh({"tp": PAR_TP}, devices=[dev] * PAR_TP)
    rows = LM_BATCH * LM_SEQ
    x = torch.randn((rows, PAR_MLP_D), generator=gen).to(dev)
    w1 = (torch.randn((PAR_MLP_D, PAR_MLP_H), generator=gen)
          / PAR_MLP_D ** 0.5).to(dev)
    b1 = (0.1 * torch.randn(PAR_MLP_H, generator=gen)).to(dev)
    w2 = (torch.randn((PAR_MLP_H, PAR_MLP_D), generator=gen)
          / PAR_MLP_H ** 0.5).to(dev)
    b2 = (0.1 * torch.randn(PAR_MLP_D, generator=gen)).to(dev)
    P = par.PartitionSpec
    fn = par.shard_map(par.tp_mlp, mesh,
                       in_specs=(P(),) + tuple(par.tp_mlp_param_specs()),
                       out_specs=P())
    try:
        got = fn(x, w1, b1, w2, b2)
        want = F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(err <= PAR_DIVERGENCE * scale, f"tp_mlp: max abs err {err:.3e}"
              f" against one device, over {PAR_DIVERGENCE} of the scale "
              f"{scale:.3e}")
        row = {"rows": rows, "d": PAR_MLP_D, "hidden": PAR_MLP_H,
               "tp": PAR_TP, "max_abs_err": err, "scale": scale}
        row["ms"], _ = measure(lambda: fn(x, w1, b1, w2, b2), iters=10,
                               warmup=2)
        row["one_device_ms"], _ = measure(
            lambda: F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2,
            iters=10)
    finally:
        mesh.close()
    del x, w1, w2, got, want
    torch.cuda.empty_cache()
    return row


def phase_parallel(att, i8, fo, dev, burst, rng):
    """The module docstring's phase 21: the tp 2 generator against the
    tp 1 lane and ``reference_generate``, a tp 2 pool's shards on the
    card, Ulysses and ring attention at sp 2, and ``tp_mlp``; every
    shard on ``dev``. Returns the phase's K3 / K4 launches, by kernel
    and by part."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.serving.generate import (BlockPool,
                                                  GenerativeDecoder,
                                                  reference_generate)

    t_phase = time.perf_counter()
    plens, new, prompts = burst
    # the pool over a slice: each shard one K and one V tensor, half the
    # one-device pool's bytes, allocated on the card as it says
    one_pool = 2 * LAYERS * MAX_BLOCKS * BLOCK_TOKENS * HEADS * HEAD_DIM * 4
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    pool = BlockPool(LAYERS, HEADS, HEAD_DIM, BLOCK_TOKENS, MAX_BLOCKS,
                     device=(dev,) * PAR_TP)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    shard_bytes = [k.untyped_storage().nbytes() + v.untyped_storage().nbytes()
                   for k, v in pool.shards()]
    pool_bytes = pool.bytes_total
    pool.close()
    mem2 = torch.cuda.memory_allocated()
    check(pool_bytes == one_pool
          and shard_bytes == [one_pool // PAR_TP] * PAR_TP
          and abs(mem1 - mem0 - one_pool) <= 2 ** 20
          and abs(mem1 - mem2 - one_pool) <= 2 ** 20,
          f"parallel: a tp {PAR_TP} pool took {mem1 - mem0} bytes (freed "
          f"{mem1 - mem2}), shards {shard_bytes}; want {one_pool} in "
          f"{PAR_TP} equal shards")

    got2, row2 = parallel_generator(att, i8, fo, dev, burst, PAR_TP)
    got1, row1 = parallel_generator(att, i8, fo, dev, burst, 1)
    check(row2["tp"] == PAR_TP and row2["degraded"] is True
          and row2["lane_device"] == [str(dev)] * PAR_TP
          and row2["shard_bytes"] == [one_pool // PAR_TP] * PAR_TP,
          f"parallel: tp lane {row2}")
    bad = [i for i, (a, b) in enumerate(zip(got2, got1)) if a != b]
    check(not bad, f"parallel: tp {PAR_TP} requests {bad} differ from the "
          "tp 1 lane's")
    refs = RESULTS.get("burst_refs")
    pick = int(np.argsort(plens)[len(plens) // 2])
    dec = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                            num_layers=LAYERS, num_heads=HEADS,
                            max_prompt_tokens=MAX_PROMPT, device=dev,
                            seed=SEED)
    t0 = time.perf_counter()
    if refs is None:
        refs = [reference_generate(dec, p, int(n))
                for p, n in zip(prompts, new)]
    else:
        check(reference_generate(dec, prompts[pick], int(new[pick]))
              == refs[pick], "parallel: phase 17's references are not this "
              "decoder's")
    ref_s = time.perf_counter() - t0
    del dec
    bad = [i for i, (a, b) in enumerate(zip(got2, refs)) if a != b]
    check(not bad, f"parallel: tp {PAR_TP} requests {bad} differ from "
          "reference_generate")

    gen = torch.Generator().manual_seed(SEED + 21)
    attn = [parallel_attention(att, par, dev, dtype, gen)
            for dtype in (torch.float32, torch.bfloat16)]
    mlp = parallel_mlp(par, dev, gen)
    phase_s = time.perf_counter() - t_phase
    log("parallel " + json.dumps({
        "card": card_line(), "phase_s": phase_s,
        "reference_generate_s": ref_s,
        "pool": {"bytes": one_pool, "shard_bytes": shard_bytes,
                 "allocated": mem1 - mem0, "freed": mem1 - mem2},
        "generator": {"tp2": row2, "tp1": row1,
                      "tp2_over_tp1_tokens_per_s":
                          row2["tokens_per_s"] / row1["tokens_per_s"]},
        "attention": [row for row, _, _ in attn], "tp_mlp": mlp}))
    launches = {"flash_attention": {
                    "tp_prefill": row2["launches"]["flash_attention"],
                    "ulysses": attn[0][2]},
                "flash_attention_bf16": {"ulysses": attn[1][2]},
                "paged_attention": {
                    "tp_decode": row2["launches"]["paged_attention"]}}
    check(phase_s <= 120.0, f"parallel took {phase_s:.1f} s, over 120")
    return launches


# -- phase 22: data parallelism and ZeRO over the mesh ------------------------
# every position on the one card: a mesh that lists cuda:0 twice
DP_WAYS = 2
# the timed steps of each variant, after the compared one
DP_TIMED = 3
# ResNet-50 over a dp 2 mesh against one device: each group (outputs,
# gradients, the moving statistics' updates) no further (relative L2)
# from a float64 step than this times the one-device step (the f64 rule
# of phases 3 and 12)
DP_F64_RATIO = 2.0
# the serving slice's bound against the one-device lane (the JAX
# package's serving/sharded.py DIVERGENCE_BOUND, absolute)
DP_DIVERGENCE = 5e-5


def tree_leaves(tree, path=""):
    """``(path, leaf)`` pairs of a dict / list pytree, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tree_leaves(v, f"{path}/{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def gpt_params(rng):
    """Seeded numpy weights of phase 12's decoder widths (vocab 50304,
    12 x 768, MLP 4x), laid out as tools/layout_report.py lays them
    (q, k, v in one (3d, d) weight; the head apart from the embedding)."""
    d, ff = LM_D_MODEL, LM_FF * LM_D_MODEL

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def z(n, one=False):
        return np.full(n, 1.0 if one else 0.0, np.float32)

    layers = [{"ln1_g": z(d, True), "ln1_b": z(d), "qkv_w": w(3 * d, d),
               "qkv_b": z(3 * d), "proj_w": w(d, d), "proj_b": z(d),
               "ln2_g": z(d, True), "ln2_b": z(d), "ff1_w": w(ff, d),
               "ff1_b": z(ff), "ff2_w": w(d, ff), "ff2_b": z(d)}
              for _ in range(LM_LAYERS)]
    return {"embed_w": w(LM_VOCAB, d), "layers": layers,
            "lnf_g": z(d, True), "lnf_b": z(d), "head_w": w(LM_VOCAB, d)}


def gpt_loss(attend, checkpoint=False):
    """tools/layout_report.py's functional decoder loss over a params
    dict (the mean over the batch's tokens of the cross entropy of each
    token), its causal attention ``attend(q, k, v)`` on (B, H, T, D);
    ``checkpoint`` recomputes each layer in the backward (the float64
    reference's memory)."""
    def layer(x, lp):
        b, t, d = x.shape
        hd = d // LM_HEADS
        h = F.layer_norm(x, (d,), lp["ln1_g"], lp["ln1_b"], 1e-5)
        qkv = h @ lp["qkv_w"].T + lp["qkv_b"]
        q, k, v = (z.reshape(b, t, LM_HEADS, hd).transpose(1, 2)
                   for z in qkv.split(d, -1))
        a = attend(q, k, v)
        x = x + a.transpose(1, 2).reshape(b, t, d) @ lp["proj_w"].T \
            + lp["proj_b"]
        h = F.layer_norm(x, (d,), lp["ln2_g"], lp["ln2_b"], 1e-5)
        return x + torch.relu(h @ lp["ff1_w"].T + lp["ff1_b"]) \
            @ lp["ff2_w"].T + lp["ff2_b"]

    def loss_fn(params, tokens):
        x = params["embed_w"][tokens]
        for lp in params["layers"]:
            x = torch.utils.checkpoint.checkpoint(
                layer, x, lp, use_reentrant=False) if checkpoint \
                else layer(x, lp)
        d = x.shape[-1]
        h = F.layer_norm(x, (d,), params["lnf_g"], params["lnf_b"], 1e-5)
        logits = h @ params["head_w"].T
        picked = logits.gather(-1, tokens[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - picked).mean()
    return loss_fn


def gpt_f64_grads(att, params, tokens, dev):
    """The float64 loss and gradients of the step's loss at the seeded
    weights (plain attention, each layer recomputed in the backward),
    as the mean of the two half batches' (what fits the card)."""
    loss_fn = gpt_loss(lambda q, k, v: att.flash_attention_plain(
        q, k, v, causal=True), checkpoint=True)
    def on_card(tree):
        if isinstance(tree, dict):
            return {k: on_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [on_card(v) for v in tree]
        return torch.from_numpy(tree).to(dev, torch.float64) \
            .requires_grad_(True)

    names = [path for path, _ in tree_leaves(params)]
    loss, grads = 0.0, None
    for half in tokens.chunk(2):
        p = on_card(params)
        value = loss_fn(p, half)
        g = torch.autograd.grad(value, [x for _, x in tree_leaves(p)])
        loss += value.item() / 2
        grads = [x / 2 for x in g] if grads is None \
            else [a + x / 2 for a, x in zip(grads, g)]
        del p, value, g
    return loss, dict(zip(names, grads))


def position_bytes(tree):
    """Each position's stored bytes of a tree of Sharded leaves."""
    leaves = [x for _, x in tree_leaves(tree)]
    return [sum(x.shards.flat[i].untyped_storage().nbytes() for x in leaves)
            for i in range(leaves[0].shards.size)]


def zero_variant(att, par, dev, name, params, tokens, loss_fn):
    """One step of a variant from the seeded weights (what the phase
    compares: the loss, the momentum after it, which is the step's
    combined gradient, the parameters and each position's bytes), then
    DP_TIMED timed steps."""
    ways = 1 if name == "dp1" else DP_WAYS
    mesh = par.create_mesh({"dp": ways}, devices=[dev] * ways)
    P = par.PartitionSpec
    kw = dict(lr=LM_LR, momentum=0.9)
    try:
        if name.startswith("zero"):
            step, p, s = par.make_zero_train_step(
                loss_fn, mesh, params, tokens, batch_specs=P("dp"),
                stage=int(name[-1]), **kw)
        else:
            step, p, s = par.make_sharded_train_step(
                loss_fn, mesh, params, tokens, batch_specs=P("dp"), **kw)
        torch.cuda.synchronize()
        att.reset_launches()
        t0 = time.perf_counter()
        p, s, loss = step(p, s, tokens)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = (att.flash_attention.launches,
                    att.flash_attention_bwd.launches)
        row = {"ways": ways, "first_step_ms": first_ms,
               "collectives": step.last_collectives,
               "flash_launches": list(launches),
               "specs": {k: str(s[k].spec) for k in ("embed_w", "head_w")},
               "param_spec_embed": str(p["embed_w"].spec),
               "momentum_position_bytes": position_bytes(s),
               "param_position_bytes": position_bytes(p)}
        got = {"loss": loss.clone(),
               "momentum": {k: x.full() for k, x in tree_leaves(s)},
               "params": {k: x.full() for k, x in tree_leaves(p)}}
        secs = []
        for _ in range(DP_TIMED):
            t0 = time.perf_counter()
            p, s, _ = step(p, s, tokens)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) * 1e3)
        row["step_ms_all"] = secs
        row["step_ms"] = float(np.median(secs))
        row["tokens_per_s"] = tokens.numel() / row["step_ms"] * 1e3
    finally:
        mesh.close()
    del p, s
    torch.cuda.empty_cache()
    return row, got


def zero_compare(a, b):
    """(bitwise, max abs difference) of two variants' losses, momenta
    and parameters."""
    same, err = bool(torch.equal(a["loss"], b["loss"])), \
        abs(a["loss"].item() - b["loss"].item())
    for part in ("momentum", "params"):
        for k, x in a[part].items():
            y = b[part][k]
            same = same and bool(torch.equal(x, y))
            err = max(err, (x - y).abs().max().item())
    return same, err


def f64_ratios(got, ref, exact):
    """Phase 12's fp32 rule: each combined gradient's relative L2
    distance from the float64 step, over the reference variant's; the
    worst (ratio, leaf)."""
    return max((rel_l2(got["momentum"][k], g)
                / max(rel_l2(ref["momentum"][k], g), 1e-300), k)
               for k, g in exact.items())


def dp_zero(att, par, dev, rng):
    """(a): the dp 1 step, the replicated dp 2 step and ZeRO stages 1-3
    at GPT-2 small's widths over (8, 2048) tokens, from one set of seeded
    weights, beside the float64 step."""
    from mxnet_tpu_torch.parallel import zero_shard_leaf

    params = gpt_params(rng)
    tokens = torch.from_numpy(rng.integers(
        0, LM_VOCAB, (LM_BATCH, LM_SEQ))).to(dev)
    t0 = time.perf_counter()
    f64_loss, exact = gpt_f64_grads(att, params, tokens, dev)
    f64_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    loss_fn = gpt_loss(lambda q, k, v: att.flash_attention(q, k, v, True))
    rows, got = {}, {}
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    for name in ("dp1", "dp2", "zero1", "zero2", "zero3"):
        rows[name], got[name] = zero_variant(att, par, dev, name, params,
                                             tokens, loss_fn)
        fwd, bwd = rows[name]["flash_launches"]
        ways = rows[name]["ways"]
        check(fwd == bwd == ways * LM_LAYERS,
              f"data_parallel {name}: K3 forward / backward launches "
              f"{fwd} / {bwd} in a step, want {ways} x {LM_LAYERS}")
        launches["flash_attention"] += fwd
        launches["flash_attention_bwd"] += bwd
        if name == "dp1":
            del got[name]["params"]
        elif name != "dp2":
            # the stages change the layout, not the arithmetic: the
            # replicated step's bits expected, else phase 12's rule
            same, err = zero_compare(got[name], got["dp2"])
            ratio, leaf = f64_ratios(got[name], got["dp1"], exact)
            rows[name].update({"bitwise_equal_to_dp2": same,
                               "max_abs_diff_vs_dp2": err,
                               "f64_ratio_vs_dp1": ratio})
            check(same or ratio <= LM_F64_RATIO,
                  f"data_parallel {name}: differs from the replicated dp 2 "
                  f"step by {err:.3e}, and {leaf} is {ratio:.3f}x dp 1's "
                  f"distance from the f64 step")
            del got[name]
    loss_rel = abs(got["dp2"]["loss"].item() - got["dp1"]["loss"].item()) \
        / abs(got["dp1"]["loss"].item())
    ratio, leaf = f64_ratios(got["dp2"], got["dp1"], exact)
    check(loss_rel <= LM_LOSS_RTOL and ratio <= LM_F64_RATIO,
          f"data_parallel: dp 2 against dp 1: loss {loss_rel:.3e} relative "
          f"(bound {LM_LOSS_RTOL}); {leaf}'s gradient {ratio:.3f}x dp 1's "
          f"relative L2 distance from the f64 step (bound {LM_F64_RATIO})")
    dp1_rel = max(rel_l2(got["dp1"]["momentum"][k], g)
                  for k, g in exact.items())
    # each position's momentum: half the replicated bytes for the leaves
    # zero_shard_leaf shards
    sharded = {path for path, x in tree_leaves(params)
               if zero_shard_leaf(x, DP_WAYS)}
    full = sum(x.nbytes for path, x in tree_leaves(params)
               if path in sharded)
    rest = sum(x.nbytes for path, x in tree_leaves(params)
               if path not in sharded)
    check(rows["dp2"]["momentum_position_bytes"] == [full + rest] * DP_WAYS,
          f"data_parallel dp2: momentum bytes "
          f"{rows['dp2']['momentum_position_bytes']}")
    for name in ("zero1", "zero2", "zero3"):
        want = [full // DP_WAYS + rest] * DP_WAYS
        check(rows[name]["momentum_position_bytes"] == want,
              f"data_parallel {name}: momentum bytes a position "
              f"{rows[name]['momentum_position_bytes']}, want {want}")
    check(rows["zero3"]["param_position_bytes"]
          == [full // DP_WAYS + rest] * DP_WAYS,
          f"data_parallel zero3: parameter bytes a position "
          f"{rows['zero3']['param_position_bytes']}")
    out = {"config": {"vocab": LM_VOCAB, "d_model": LM_D_MODEL,
                      "layers": LM_LAYERS, "heads": LM_HEADS,
                      "batch": LM_BATCH, "seq": LM_SEQ, "dtype": "float32",
                      "sgd": {"lr": LM_LR, "momentum": 0.9},
                      "parameters": sum(x.size for _, x in
                                        tree_leaves(params))},
           "sharded_leaf_bytes": full, "replicated_leaf_bytes": rest,
           "f64_loss": f64_loss, "f64_step_s": f64_s,
           "dp2_vs_dp1_loss_rel": loss_rel,
           "dp2_f64_ratio_vs_dp1_max": ratio,
           "dp2_f64_ratio_vs_dp1_max_leaf": leaf,
           "dp1_grad_rel_l2_vs_f64_max": dp1_rel, "variants": rows}
    del got, params, tokens, exact
    torch.cuda.empty_cache()
    return out, launches


def r50_group_rel(a, b):
    return rel_l2(torch.cat([x.reshape(-1).double() for x in a]),
                  torch.cat([x.reshape(-1).double() for x in b]))


def r50_step(ex, data, label, aux0, timed):
    """One training forward and backward of an executor; its outputs,
    gradients and moving-statistic updates (as float64 on the card),
    then ``timed`` more steps' ms."""
    out = ex.forward(is_train=True, data=data, softmax_label=label)[0]
    ex.backward()
    res = {"out": [out._data.double()],
           "grads": [g._data.double() for _, g in sorted(
               ex.grad_dict.items()) if _ not in ("data", "softmax_label")],
           "aux": [ex.aux_dict[n]._data.double() - aux0[n].double()
                   for n in sorted(aux0)]}
    torch.cuda.synchronize()
    secs = []
    for _ in range(timed):
        t0 = time.perf_counter()
        ex.forward(is_train=True, data=data, softmax_label=label)
        ex.backward()
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) * 1e3)
    return res, secs


def dp_executor(mx, par, dev, rng):
    """(b): the model-zoo ResNet-50 v1 symbol at batch 128, one training
    step over a dp 2 mesh (the batch through ``PrefetchingIter
    (sharding=)``) against one device and a float64 step."""
    base = mx.model_zoo.load_symbol("resnet50_v1")
    net = mx.sym.SoftmaxOutput(base, name="softmax")
    arg_np, aux_np = resnet_params(base, rng)
    x = rng.standard_normal(R50_SHAPE, dtype=np.float32)
    y = rng.integers(0, 1000, R50_SHAPE[0]).astype(np.float32)
    shapes = {"data": R50_SHAPE, "softmax_label": (R50_SHAPE[0],)}
    req = {n: "null" if n in shapes else "write"
           for n in net.list_arguments()}
    ctx = mx.Context(dev)
    aux0 = {n: torch.from_numpy(v).to(dev) for n, v in aux_np.items()}
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    ex = net.simple_bind(ctx, grad_req=req, **shapes)
    ex.copy_params_from(arg_np, aux_np)
    one, one_ms = r50_step(ex, xd, yd, aux0, DP_TIMED)
    del ex
    torch.cuda.empty_cache()

    mesh = par.create_mesh({"dp": DP_WAYS}, devices=[dev] * DP_WAYS)
    P = par.PartitionSpec
    try:
        ex = net.simple_bind(grad_req=req, mesh=mesh, arg_specs={
            "data": P("dp"), "softmax_label": P("dp")}, **shapes)
        ex.copy_params_from(arg_np, aux_np)
        with ctx:
            it = mx.io.PrefetchingIter(
                mx.io.NDArrayIter(x, y, batch_size=R50_SHAPE[0],
                                  label_name="softmax_label"),
                sharding=par.NamedSharding(mesh, P("dp")))
            batch = it.next()
        it.feeder.close()
        data, label = batch.data[0], batch.label[0]
        check(isinstance(data, par.Sharded)
              and [tuple(b.shape) for b in data.shards.flat]
              == [(R50_SHAPE[0] // DP_WAYS,) + R50_SHAPE[1:]] * DP_WAYS,
              f"data_parallel: the prefetched batch is not laid out over "
              f"the mesh: {type(data).__name__}")
        bits = bool(torch.equal(data.full(), xd)
                    and torch.equal(label.full(), yd))
        check(bits, "data_parallel: the sharded batch is not the bits of "
              "the unsharded batch")
        dp2, dp2_ms = r50_step(ex, data, label, aux0, DP_TIMED)
        check(ex._sharded["data"] is data,
              "data_parallel: the executor did not take the Sharded batch "
              "in place")
        del ex
    finally:
        mesh.close()
    torch.cuda.empty_cache()

    f64 = {n: torch.from_numpy(v).to(dev, torch.float64)
           for n, v in {**arg_np, **aux_np}.items()}
    ex = net.bind(ctx, args={**{n: f64[n] for n in arg_np},
                             "data": xd.double(),
                             "softmax_label": yd.double()},
                  aux_states={n: f64[n] for n in aux_np}, grad_req=req)
    exact, _ = r50_step(ex, xd.double(), yd.double(), aux0, 0)
    del ex, f64
    torch.cuda.empty_cache()
    groups = {}
    for g in ("out", "grads", "aux"):
        r_one = r50_group_rel(one[g], exact[g])
        r_dp2 = r50_group_rel(dp2[g], exact[g])
        groups[g] = {"dp2_vs_f64": r_dp2, "one_vs_f64": r_one,
                     "dp2_vs_one": r50_group_rel(dp2[g], one[g]),
                     "ratio": r_dp2 / max(r_one, 1e-300)}
        check(r_dp2 <= DP_F64_RATIO * r_one,
              f"data_parallel executor: {g} {r_dp2:.3e} off the f64 step "
              f"(relative L2), more than {DP_F64_RATIO}x the one-device "
              f"step's {r_one:.3e}")
    return {"batch": R50_SHAPE[0], "ways": DP_WAYS,
            "sharded_batch_bitwise": bits, "groups": groups,
            "dp2_step_ms": float(np.median(dp2_ms)), "dp2_step_ms_all": dp2_ms,
            "one_step_ms": float(np.median(one_ms)), "one_step_ms_all": one_ms}


def dp_serving(mx, dev, rng):
    """(c): ResNet-50 v1 one-shot serving over a tp 2 slice of the card
    against a one-device lane, fp32 and bf16, a 64-request burst each."""
    from mxnet_tpu_torch.serving import DIVERGENCE_BOUND, Gateway

    base = mx.model_zoo.load_symbol("resnet50_v1")
    arg_np, aux_np = resnet_params(base, rng)
    rows = rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1, SERVE_REQUESTS)
    xs = [rng.standard_normal((int(r),) + R50_SHAPE[1:], dtype=np.float32)
          for r in rows]
    variants = ("fp32", "bf16")
    out, replies = {}, {}
    for tp, gw in ((1, Gateway(device=dev)),
                   (DP_WAYS, Gateway(devices=[dev] * DP_WAYS))):
        try:
            t0 = time.perf_counter()
            m = gw.register("r50tp", base, arg_np, aux_np,
                            {"data": R50_SHAPE[1:]}, variants=variants,
                            buckets=SERVE_BUCKETS,
                            max_wait_ms=SERVE_MAX_WAIT_MS,
                            tp=tp if tp > 1 else None)
            row = {"register_s": time.perf_counter() - t0,
                   "stats_tp": gw.stats()["r50tp"]["tp"],
                   "degraded": gw.stats()["r50tp"]["degraded"]}
            for v in variants:
                replies[(tp, v)], row[v] = serve_burst(gw, xs, v, "r50tp")
            if tp > 1:
                vs = m.replicas[0].variant_set
                rep = vs.placement_report()
                row["position_bytes"] = vs.position_bytes()
                row["report_per_device_bytes"] = rep["per_device_param_bytes"]
                row["report_total_bytes"] = rep["total_bytes"]
                row["sharded_params"] = [r["param"] for r in rep["params"]
                                         if r["shard_ways"] > 1]
                check(row["position_bytes"]
                      == [rep["per_device_param_bytes"]] * tp,
                      f"data_parallel serving: position bytes "
                      f"{row['position_bytes']} against the report's "
                      f"{rep['per_device_param_bytes']}")
                check(row["stats_tp"] == tp and row["degraded"] is True,
                      f"data_parallel serving: stats {row}")
        finally:
            gw.close()
        out[f"tp{tp}"] = row

    def dist(a, b):
        return max(float(np.abs(x.astype(np.float64) - z).max())
                   for x, z in zip(a, b))

    fp32 = dist(replies[(DP_WAYS, "fp32")], replies[(1, "fp32")])
    bf16 = dist(replies[(DP_WAYS, "bf16")], replies[(1, "fp32")])
    bf16_one = dist(replies[(1, "bf16")], replies[(1, "fp32")])
    check(DIVERGENCE_BOUND == DP_DIVERGENCE and fp32 <= DP_DIVERGENCE,
          f"data_parallel serving: tp 2 fp32 {fp32:.3e} off the one-device "
          f"lane, past {DP_DIVERGENCE}")
    check(bf16 <= 2 * bf16_one,
          f"data_parallel serving: tp 2 bf16 {bf16:.3e} off the fp32 lane, "
          f"past twice the one-device bf16 lane's {bf16_one:.3e}")
    out.update({"requests": SERVE_REQUESTS, "fp32_max_abs_vs_one": fp32,
                "bf16_max_abs_vs_fp32": bf16,
                "one_bf16_max_abs_vs_fp32": bf16_one,
                "tp2_over_tp1_images_per_s": {
                    v: out[f"tp{DP_WAYS}"][v]["images_per_s"]
                    / out["tp1"][v]["images_per_s"] for v in variants}})
    for row in (out["tp1"], out[f"tp{DP_WAYS}"]):
        for v in variants:
            row[v] = {k: row[v][k] for k in ("images", "images_per_s",
                                             "p50_ms", "max_ms", "batches")}
    return out


def phase_data_parallel(att, i8, fo, dev, rng):
    """The module docstring's phase 22: sharded train steps (ZeRO 1-3,
    K3 on each position's shard) at GPT-2 small's widths, the executor
    over a dp mesh at ResNet-50's, and one-shot serving over a tp slice;
    every position on ``dev``. Returns the phase's K3 launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel as par

    t_phase = time.perf_counter()
    zero, launches = dp_zero(att, par, dev, rng)
    counts1 = kernel_counts(att, i8, fo)
    executor = dp_executor(mx, par, dev, rng)
    serving = dp_serving(mx, dev, rng)
    check(kernel_counts(att, i8, fo) == counts1,
          "data_parallel: a kernel launched in the executor or serving part "
          "(ResNet-50 reaches none)")
    phase_s = time.perf_counter() - t_phase
    log("data_parallel " + json.dumps({
        "card": card_line(), "phase_s": phase_s, "zero": zero,
        "executor": executor, "serving": serving}))
    check(phase_s <= 60.0, f"data_parallel took {phase_s:.1f} s, over 60")
    return {"flash_attention": {"zero_steps": launches["flash_attention"]},
            "flash_attention_bwd": {
                "zero_steps": launches["flash_attention_bwd"]}}


OBS_REQUESTS = 8
OBS_LM_STEPS = 3
OBS_TIMED = 2           # LM steps timed a turn
OBS_COST_PAIRS = 3      # off / on turns of the cost measurements
OBS_MONITOR_BATCHES = 2
# the JAX package's span attributes of a generation
OBS_GENERATE_ATTRS = {
    "serving.generate": {"model", "lane", "prompt_tokens", "new_tokens",
                         "recoveries", "queue_cause", "finish"},
    "generate.prefill": {"prompt_tokens", "pad_tokens", "queue_ns",
                         "kv_wait_ns", "exec_ns"},
    "generate.token": {"index", "interleave_ns", "rows", "bucket"}}


def obs_planes(mx, on):
    """Both planes on (telemetry, every trace sampled) or off (what
    MXTPU_TELEMETRY=0 and MXTPU_TRACE_SAMPLE=0 set), recorded state
    cleared."""
    mx.telemetry.set_enabled(on)
    mx.tracing.set_sample(1.0 if on else 0.0)
    mx.telemetry.registry().reset()
    mx.tracing.reset()


def sync_count(fn):
    """(fn(), the synchronizing CUDA calls it made): the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``, from every thread."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in seen)


def obs_burst(gw, lane, prompts, new):
    """The requests through ``Gateway.generate``, all admitted at once:
    the lane takes none until every one is queued, so every run decodes
    the same batches. Returns (tokens, wall s from the release)."""
    go = threading.Event()
    pop = lane._pop_admissions
    lane._pop_admissions = lambda: pop() if go.is_set() else []
    try:
        reqs = [gw.generate("lm", p, max_new_tokens=int(n), stream=True)
                for p, n in zip(prompts, new)]
        t0 = time.perf_counter()
        go.set()
        out = [r.result(timeout=300) for r in reqs]
        return out, time.perf_counter() - t0
    finally:
        del lane._pop_admissions


def obs_generate_trees(spans, plens, new):
    """Each request's span tree: one ``serving.generate`` root, one
    ``generate.prefill`` and one ``generate.token`` a new token under it,
    with the JAX package's attributes."""
    roots = [s for s in spans if s["name"] == "serving.generate"]
    check(all(s["parent"] is None for s in roots),
          "observability: a serving.generate span has a parent")
    check(sorted((s["attrs"]["prompt_tokens"], s["attrs"]["new_tokens"])
                 for s in roots) == sorted(zip(map(int, plens),
                                               map(int, new))),
          "observability: serving.generate roots do not match the burst")
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    for s in spans:
        want = OBS_GENERATE_ATTRS.get(s["name"])
        check(want is None or set(s["attrs"]) == want,
              f"observability: {s['name']} attrs {sorted(s['attrs'])}")
    for r in roots:
        names = [k["name"] for k in kids.get(r["span"], [])]
        check(names.count("generate.prefill") == 1
              and names.count("generate.token")
              == r["attrs"]["new_tokens"]
              and len(names) == 1 + r["attrs"]["new_tokens"],
              f"observability: request spans {sorted(set(names))}")
    return len(roots)


def obs_run(mx, att, gw, lane, on, prompts, new):
    """One burst with the planes on or off: its tokens and a record of
    its wall time, tokens/s and K3 / K4 launches."""
    obs_planes(mx, on)
    att.reset_launches()
    got, wall = obs_burst(gw, lane, prompts, new)
    return got, {"planes": on, "requests": len(prompts), "wall_s": wall,
                 "tokens_per_s": int(sum(new)) / wall,
                 "flash_launches": att.flash_attention.launches,
                 "paged_launches": att.paged_attention.launches}


def obs_serving(mx, att, dev, burst):
    """Phase 5's decoder serving the burst's first OBS_REQUESTS through
    the planes (spans, counters, launches) and again with them off
    (launches, tokens); a serving call's sync counts on and off; then
    the whole burst off and on in OBS_COST_PAIRS turns (tokens/s)."""
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder

    all_plens, all_new, all_prompts = burst
    plens, new = all_plens[:OBS_REQUESTS], all_new[:OBS_REQUESTS]
    prompts = all_prompts[:OBS_REQUESTS]
    dec = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                            num_layers=LAYERS, num_heads=HEADS,
                            max_prompt_tokens=MAX_PROMPT, device=dev,
                            seed=SEED)
    gw = Gateway(device=dev)
    out = {"requests": OBS_REQUESTS, "new_tokens": int(sum(new))}
    try:
        gen = gw.register_generator(
            "lm", dec, block_tokens=BLOCK_TOKENS, max_blocks=MAX_BLOCKS,
            max_new_tokens=MAX_NEW, max_decode_batch=MAX_BATCH)
        lane = gen.lanes[0]
        tokens, checked = obs_run(mx, att, gw, lane, True, prompts, new)
        spans = mx.tracing.spans_snapshot()
        out["spans"] = obs_generate_trees(spans, plens, new)
        out["span_count"] = len(spans)
        reg = mx.telemetry.registry()
        counted = {
            "requests": reg.value("mx_serving_generate_requests_total",
                                  model="lm"),
            "prefill_tokens": reg.value("mx_serving_generate_tokens_total",
                                        model="lm", phase="prefill"),
            "decode_tokens": reg.value("mx_serving_generate_tokens_total",
                                       model="lm", phase="decode")}
        want = {"requests": OBS_REQUESTS, "prefill_tokens": int(sum(plens)),
                "decode_tokens": int(sum(new)) - OBS_REQUESTS}
        check(counted == want, f"observability: mx_serving_* counters "
              f"{counted}, want {want}")
        out["counters"] = counted
        got, off = obs_run(mx, att, gw, lane, False, prompts, new)
        out["runs"] = [checked, off]
        check(got == tokens, "observability: the burst's tokens differ "
              "with the planes off")
        flash_n, paged_n = checked["flash_launches"], checked["paged_launches"]
        check((off["flash_launches"], off["paged_launches"])
              == (flash_n, paged_n), f"observability: K3 / K4 launches "
              f"differ with the planes on and off: {out['runs']}")
        check(flash_n == OBS_REQUESTS * LAYERS and paged_n > 0,
              f"observability: burst launches K3 {flash_n}, K4 {paged_n}")
        syncs = {}
        for on in (True, False):
            obs_planes(mx, on)
            _, syncs[on] = sync_count(lambda: gw.generate(
                "lm", prompts[0], max_new_tokens=int(new[0])))
        check(syncs[True] == syncs[False], f"observability: a serving call "
              f"synchronizes {syncs[True]} times with the planes on, "
              f"{syncs[False]} off")
        out["serving_call_syncs"] = syncs[True]
        out["launches"] = {"flash_attention": flash_n,
                           "paged_attention": paged_n}
        cost, full = [], None
        for on in (False, True) * OBS_COST_PAIRS:
            got, run = obs_run(mx, att, gw, lane, on, all_prompts, all_new)
            check(full is None or got == full, "observability: the whole "
                  "burst's tokens differ between turns")
            full = got
            cost.append(run)
        check(len({(r["flash_launches"], r["paged_launches"])
                   for r in cost}) == 1, "observability: the whole burst's "
              f"launches differ between turns: {cost}")
        out["cost_runs"] = cost
    finally:
        gw.close()
    return out


def obs_training(mx, att, i8, fo, dev, rng, here):
    """Phase 12's decoder-LM step under the planes and the profiler:
    OBS_LM_STEPS counted steps after a warm one; step ms and sync counts
    with the planes on and off."""
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder

    ctx = mx.Context(dev)
    dec = GenerativeDecoder(vocab_size=LM_VOCAB, d_model=LM_D_MODEL,
                            num_layers=LM_LAYERS, num_heads=LM_HEADS,
                            ff_mult=LM_FF, max_prompt_tokens=LM_SEQ,
                            device=dev, seed=SEED)
    block = dec.block
    tokens = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ + 1))
    x = mx.nd.array(tokens[:, :-1].astype(np.int32), ctx=ctx)
    y = mx.nd.array(tokens[:, 1:].astype(np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(block.collect_params(), "adam",
                               {"learning_rate": LM_LR})

    def step():
        return lm_step(mx, block, loss_fn, x, y, trainer)

    obs_planes(mx, True)
    step()                       # warm: opens the first step interval
    torch.cuda.synchronize()
    mx.tracing.reset()
    profile_path = os.path.join(here, "build", "observability_profile.json")
    os.makedirs(os.path.dirname(profile_path), exist_ok=True)
    mx.profiler.set_config(filename=profile_path)
    before = kernel_counts(att, i8, fo)
    breakdowns = []
    mx.profiler.set_state("run")
    try:
        for _ in range(OBS_LM_STEPS):
            step()
            breakdowns.append(mx.telemetry.step.last_breakdown())
        torch.cuda.synchronize()
    finally:
        mx.profiler.set_state("stop")
    after = kernel_counts(att, i8, fo)
    mx.profiler.dump()
    with open(profile_path) as f:
        events = json.load(f)["traceEvents"]
    fwd = after["flash_attention"] - before["flash_attention"]
    bwd = after["flash_attention_bwd"] - before["flash_attention_bwd"]
    check(fwd == bwd == OBS_LM_STEPS * LM_LAYERS,
          f"observability: {fwd} K3 forward / {bwd} backward launches in "
          f"{OBS_LM_STEPS} steps, want {LM_LAYERS} each a step")
    steps = [s for s in mx.tracing.spans_snapshot()
             if s["name"] == "trainer_step"]
    idx = [s["attrs"].get("step") for s in steps]
    check(len(steps) == OBS_LM_STEPS and idx == list(range(
        idx[0], idx[0] + OBS_LM_STEPS)),
        f"observability: trainer_step spans with steps {idx}")
    check(len(breakdowns) == OBS_LM_STEPS and all(
        b.get("source") == "trainer" and b["step_time"] > 0
        for b in breakdowns), f"observability: breakdowns {breakdowns}")
    ops = sum(e["name"] == "_contrib_flash_attention" for e in events)
    check(ops == OBS_LM_STEPS * LM_LAYERS,
          f"observability: {ops} profiled flash attention dispatches")
    out = {"k3_fwd_launches_a_step": fwd // OBS_LM_STEPS,
           "k3_bwd_launches_a_step": bwd // OBS_LM_STEPS,
           "trainer_step_spans": len(steps),
           "breakdowns": breakdowns, "profile_events": len(events),
           "launches": {"flash_attention": fwd,
                        "flash_attention_bwd": bwd}}
    syncs, step_ms = {}, {}
    for on in (False, True) * OBS_COST_PAIRS:
        obs_planes(mx, on)
        if on not in syncs:
            _, syncs[on] = sync_count(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OBS_TIMED):
            step()
        torch.cuda.synchronize()
        step_ms.setdefault(on, []).append(
            (time.perf_counter() - t0) / OBS_TIMED * 1e3)
    check(syncs[True] == syncs[False], f"observability: a training step "
          f"synchronizes {syncs[True]} times with the planes on, "
          f"{syncs[False]} off")
    out.update(step_syncs=syncs[True], step_ms_on=step_ms[True],
               step_ms_off=step_ms[False])
    return out


def obs_monitor(mx, dev):
    """``Monitor(interval=1)`` on LeNet's ``Module.fit`` for
    OBS_MONITOR_BATCHES batches on the card and on the CPU from the same
    parameters and batches: the same names in the same order, the values
    within phase 8's tensor bound."""
    rs = np.random.RandomState(SEED)
    n = OBS_MONITOR_BATCHES * MODULE_BATCH
    x = rs.rand(n, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, (n,)).astype(np.float32)
    shapes = {"conv1_weight": (20, 1, 5, 5), "conv1_bias": (20,),
              "conv2_weight": (50, 20, 5, 5), "conv2_bias": (50,),
              "fc1_weight": (500, 800), "fc1_bias": (500,),
              "fc2_weight": (10, 500), "fc2_bias": (10,)}
    params = {k: (rs.normal(0, 0.05, s) if k.endswith("weight")
                  else np.zeros(s)).astype(np.float32)
              for k, s in shapes.items()}
    net = lenet(mx.sym)       # one graph: its generated names are shared
    seen = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        class Recording(mx.Monitor):
            def toc_print(self):
                self.stats.extend(self.toc())
        mon = Recording(interval=1)
        mon.stats = []
        with ctx:
            it = mx.io.NDArrayIter(x, y, batch_size=MODULE_BATCH,
                                   label_name="softmax_label")
            mod = mx.mod.Module(net, context=ctx)
            mod.fit(it, num_epoch=1, monitor=mon,
                    arg_params={k: mx.nd.array(v) for k, v in
                                params.items()},
                    optimizer_params={"learning_rate": MODULE_LR})
        seen[where] = mon.stats
    card, cpu = seen["card"], seen["cpu"]
    check([(s, n) for s, n, _ in card] == [(s, n) for s, n, _ in cpu],
          "observability: Monitor names differ between the card and CPU")
    worst = 0.0
    for (_, name, a), (_, _, b) in zip(card, cpu):
        a = np.array(a.strip("[]").split(), np.float64)
        b = np.array(b.strip("[]").split(), np.float64)
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        worst = max(worst, err)
        check(err <= PARITY_TENSOR_TOL, f"observability: Monitor {name} "
              f"card {a} vs CPU {b}")
    return {"stats": len(card), "batches": OBS_MONITOR_BATCHES,
            "worst_rel": worst}


def phase_observability(att, i8, fo, dev, burst, rng, here):
    """The module docstring's phase 23: the observability planes on the
    serving and training paths, their sync counts and cost, and the
    Monitor. Returns the phase's K3 / K4 launches by part."""
    import mxnet_tpu_torch as mx

    t_phase = time.perf_counter()
    try:
        serving = obs_serving(mx, att, dev, burst)
        training = obs_training(mx, att, i8, fo, dev, rng, here)
        monitor = obs_monitor(mx, dev)
    finally:
        mx.telemetry.set_enabled(True)
        mx.tracing.set_sample(1.0)
    phase_s = time.perf_counter() - t_phase
    on = [r for r in serving["cost_runs"] if r["planes"]]
    off = [r for r in serving["cost_runs"] if not r["planes"]]
    log("observability_cost " + json.dumps({
        "card": card_line(),
        "serving_tokens_per_s_on": [r["tokens_per_s"] for r in on],
        "serving_tokens_per_s_off": [r["tokens_per_s"] for r in off],
        "lm_step_ms_on": training["step_ms_on"],
        "lm_step_ms_off": training["step_ms_off"]}))
    log("observability " + json.dumps({
        "card": card_line(), "phase_s": phase_s,
        "serving": {k: v for k, v in serving.items() if k != "launches"},
        "training": {k: v for k, v in training.items() if k != "launches"},
        "monitor": monitor}))
    check(phase_s <= 60.0, f"observability took {phase_s:.1f} s, over 60")
    return {"flash_attention": {
                "serving": serving["launches"]["flash_attention"],
                "training": training["launches"]["flash_attention"]},
            "flash_attention_bwd": {
                "training": training["launches"]["flash_attention_bwd"]},
            "paged_attention": {
                "serving": serving["launches"]["paged_attention"]}}



# -- phase 24: the model-health and memory planes, and tail attribution ------
HT_WARM_STEPS = 5       # LM steps before the counted ones: the fold lag's
HT_LM_STEPS = 3         # boundaries and one; counted LM steps
HT_TIMED = 2            # LM steps timed a turn
HT_COST_PAIRS = 2       # off / on turns of the LM step's cost
HT_SERVE_PAIRS = 1      # on / off turns of the burst
HT_NORM_RTOL = 1e-5     # the probe's norms against the f64 host run
HT_NAN_STEP = 2         # the LeNet step whose weight is poisoned
HT_NAN_STEPS = 10
HT_REQUESTS = 8
HT_TAIL_TOLERANCE = 0.10
HT_SECONDS = 40.0


def ht_planes(mx, on):
    """The model-health plane (warn) and the census on, or both off (what
    MXTPU_HEALTH=0 and MXTPU_MEMORY_CENSUS=0 set); health state cleared."""
    mx.profiling.health.set_enabled(on)
    mx.profiling.memory.set_census_enabled(on)
    mx.profiling.health.reset()


def ht_plain_probe(olds, news, grads, group_idx):
    """The probe's values from host copies, in f64: the gradient and
    weight nonfinite counts, then the global gradient norm and each
    group's (weight norm, gradient norm, update ratio)."""
    def bad(ts):
        return sum(int((~torch.isfinite(t)).sum()) for t in ts)

    def sq(t):
        return float(t.double().square().sum())
    w2 = [sq(t) for t in news]
    g2 = [sq(t) for t in grads]
    u2 = [sq(o.double() - n.double()) for o, n in zip(olds, news)]
    out = [float(np.sqrt(sum(g2)))]
    for gi in range(max(group_idx) + 1):
        idx = [i for i, g in enumerate(group_idx) if g == gi]
        wn = np.sqrt(sum(w2[i] for i in idx))
        gn = np.sqrt(sum(g2[i] for i in idx))
        un = np.sqrt(sum(u2[i] for i in idx))
        out += [float(wn), float(gn), float(un / max(wn, 1e-12))]
    return [bad(grads), bad(news)], out


def ht_lm(mx, att, i8, fo, dev, rng):
    """Phase 12's decoder-LM trained through ``Trainer("adam")`` with the
    planes on: the probe's counts and norms of the last counted step
    against the host f64 run of the same tensors, the step spans' health
    attrs, the census against the parameters' and Adam states' bytes,
    sync counts and step ms on and off, the probe's launches."""
    from mxnet_tpu_torch.profiling import health, memory
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder

    ctx = mx.Context(dev)
    dec = GenerativeDecoder(vocab_size=LM_VOCAB, d_model=LM_D_MODEL,
                            num_layers=LM_LAYERS, num_heads=LM_HEADS,
                            ff_mult=LM_FF, max_prompt_tokens=LM_SEQ,
                            device=dev, seed=SEED)
    block = dec.block
    tokens = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ + 1))
    x = mx.nd.array(tokens[:, :-1].astype(np.int32), ctx=ctx)
    y = mx.nd.array(tokens[:, 1:].astype(np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(block.collect_params(), "adam",
                               {"learning_rate": LM_LR})
    params = [p for p in block.collect_params().values()
              if p.grad_req != "null"]

    def step():
        # the loss observed before the update, as a training loop does:
        # it folds with the step it belongs to
        loss = lm_step(mx, block, loss_fn, x, y)
        health.observe_loss(loss.mean())
        trainer.step(x.shape[0])
        return loss

    ht_planes(mx, True)
    mx.tracing.set_sample(1.0)
    mx.tracing.reset()
    for _ in range(HT_WARM_STEPS):
        step()
    torch.cuda.synchronize()
    # the last counted step's probe outputs, captured beside its inputs
    captured = {}
    real = health.probe_values

    def capture(ws, gs, olds, group_idx, want):
        counts, norms = real(ws, gs, olds, group_idx, want)
        captured.update(counts=counts, norms=norms, group_idx=group_idx)
        return counts, norms

    before = kernel_counts(att, i8, fo)
    olds = None
    for i in range(HT_LM_STEPS):
        if i == HT_LM_STEPS - 1:
            olds = [p.data()._data.detach().to("cpu", copy=True)
                    for p in params]
            health.probe_values = capture
        try:
            step()
        finally:
            health.probe_values = real
    torch.cuda.synchronize()
    after = kernel_counts(att, i8, fo)
    fwd = after["flash_attention"] - before["flash_attention"]
    bwd = after["flash_attention_bwd"] - before["flash_attention_bwd"]
    check(fwd == bwd == HT_LM_STEPS * LM_LAYERS,
          f"health_and_tails: {fwd} K3 forward / {bwd} backward launches in "
          f"{HT_LM_STEPS} steps, want {LM_LAYERS} each a step")
    news = [p.data()._data.detach().cpu() for p in params]
    grads = [p.grad()._data.detach().cpu() for p in params]
    counts = captured["counts"].cpu().tolist()
    norms = captured["norms"].cpu().tolist()
    plain_counts, plain_norms = ht_plain_probe(olds, news, grads,
                                               captured["group_idx"])
    check(counts == plain_counts, f"health_and_tails: probe counts "
          f"{counts}, plain {plain_counts}")
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(norms,
                                                           plain_norms)]
    check(len(norms) == len(plain_norms) and max(rel) <= HT_NORM_RTOL,
          f"health_and_tails: probe norms off the plain f64 run by "
          f"{max(rel)} relative")
    del olds, news, grads
    spans = [s for s in mx.tracing.spans_snapshot()
             if s["name"] == "trainer_step"]
    counted = spans[-HT_LM_STEPS:]
    check(len(spans) == HT_WARM_STEPS + HT_LM_STEPS
          and all(s["attrs"].get("health_nonfinite") == 0 for s in spans)
          and all({"loss_ewma", "grad_norm"} <= set(s["attrs"])
                  for s in counted),
          f"health_and_tails: trainer_step attrs "
          f"{[sorted(s['attrs']) for s in spans]}")
    doc = health.flush()
    check(doc["sentry"]["verdict"] == "clean" and doc["loss"]["observed"]
          == HT_WARM_STEPS + HT_LM_STEPS, f"health_and_tails: {doc}")
    # the census: the parameters' and Adam states' bytes on the card
    gc.collect()
    snap = mx.telemetry.snapshot()["metrics"]
    live = {(s["labels"]["device"], s["labels"]["role"]): s["value"]
            for s in snap["mx_memory_live_bytes"]["series"]}
    dkey = f"gpu:{dev.index or 0}" if dev.type == "cuda" else "cpu:0"
    param_bytes = sum(p.data()._data.untyped_storage().nbytes()
                      for p in block.collect_params().values())
    state_bytes = sum(s._data.untyped_storage().nbytes()
                      for st in trainer._updaters.states.values()
                      for s in st)
    census = {"device": dkey,
              "parameter": live.get((dkey, "parameter")),
              "optimizer_state": live.get((dkey, "optimizer_state")),
              "gradient": live.get((dkey, "gradient")),
              "activation": live.get((dkey, "activation")),
              "want_parameter": param_bytes,
              "want_optimizer_state": state_bytes}
    check(census["parameter"] == param_bytes
          and census["optimizer_state"] == state_bytes
          and census["activation"] is not None
          and census["activation"] >= 0,
          f"health_and_tails: census {census}")
    # the probe's launches a step (and the pre-update copy's)
    ws = [p.data()._data for p in params]
    gs = [p.grad()._data for p in params]
    group_idx = captured["group_idx"]

    def probe_call():
        return real(ws, gs, health.pre_update_copy(ws), group_idx, True)
    launched = kernels_launched(probe_call, 1)
    probe_ms, probe_launch_ms = measure(probe_call, iters=5, warmup=1)
    del ws, gs
    # synchronizing calls and step ms, planes off and on
    syncs, step_ms = {}, {}
    for on in (False, True) * HT_COST_PAIRS:
        ht_planes(mx, on)
        if on not in syncs:
            _, syncs[on] = sync_count(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HT_TIMED):
            step()
        torch.cuda.synchronize()
        step_ms.setdefault(on, []).append(
            (time.perf_counter() - t0) / HT_TIMED * 1e3)
    ht_planes(mx, True)
    check(syncs[True] == syncs[False] == 0, f"health_and_tails: a training "
          f"step synchronizes {syncs[True]} times with the planes on, "
          f"{syncs[False]} off")
    copies = {k: n for k, n in launched.items()
              if k.startswith(("Memcpy", "Memset"))}
    return {"k3_fwd_launches_a_step": fwd // HT_LM_STEPS,
            "k3_bwd_launches_a_step": bwd // HT_LM_STEPS,
            "parameters": len(params), "groups": max(group_idx) + 1,
            "probe_counts": counts, "probe_norm_rel_max": max(rel),
            "grad_norm": norms[0], "census": census,
            "probe_launches_a_step": sum(launched.values())
            - sum(copies.values()),
            "probe_copies_a_step": sum(copies.values()),
            "probe_kernels": launched, "probe_device_ms": probe_ms,
            "probe_launch_ms": probe_launch_ms, "step_syncs": syncs[True],
            "step_ms_on": step_ms[True], "step_ms_off": step_ms[False],
            "launches": {"flash_attention": fwd,
                         "flash_attention_bwd": bwd}}


def ht_nan_run(mx, ctx, params, x, y, here, where):
    """LeNet bound with ``simple_bind`` on ``ctx``, SGD through the
    Updater, one weight poisoned at step HT_NAN_STEP under the raise
    policy: (boundary that raised, its postmortem)."""
    from mxnet_tpu_torch.profiling import health

    ht_planes(mx, True)
    health.set_enabled("raise")
    os.environ["MXTPU_HEALTH_DUMP_PATH"] = os.path.join(
        here, "build", "chip_smoke", f"nan_postmortem_{where}.json")
    net = lenet(mx.sym)
    with ctx:
        ex = net.simple_bind(ctx, grad_req={k: "write" for k in params},
                             data=x.shape, softmax_label=y.shape)
        ex.copy_params_from({k: mx.nd.array(v) for k, v in params.items()})
        xd, yd = mx.nd.array(x), mx.nd.array(y)
    updater = mx.optimizer.get_updater(mx.optimizer.create(
        "sgd", learning_rate=MODULE_LR))
    raised = None
    try:
        for step in range(HT_NAN_STEPS):
            if step == HT_NAN_STEP:
                with torch.no_grad():
                    ex.arg_dict["conv2_weight"]._data.view(-1)[0] = \
                        float("nan")
            ex.forward(is_train=True, data=xd, softmax_label=yd)
            ex.backward()
            for i, n in enumerate(ex.arg_names):
                if n in params:
                    updater(i, ex.grad_dict[n], ex.arg_dict[n])
            try:
                health.step_boundary("chip_smoke_lenet")
            except health.NonfiniteError as e:
                raised = (step, e.postmortem)
                break
    finally:
        os.environ.pop("MXTPU_HEALTH_DUMP_PATH", None)
        ht_planes(mx, True)
    check(raised is not None, f"health_and_tails: no NonfiniteError on "
          f"the {where} in {HT_NAN_STEPS} steps")
    return raised


def ht_nan(mx, dev, here):
    """The NaN trip on the card and on the CPU from the same seeded
    LeNet weights and batch: both name the poisoned step and the same
    first op."""
    from mxnet_tpu_torch.profiling import health

    rs = np.random.RandomState(SEED)
    x = rs.rand(MODULE_BATCH, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, (MODULE_BATCH,)).astype(np.float32)
    shapes = {"conv1_weight": (20, 1, 5, 5), "conv1_bias": (20,),
              "conv2_weight": (50, 20, 5, 5), "conv2_bias": (50,),
              "fc1_weight": (500, 800), "fc1_bias": (500,),
              "fc2_weight": (10, 500), "fc2_bias": (10,)}
    params = {k: (rs.normal(0, 0.05, s) if k.endswith("weight")
                  else np.zeros(s)).astype(np.float32)
              for k, s in shapes.items()}
    got = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        got[where] = ht_nan_run(mx, ctx, params, x, y, here, where)
    (card_at, card_pm), (cpu_at, cpu_pm) = got["card"], got["cpu"]

    def first(pm):
        f = pm.get("first_op") or {}
        return (pm.get("source"), pm.get("step"), f.get("node"),
                f.get("op"), f.get("index"))
    check(first(card_pm) == first(cpu_pm) and card_pm.get("step")
          == HT_NAN_STEP and cpu_at == HT_NAN_STEP + health._FOLD_LAG
          and card_at >= HT_NAN_STEP + health._FOLD_LAG
          and card_pm.get("path") and os.path.exists(card_pm["path"]),
          f"health_and_tails: NaN trip card {card_at} {first(card_pm)}, "
          f"cpu {cpu_at} {first(cpu_pm)}")
    return {"poisoned_step": HT_NAN_STEP, "raised_at_card": card_at,
            "raised_at_cpu": cpu_at, "first_op": first(card_pm),
            "probes": (card_pm.get("first_op") or {}).get("probes"),
            "internals": (card_pm.get("first_op") or {}).get("internals")}


def ht_oom(mx, dev, here):
    """A tensor larger than the card requested inside a Trainer step on a
    small net: the OOM postmortem (census, allocator statistics, flight
    dump) written, the error propagated, the next step fine."""
    from mxnet_tpu_torch.profiling import memory

    path = os.path.join(here, "build", "chip_smoke", "oom_postmortem.json")
    if os.path.exists(path):
        os.remove(path)
    os.environ["MXTPU_OOM_DUMP_PATH"] = path
    memory._LAST_POSTMORTEM[0] = -10.0
    rs = np.random.RandomState(SEED)
    ctx = mx.gpu(0)
    with ctx:
        net = mx.gluon.nn.Dense(10, in_units=64, prefix="oom_")
        net.initialize(mx.initializer.Xavier(), ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        xd = mx.nd.array(rs.rand(32, 64).astype(np.float32))
        yd = mx.nd.array(rs.randint(0, 10, (32,)).astype(np.float32))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(xd), yd)
        loss.backward()
        trainer.step(32)
        return loss

    step()
    total = torch.cuda.get_device_properties(dev).total_memory
    real, asked = trainer._updaters, []

    def huge(i, g, w):
        if not asked:
            asked.append(total + (1 << 30))
            torch.empty(asked[0], dtype=torch.uint8, device=dev)
        return real(i, g, w)

    trainer._updaters = huge
    caught = None
    try:
        step()
    except torch.cuda.OutOfMemoryError as e:
        caught = e
    finally:
        trainer._updaters = real
        os.environ.pop("MXTPU_OOM_DUMP_PATH", None)
    check(caught is not None, "health_and_tails: no OutOfMemoryError")
    check(os.path.exists(path), "health_and_tails: no OOM postmortem")
    with open(path) as f:
        doc = json.load(f)
    stats = doc.get("device_stats", {}).get("gpu:0", {})
    check(doc.get("source") == "trainer_step"
          and doc["census"]["by_role"].get("parameter", {}).get("bytes")
          and stats.get("memory_stats") and stats.get("bytes_limit")
          and "flight" in doc,
          f"health_and_tails: OOM postmortem keys {sorted(doc)}")
    loss = step()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss._data).all()),
          "health_and_tails: the step after the OOM failed")
    return {"asked_bytes": asked[0], "card_bytes": total,
            "postmortem_keys": sorted(doc),
            "num_ooms": (stats.get("memory_stats") or {}).get("num_ooms"),
            "census_roles": sorted(doc["census"]["by_role"])}


def ht_tails(mx, att, dev, burst, here):
    """Phase 5's decoder serving the burst's first HT_REQUESTS (admitted
    at once) with the tail plane on: every request's bins conserve, the
    aggregated document renders through ``tools/tail_report.py``; the
    same burst with MXTPU_TAIL_ENABLE=0 launches the same K3 / K4 and
    emits the same tokens."""
    from mxnet_tpu_torch.profiling import tailpath
    from mxnet_tpu_torch.serving import Gateway
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder

    all_plens, all_new, all_prompts = burst
    prompts, new = all_prompts[:HT_REQUESTS], all_new[:HT_REQUESTS]
    dec = GenerativeDecoder(vocab_size=VOCAB, d_model=D_MODEL,
                            num_layers=LAYERS, num_heads=HEADS,
                            max_prompt_tokens=MAX_PROMPT, device=dev,
                            seed=SEED)
    gw = Gateway(device=dev)
    runs, doc, records = [], None, []
    try:
        gen = gw.register_generator(
            "lm", dec, block_tokens=BLOCK_TOKENS, max_blocks=MAX_BLOCKS,
            max_new_tokens=MAX_NEW, max_decode_batch=MAX_BATCH)
        lane = gen.lanes[0]
        mx.tracing.set_sample(1.0)
        for enable in ("1", "0") * HT_SERVE_PAIRS:
            os.environ["MXTPU_TAIL_ENABLE"] = enable
            mx.tracing.reset()
            att.reset_launches()
            got, wall = obs_burst(gw, lane, prompts, new)
            run = {"tail": tailpath.enabled(), "wall_s": wall,
                   "tokens_per_s": int(sum(new)) / wall,
                   "flash_launches": att.flash_attention.launches,
                   "paged_launches": att.paged_attention.launches,
                   "tokens": got}
            if tailpath.enabled():
                spans = mx.tracing.spans_snapshot()
                records, skipped = tailpath.join_spans(spans)
                agg = tailpath.TailAggregator(window=64, slow_frac=0.25)
                run["ingested"] = agg.ingest_spans(spans, stage="burst")
                run["skipped"] = skipped
                doc = agg.collect(tolerance=HT_TAIL_TOLERANCE)
            runs.append(run)
    finally:
        os.environ.pop("MXTPU_TAIL_ENABLE", None)
        gw.close()
    on = [r for r in runs if r["tail"]]
    off = [r for r in runs if not r["tail"]]
    check(all(r["tokens"] == runs[0]["tokens"] for r in runs)
          and len({(r["flash_launches"], r["paged_launches"])
                   for r in runs}) == 1
          and runs[0]["flash_launches"] == HT_REQUESTS * LAYERS,
          "health_and_tails: tokens or K3 / K4 launches differ with the "
          "tail plane on and off: " + json.dumps(
              [{k: v for k, v in r.items() if k != "tokens"}
               for r in runs]))
    worst = 0.0
    for r in records:
        attributed = sum(v for b, v in r["bins"].items()
                         if b != "_unattributed")
        check(attributed + r["bins"]["_unattributed"] == r["e2e_ns"]
              and attributed <= r["e2e_ns"], f"health_and_tails: {r}")
        worst = max(worst, r["bins"]["_unattributed"] / r["e2e_ns"])
    check(len(records) == HT_REQUESTS and on[-1]["skipped"] == 0
          and worst <= HT_TAIL_TOLERANCE
          and doc["conservation"]["conserved"],
          f"health_and_tails: tails {len(records)} records, worst "
          f"unattributed {worst}, {doc['conservation']}")
    path = os.path.join(here, "build", "chip_smoke", "tail.json")
    tailpath.dump(path, doc)
    out = subprocess.run([sys.executable, os.path.join(
        here, "tools", "tail_report.py"), path], capture_output=True,
        text=True, timeout=60)
    check(out.returncode == 0 and "decode_compute" in out.stdout,
          f"health_and_tails: tail_report: {out.stdout} {out.stderr}")
    return {"requests": HT_REQUESTS, "records": len(records),
            "worst_unattributed": worst,
            "conservation": doc["conservation"],
            "drivers": doc["slow"]["drivers"][:5],
            "tokens_per_s_on": [r["tokens_per_s"] for r in on],
            "tokens_per_s_off": [r["tokens_per_s"] for r in off],
            "launches": {"flash_attention": runs[0]["flash_launches"],
                         "paged_attention": runs[0]["paged_launches"]}}


def phase_health_and_tails(att, i8, fo, dev, burst, rng, here):
    """The module docstring's phase 24: the model-health and memory
    planes on the LM training path, a NaN trip and an OOM postmortem,
    the census, and tail attribution on the serving path. Returns the
    phase's K3 / K4 launches by part."""
    import mxnet_tpu_torch as mx

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(here, "build", "chip_smoke"), exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    parts_s = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts_s[name] = time.perf_counter() - t0
        return out
    try:
        lm = part("lm", ht_lm, mx, att, i8, fo, dev, rng)
        gc.collect()
        torch.cuda.empty_cache()
        nan = part("nan", ht_nan, mx, dev, here)
        oom = part("oom", ht_oom, mx, dev, here)
        tails = part("tails", ht_tails, mx, att, dev, burst, here)
    finally:
        ht_planes(mx, True)
        mx.telemetry.set_enabled(True)
        mx.tracing.set_sample(1.0)
    phase_s = time.perf_counter() - t_phase
    log("health_cost " + json.dumps({
        "card": card_line(),
        "lm_step_ms_on": lm["step_ms_on"], "lm_step_ms_off": lm["step_ms_off"],
        "serving_tokens_per_s_on": tails["tokens_per_s_on"],
        "serving_tokens_per_s_off": tails["tokens_per_s_off"],
        "probe_launches_a_step": lm["probe_launches_a_step"],
        "probe_device_ms": lm["probe_device_ms"]}))
    log("health_and_tails " + json.dumps({
        "card": card_line(), "phase_s": phase_s, "parts_s": parts_s,
        "lm": {k: v for k, v in lm.items() if k != "launches"},
        "nan": nan, "oom": oom,
        "tails": {k: v for k, v in tails.items() if k != "launches"}}))
    check(phase_s <= HT_SECONDS, f"health_and_tails took {phase_s:.1f} s, "
          f"over {HT_SECONDS:.0f}")
    return {"flash_attention": {"training": lm["launches"]["flash_attention"],
                                "serving": tails["launches"][
                                    "flash_attention"]},
            "flash_attention_bwd": {
                "training": lm["launches"]["flash_attention_bwd"]},
            "paged_attention": {"serving": tails["launches"][
                "paged_attention"]}}


# -- phase 25: the cost ledger and its device capture -------------------------
CL_STEPS = 3            # captured LM steps
CL_RATIO_MAX = 1.05     # the table's device time over the CUDA-event step
CL_SECONDS = 40.0
CL_PAGED_LENS = [284, 184, 257, 119]
CL_FLASH_FWD_GFLOP, CL_FLASH_BWD_GFLOP = 51.564773376, 128.91193344
# the LM step's FLOPs counted by hand: 6 x the product parameters (qkv,
# out, two FF matrices a layer and the head) x tokens, plus the 12 K3
# forwards and backwards
CL_PRODUCT_PARAMS = LM_LAYERS * (3 * LM_D_MODEL ** 2 + LM_D_MODEL ** 2
                                 + 2 * LM_FF * LM_D_MODEL ** 2) \
    + LM_D_MODEL * LM_VOCAB
CL_HAND_FLOPS = 6 * CL_PRODUCT_PARAMS * LM_BATCH * LM_SEQ + LM_LAYERS * (
    CL_FLASH_FWD_GFLOP + CL_FLASH_BWD_GFLOP) * 1e9


def cl_rows(doc, kernel):
    return [r for r in doc["rows"] if r["hlo_op"] == kernel]


def cl_idle(mx, att, step, dev, rng):
    """K3 launches and synchronizing calls of one LM step, and K4's of one
    decode call, with no recorder or capture active."""
    q, k, v, tables, lens = paged_inputs(CL_PAGED_LENS, 1, 64, dev, rng)
    before = (att.flash_attention.launches, att.flash_attention_bwd.launches,
              att.paged_attention.launches)
    _, step_syncs = sync_count(step)
    _, paged_syncs = sync_count(lambda: att.paged_attention(
        q, k[0], v[0], tables, lens))
    after = (att.flash_attention.launches, att.flash_attention_bwd.launches,
             att.paged_attention.launches)
    return {"k3_fwd": after[0] - before[0], "k3_bwd": after[1] - before[1],
            "k4": after[2] - before[2], "step_syncs": step_syncs,
            "paged_syncs": paged_syncs}


def cl_lm(mx, att, dev, rng, here):
    """Phase 12's decoder-LM step (fp32, Adam): its ledger, its attribution
    over CL_STEPS captured steps, its liveness, and the idle machinery."""
    from mxnet_tpu_torch.profiling import capture, ledger, memory
    from mxnet_tpu_torch.serving.generate import GenerativeDecoder

    ctx = mx.Context(dev)
    dec = GenerativeDecoder(vocab_size=LM_VOCAB, d_model=LM_D_MODEL,
                            num_layers=LM_LAYERS, num_heads=LM_HEADS,
                            ff_mult=LM_FF, max_prompt_tokens=LM_SEQ,
                            device=dev, seed=SEED)
    block = dec.block
    tokens = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_SEQ + 1))
    x = mx.nd.array(tokens[:, :-1].astype(np.int32), ctx=ctx)
    y = mx.nd.array(tokens[:, 1:].astype(np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(block.collect_params(), "adam",
                               {"learning_rate": LM_LR})

    def step():
        return lm_step(mx, block, loss_fn, x, y, trainer)

    step()
    torch.cuda.synchronize()
    idle_before = cl_idle(mx, att, step, dev, rng)

    f0, b0 = att.flash_attention.launches, att.flash_attention_bwd.launches
    led = ledger.from_fn(step, peak_tflops=FP32_FLOPS_PER_S / 1e12)
    torch.cuda.synchronize()
    traced = (att.flash_attention.launches - f0,
              att.flash_attention_bwd.launches - b0)
    fwd_rows = cl_rows(led, "flash_attention")
    bwd_rows = cl_rows(led, "flash_attention_bwd")
    meta = torch.empty((LM_BATCH, LM_HEADS, LM_SEQ, LM_HEAD_DIM),
                       device="meta")
    fwd_flops = att.flash_count(meta, meta, meta, causal=True)[0]
    check(traced == (LM_LAYERS, LM_LAYERS), f"cost_ledger: the traced step "
          f"launched {traced} K3 forward / backward, want {LM_LAYERS} each")
    check(len(fwd_rows) == LM_LAYERS and len(bwd_rows) == LM_LAYERS,
          f"cost_ledger: {len(fwd_rows)} K3 forward and {len(bwd_rows)} "
          f"backward rows, want {LM_LAYERS} each")
    check(all(r["flops"] == fwd_flops == round(CL_FLASH_FWD_GFLOP * 1e9)
              for r in fwd_rows), "cost_ledger: K3 forward rows' FLOPs "
          f"{sorted({r['flops'] for r in fwd_rows})}")
    check(all(r["flops"] == round(CL_FLASH_BWD_GFLOP * 1e9)
              for r in bwd_rows), "cost_ledger: K3 backward rows' FLOPs "
          f"{sorted({r['flops'] for r in bwd_rows})}")
    check(all(r["op"] == "_contrib_flash_attention"
              for r in fwd_rows + bwd_rows), "cost_ledger: K3 rows keyed "
          f"to {sorted({r['op'] for r in fwd_rows + bwd_rows})}")
    # every product of the step runs in a framework op's scope, forward
    # or backward (autograd's thread included)
    unscoped = [r["instr"] for r in led["rows"] if r["op"] is None
                and r["hlo_op"] in ("mm", "addmm", "bmm", "baddbmm")]
    check(not unscoped, f"cost_ledger: products outside any scope: "
          f"{unscoped}")

    # the K3 calls' CUDA-event time at this shape, for the measured rows
    # (comparison launches: left out of the phase's count)
    m0 = (att.flash_attention.launches, att.flash_attention_bwd.launches)
    q, k, v = lm_qkv(LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM, dev,
                     torch.Generator().manual_seed(SEED))
    out, lse = att._flash_fwd(q, k, v, True, LM_HEAD_DIM ** -0.5, True)
    d_out = torch.randn_like(out)
    fwd_ms, _ = measure(lambda: att._flash_fwd(
        q, k, v, True, LM_HEAD_DIM ** -0.5, True), iters=10, warmup=2)
    bwd_ms, _ = measure(lambda: att.flash_attention_bwd(
        q, k, v, out, d_out, lse, causal=True), iters=10, warmup=2)
    del q, k, v, out, lse, d_out
    compare = (att.flash_attention.launches - m0[0],
               att.flash_attention_bwd.launches - m0[1])

    # the capture prices at the fp32 peak through the ledger's override
    prior = os.environ.get("MXTPU_PEAK_TFLOPS")
    os.environ["MXTPU_PEAK_TFLOPS"] = str(FP32_FLOPS_PER_S / 1e12)
    try:
        attrib = capture.attribution_run(
            step, steps=CL_STEPS,
            profile_dir=os.path.join(here, "build", "chip_smoke",
                                     "cost_ledger"),
            items_per_step=LM_BATCH * LM_SEQ)
    finally:
        if prior is None:
            del os.environ["MXTPU_PEAK_TFLOPS"]
        else:
            os.environ["MXTPU_PEAK_TFLOPS"] = prior
    check(attrib["peak_tflops"] == FP32_FLOPS_PER_S / 1e12,
          f"cost_ledger: the capture priced at {attrib['peak_tflops']} "
          "TFLOP/s")
    rec = attrib["reconciliation"]
    check(rec["device_ratio"] <= CL_RATIO_MAX,
          f"cost_ledger: the table claims {rec['attributed_s']} s of device "
          f"time a step against a {rec['device_step_s']} s CUDA-event step")
    meas_fwd = sum(r.get("measured_s", 0.0)
                   for r in cl_rows(attrib, "flash_attention"))
    meas_bwd = sum(r.get("measured_s", 0.0)
                   for r in cl_rows(attrib, "flash_attention_bwd"))
    if rec["ratio"] < 0.9:
        log(f"cost_ledger: reconciliation ratio {rec['ratio']} under 0.9")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mem = memory.from_fn(step)
    torch.cuda.synchronize()
    peak_alloc = torch.cuda.max_memory_allocated(dev) - base
    idle_after = cl_idle(mx, att, step, dev, rng)
    for idle in (idle_before, idle_after):
        check(idle["k3_fwd"] == idle["k3_bwd"] == LM_LAYERS
              and idle["k4"] == 1, f"cost_ledger: idle launches {idle}")
    check(idle_before["step_syncs"] == idle_after["step_syncs"] and
          idle_before["paged_syncs"] == idle_after["paged_syncs"],
          f"cost_ledger: sync counts idle before {idle_before}, after "
          f"{idle_after}")
    return {
        "ledger": {"flops": led["totals"]["flops"],
                   "hand_flops": CL_HAND_FLOPS,
                   "flops_over_hand": led["totals"]["flops"] / CL_HAND_FLOPS,
                   "bytes": led["totals"]["bytes"], "rows": len(led["rows"]),
                   "ops": led["totals"]["ops"],
                   "k3_fwd_rows": len(fwd_rows), "k3_bwd_rows": len(bwd_rows),
                   "k3_fwd_gflop": fwd_rows[0]["flops"] / 1e9,
                   "k3_bwd_gflop": bwd_rows[0]["flops"] / 1e9,
                   "k3_fwd_bytes": fwd_rows[0]["bytes"],
                   "k3_bwd_bytes": bwd_rows[0]["bytes"],
                   "mfu_at_roofline": ledger.mfu_estimate(led)[
                       "mfu_at_roofline"]},
        "attribution": {
            "reconciliation": rec, "reconciled": attrib["reconciled"],
            "mfu": attrib["mfu"], "items_per_s": attrib.get("items_per_s"),
            "measured": attrib["measured"], "lost": attrib["lost"],
            "top": [{k: g.get(k) for k in ("op", "measured_s", "est_s",
                                           "flops", "bytes", "mfu")}
                    for g in attrib["by_op"][:10]],
            "k3_fwd_measured_ms": meas_fwd * 1e3,
            "k3_fwd_events_ms": LM_LAYERS * fwd_ms,
            "k3_bwd_measured_ms": meas_bwd * 1e3,
            "k3_bwd_events_ms": LM_LAYERS * bwd_ms},
        "memory": {"peak_live_bytes": mem["peak_live_bytes"],
                   "arg_bytes": mem["totals"]["arg_bytes"],
                   "peak_instr": mem["peak_instr"],
                   "max_allocated_less_baseline": peak_alloc,
                   "baseline_allocated": base,
                   "top": mem["by_op"][:5]},
        "idle_before": idle_before, "idle_after": idle_after,
        "compare_launches": {"flash_attention": compare[0],
                             "flash_attention_bwd": compare[1]}}


def cl_int8_graph(mx, rng, here):
    """Phase 6's fused INT8 graph and its parameters (phase 6 leaves them
    in RESULTS; alone, built the way phase 6 builds them)."""
    if "int8_graph" in RESULTS:
        return RESULTS["int8_graph"]
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    sym = mx.model_zoo.load_symbol("resnet50_v1")
    prefix = os.path.join(here, "build", "chip_smoke", "resnet50_v1")
    if not os.path.exists(prefix + "-0000.params"):
        arg, aux = resnet_params(sym, rng)
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        with mx.cpu():
            mx.model.save_checkpoint(
                prefix, 0, sym, {k: mx.nd.array(v) for k, v in arg.items()},
                {k: mx.nd.array(v) for k, v in aux.items()})
    sym, arg_p, aux_p = mx.model.load_checkpoint(prefix, 0)
    calib = rng.standard_normal((CALIB_IMAGES,) + R50_SHAPE[1:],
                                dtype=np.float32)
    qsym, qarg, qaux = quantize_model(
        sym, arg_p, aux_p, calib_mode="naive",
        calib_data=mx.io.NDArrayIter(calib, batch_size=CALIB_IMAGES),
        num_calib_examples=CALIB_IMAGES)
    return qsym.get_backend_symbol("XLA"), qarg, qaux


def cl_int8(mx, i8, dev, rng, here):
    """The INT8 ResNet-50 v1 forward at batch 128: one K1 row per fused
    convolution, every fused node's rows under its rule."""
    from mxnet_tpu_torch.profiling import ledger
    fused, qarg, qaux = cl_int8_graph(mx, rng, here)
    ex8 = fused.simple_bind(grad_req="null", data=R50_SHAPE,
                            **{k: v.shape for k, v in qarg.items()})
    ex8.copy_params_from(qarg, qaux, allow_extra_params=True)
    data = mx.nd.array(rng.standard_normal(R50_SHAPE, dtype=np.float32))
    ex8.forward(data=data)
    n0 = i8.int8_conv_epilogue.launches
    led = ledger.from_fn(lambda: ex8.forward(data=data)[0])
    torch.cuda.synchronize()
    launched = i8.int8_conv_epilogue.launches - n0
    k1 = cl_rows(led, "int8_conv_epilogue")
    fused_rows = [r for r in led["rows"] if r["op"] == "_sg_xla_quant_conv"]
    scopes = {r["instr"].split("/")[0] for r in fused_rows}
    check(launched == R50_QUANT_CONVS and len(k1) == R50_QUANT_CONVS,
          f"cost_ledger: {len(k1)} K1 rows, {launched} launches, want "
          f"{R50_QUANT_CONVS}")
    check(len(scopes) == R50_QUANT_CONVS and all(
        r.get("rule") == "XLA/quantize_conv_requantize" for r in fused_rows),
        f"cost_ledger: {len(scopes)} fused conv scopes, rules "
        f"{sorted({str(r.get('rule')) for r in fused_rows})}")
    elems = sum(r["bytes"] for r in k1) // 5
    check(all(r["bytes"] == 5 * r["flops"] // 2 for r in k1),
          "cost_ledger: K1 rows not 5 B and 2 flops an element")
    del ex8
    torch.cuda.empty_cache()
    return {"k1_rows": len(k1), "fused_scopes": len(scopes),
            "k1_elements": elems, "rows": len(led["rows"]),
            "gflops": led["totals"]["flops"] / 1e9,
            "top": [{k: g.get(k) for k in ("op", "flops", "bytes", "rule")}
                    for g in led["by_op"][:5]]}


def cl_train(mx, fo, dev, rng, here):
    """Phase 8's symbolic training step at batch 128: one K2 row per
    trainable tensor, 20 B an element."""
    from mxnet_tpu_torch.profiling import ledger
    cl_int8_graph(mx, rng, here)       # the checkpoint, when alone
    net, params, arg_p, aux_p = train_net(mx, here)
    ex = train_executor(mx, net, TRAIN_BATCH, arg_p, aux_p, mx.gpu(0))
    states = {n: [mx.nd.zeros(ex.arg_dict[n].shape, ctx=mx.gpu(0))]
              for n in params}
    x = mx.nd.array(rng.standard_normal((TRAIN_BATCH,) + R50_SHAPE[1:],
                                        dtype=np.float32))
    y = mx.nd.array(rng.integers(0, 1000, TRAIN_BATCH).astype(np.float32))
    hp = dict(SGD_HYPER, rescale_grad=1.0 / TRAIN_BATCH)
    train_step(mx, ex, params, states, x, y, hp)
    n0 = fo.fused_sgd_mom.launches
    led = ledger.from_fn(lambda: train_step(mx, ex, params, states, x, y,
                                            hp))
    torch.cuda.synchronize()
    launched = fo.fused_sgd_mom.launches - n0
    k2 = cl_rows(led, "fused_sgd_mom")
    sizes = sorted(ex.arg_dict[n].size for n in params)
    check(launched == R50_TRAINABLE and len(k2) == R50_TRAINABLE,
          f"cost_ledger: {len(k2)} K2 rows, {launched} launches, want "
          f"{R50_TRAINABLE}")
    check(sorted(r["bytes"] for r in k2) == [SGD_BYTES * n for n in sizes],
          "cost_ledger: K2 rows' bytes are not 20 B an element")
    del ex, states, x
    torch.cuda.empty_cache()
    return {"k2_rows": len(k2), "k2_bytes": sum(r["bytes"] for r in k2),
            "rows": len(led["rows"]), "gflops": led["totals"]["flops"] / 1e9,
            "top": [{k: g.get(k) for k in ("op", "flops", "bytes")}
                    for g in led["by_op"][:5]]}


def phase_cost_ledger(att, i8, fo, dev, rng, here):
    """The module docstring's phase 25: the cost ledger, its capture and
    the liveness ledger on the LM, INT8 and symbolic training paths.
    Returns the phase's launches by kernel and part."""
    import mxnet_tpu_torch as mx

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    parts_s, launches = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        c0 = kernel_counts(att, i8, fo)
        out = fn(*args)
        c1 = kernel_counts(att, i8, fo)
        for k, v in c1.items():
            n = v - c0[k] - out.get("compare_launches", {}).get(k, 0)
            if n:
                launches.setdefault(k, {})[name] = n
        parts_s[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return out
    lm = part("lm_training", cl_lm, mx, att, dev, rng, here)
    int8 = part("int8_inference", cl_int8, mx, i8, dev, rng, here)
    train = part("symbolic_training", cl_train, mx, fo, dev, rng, here)
    phase_s = time.perf_counter() - t_phase
    log("cost_ledger " + json.dumps({
        "card": card_line(), "phase_s": phase_s, "parts_s": parts_s,
        "lm": lm, "int8": int8, "train": train}))
    check(phase_s <= CL_SECONDS, f"cost_ledger took {phase_s:.1f} s, over "
          f"{CL_SECONDS:.0f}")
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

    def timed(fn, *args):
        """Run one phase, logging its wall seconds."""
        t0 = time.perf_counter()
        out = fn(*args)
        PHASE_S[fn.__name__] = PHASE_S.get(fn.__name__, 0.0) \
            + time.perf_counter() - t0
        log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    kernels = [timed(phase_flash, att, _build, dev, rng),
               timed(phase_flash_bwd, att, _build, dev),
               timed(phase_paged, att, dev, rng),
               timed(phase_int8, i8, dev),
               *timed(phase_fused_opt, fo, dev)]

    burst = generate_burst(rng)
    launches, serve_main = timed(phase_serve, att, dev, burst)
    launches.update(timed(phase_resnet, i8, dev, rng, here))
    launches["fused_sgd_mom"] = timed(phase_train, fo, dev, rng, here)
    launches["fused_adam"] = timed(phase_train_adam, fo, dev, rng, here)
    timed(phase_gluon, att, i8, fo, dev, rng, here)
    timed(phase_gluon_train, att, i8, fo, dev, rng, here)
    launches.update(timed(phase_lm_train, att, i8, fo, dev, rng))
    kernels += [timed(phase_flash_bf16, att, _build, dev),
                timed(phase_flash_bwd_bf16, att, _build, dev),
                timed(phase_paged, att, dev, rng, torch.bfloat16,
                      kernels[2]["shape"]["decode_lens"])]
    launches.update(timed(phase_lm_train_bf16, att, i8, fo, dev, rng))
    launches.update(timed(phase_serve_bf16, att, dev, burst, serve_main))
    timed(phase_d256, att, dev, kernels)
    d256_serve = timed(phase_serve_heads, att, i8, fo, dev)
    timed(phase_module, att, i8, fo, dev, here)
    timed(phase_dist, here, dev)
    planes = timed(phase_serving_planes, att, i8, fo, dev, burst, here, rng)
    timed(phase_records, att, i8, fo, dev, here, rng)
    timed(phase_gluon_data, att, i8, fo, dev, here, rng)
    timed(phase_ssd, att, i8, fo, dev, here, rng)
    parallel = timed(phase_parallel, att, i8, fo, dev, burst, rng)
    data_parallel = timed(phase_data_parallel, att, i8, fo, dev, rng)
    observability = timed(phase_observability, att, i8, fo, dev, burst,
                          rng, here)
    health = timed(phase_health_and_tails, att, i8, fo, dev, burst, rng,
                   here)
    cost = timed(phase_cost_ledger, att, i8, fo, dev, rng, here)
    log("phase_seconds " + json.dumps(PHASE_S))
    for k in kernels:
        k["launches"] = launches[k["name"]]
        # the serving planes' launches (phase 17), where the kernel is on
        # that path
        k["planes_launches"] = planes.get(k["name"])
        # the parallel layouts' launches (phase 21), by part
        k["parallel_launches"] = parallel.get(k["name"])
        # the sharded train steps' launches (phase 22)
        k["data_parallel_launches"] = data_parallel.get(k["name"])
        # the observability planes' launches (phase 23), by part
        k["observability_launches"] = observability.get(k["name"])
        # the health and tail planes' launches (phase 24), by part
        k["health_launches"] = health.get(k["name"])
        # the cost ledger's and its capture's launches (phase 25), by part
        k["cost_ledger_launches"] = cost.get(k["name"])
        if "d256" in k:
            # the D 256 decoder's serving launches (phase 14), where the
            # kernel is on that path
            k["d256"]["serve_launches"] = max(
                c.get(k["name"], 0) for c in d256_serve.values()) or None
        log("kernel " + json.dumps(k))
        for extra in ("shape", "launch_ms", "step"):
            k.pop(extra, None)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cost_ledger_alone():
    """Phase 25 by itself (``--cost-ledger``): the kernels built, then the
    phase, then the result line."""
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(card_line())
    log(f"build: {_build.build_all():.1f}s")
    t0 = time.perf_counter()
    launches = phase_cost_ledger(att, i8, fo, dev,
                                 np.random.default_rng(SEED), here)
    log(f"phase_cost_ledger: {time.perf_counter() - t0:.1f} s")
    log("cost_ledger_launches " + json.dumps(launches))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == "--cost-ledger":
        sys.exit(cost_ledger_alone())
    if len(sys.argv) == 3 and sys.argv[1] == "--time-paged":
        sys.exit(time_paged_tree(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-flash":
        sys.exit(time_flash_tree(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--dist-worker":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(dist_worker(sys.argv[2], sys.argv[3]))
    if len(sys.argv) > 1:
        fail(f"unknown arguments {sys.argv[1:]}: none (every phase), "
             "--cost-ledger, --time-paged DIR or --time-flash DIR")
    sys.exit(main())
