"""mxnet_tpu_torch: the PyTorch + CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100), grown slice by slice beside the JAX package, which stays
the reference.

This package imports torch and numpy, never ``jax`` or ``mxnet_tpu``.
Its entry points run on ``cuda:0`` unless the caller asks for the CPU
(``ctx=mx.cpu()``, ``with mx.cpu():`` or ``device="cpu"``); on a host
without CUDA they raise instead. TF32 is off for cuBLAS and cuDNN: a
float32 product here is a float32 product. Ported so far:

- generative serving (``serving.Gateway.generate``) with the
  hand-written flash (prefill) and paged (decode) attention kernels;
- symbolic INT8 inference: ``model.load_checkpoint`` →
  ``contrib.quantization.quantize_model`` →
  ``Symbol.get_backend_symbol("XLA")`` → ``simple_bind`` →
  ``Executor.forward``, whose fused ``_sg_xla_quant_conv`` nodes end in
  the hand-written INT8 requantize epilogue kernel;
- symbolic training (``simple_bind(grad_req="write")`` → ``forward`` /
  ``backward`` → ``nd.sgd_mom_update`` / ``nd.adam_update``), whose
  updates are the hand-written fused optimizer kernels;
- gluon inference (``gluon.model_zoo.vision.resnet50_v1``,
  ``hybridize``, ``export``, ``SymbolBlock``), the ``Predictor`` and
  one-shot serving (``serving.Gateway.register`` / ``infer`` with fp32,
  bf16 and int8 variants), and ``contrib.quantization.quantize_net``;
- gluon training through the imperative tape: ``autograd.record`` /
  ``backward`` / ``grad``, ``gluon.loss``, ``gluon.Trainer`` over the
  ``optimizer`` classes (multi-precision included), ``lr_scheduler`` and
  ``metric``;
- decoder-LM training through gluon: the generative decoder's block
  (``serving.generate.GenerativeDecoder(...).block``) under
  ``autograd.record``, with the hand-written flash attention forward and
  backward kernels, served afterwards from the same weights;
- the Module API (``mod.Module`` / ``BucketingModule`` /
  ``SequentialModule``: ``fit``, ``score``, ``predict``, checkpoints and
  optimizer states), ``model.FeedForward``, ``callback``, and the data
  iterators ``io.MNISTIter`` / ``CSVIter`` / ``LibSVMIter`` /
  ``ResizeIter`` / ``PrefetchingIter`` over ``test_utils``' offline
  MNIST;
- the KVStore (``mx.kv``: ``local``, ``device``, ``dist_sync`` and
  ``dist_async`` over the parameter server of ``_native/comm.cc``,
  ``dist_device_sync`` over ``torch.distributed``) and the gluon
  Trainer's distributed path, with this package's launcher
  (``mxnet_tpu_torch/tools/launch.py``);
- the record input pipeline: ``recordio`` (``MXRecordIO``,
  ``MXIndexedRecordIO``, the JAX package's bytes both ways),
  ``io.ImageRecordIter`` in process or over the sharded decode workers
  (``io.ShardedRecordPipeline``: worker processes, a shared-memory
  ring, the port's libjpeg decoder ``_native/imgdec.cc``), the
  pinned-memory device feeder (``io.DeviceFeeder``), and ``image``
  (``imdecode``, the augmenters, ``ImageIter``);
- the rest of the input pipeline: ``gluon.data`` (datasets, samplers,
  vision transforms and datasets, the ``DataLoader`` over a thread
  pool, the libjpeg batch decoder or the sharded decode workers),
  ``contrib.io.DataLoaderIter`` for ``Module.fit``, and the detection
  input (``image.ImageDetIter``, the detection augmenters) with the
  MultiBox ops and ``box_nms`` that train and run the SSD detector;
- the observability planes: ``telemetry`` (the metrics registry, the
  per-step breakdown, exports), ``tracing`` (spans, the flight
  recorder), ``profiler`` and ``Monitor``, hooked into serving,
  training, the executor, the data iterators and the kvstore.

Kernels live in ``csrc/`` and are built on first use (``ops/_build.py``).
"""
from __future__ import annotations

import torch

from .base import MXNetError, get_env
from . import telemetry, tracing  # noqa: F401
from . import profiling  # noqa: F401
from .context import Context, cpu, current_context, gpu, resolve_device
from . import ops  # noqa: F401  registers every op
from . import ndarray as nd
from . import symbol as sym
from . import executor, io, model, model_zoo, subgraph, contrib  # noqa: F401
from . import autograd, gluon, initializer, predictor, random  # noqa: F401
from . import lr_scheduler, metric, optimizer  # noqa: F401
from . import callback, checkpoint, executor_manager  # noqa: F401
from . import module, test_utils  # noqa: F401
from . import module as mod  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import image, recordio  # noqa: F401
from . import monitor, profiler  # noqa: F401
from .monitor import Monitor  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# last: in a launcher's server process this import enters the server
# loop and never returns (the reference's import-time contract)
from . import kvstore_server  # noqa: F401,E402

__all__ = ["Context", "MXNetError", "Monitor", "autograd", "callback",
           "checkpoint", "contrib", "cpu", "current_context", "executor",
           "executor_manager", "get_env", "gluon", "gpu", "image",
           "initializer", "io", "kv", "kvstore", "lr_scheduler", "metric",
           "mod", "model", "model_zoo", "module", "monitor", "nd",
           "optimizer", "predictor", "profiler", "random", "recordio",
           "resolve_device", "subgraph", "sym", "telemetry", "test_utils",
           "tracing"]
