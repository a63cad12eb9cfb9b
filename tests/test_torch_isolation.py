"""The port stands alone and never runs on the CPU unasked:
``mxnet_tpu_torch`` (and ``chip_smoke.py``) import neither ``jax`` nor
``mxnet_tpu``, its entry points (serving, ``nd.array``, ``bind`` /
``simple_bind``, ``load_checkpoint``, gluon's ``initialize`` /
``load_parameters`` / ``SymbolBlock.imports``, the ``Predictor``,
``quantize_net``) default to the first CUDA card and
raise on a host without one unless the caller asks for the CPU, and its
kernel build raises instead of falling back when ``nvcc`` is missing.
The import check covers the serving planes' placement and migration
(``parallel.mesh``, ``serving.generate.migrate``), the parallel layouts
(every module of ``parallel``: collectives, layout, tensor-parallel,
Ulysses, ring attention, pipeline, MoE) and the training
modules too (``optimizer``,
``metric``, ``lr_scheduler``, ``gluon.loss``, ``gluon.trainer``), the
ops the decoder-LM training path adds (``ops.contrib``) and the
distribution layer (``kvstore.*``, ``kvstore_server``, the ``_native``
loader and the launcher, which imports no torch either), and the record
input pipeline (``recordio``, ``image``, ``io.pipeline`` and the decode
worker ``io/_pipeline_worker.py``, which imports neither torch nor
either package), and the rest of the input pipeline with the detection
ops (``gluon.data``, ``gluon.data.vision``, ``contrib.io``,
``image.detection``, ``ops.detection``); a DataLoader iterated outside a
CPU scope on a host without CUDA raises, on every path. The transport
``_native/comm.cc`` builds under ``build/``, never beside a source, and
the dist entry points (a ``dist_device_sync`` worker, the server) take
the card unless asked for the CPU."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import ast
import os
import subprocess
import sys

import pytest
import torch

from mxnet_tpu_torch import context
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.serving import Gateway, ServingError
from mxnet_tpu_torch.serving.generate import BlockPool, GenerativeDecoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = os.path.join(REPO, "mxnet_tpu_torch", "tools", "launch.py")
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")
# numpy's bfloat16: the card's machine need not have it, so the port
# imports it only inside the function that turns bf16 into numpy
LAZY = ("ml_dtypes",)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_pulls_in_no_jax_and_no_mxnet_tpu():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "before = set(sys.modules)\n"
        "import mxnet_tpu_torch, mxnet_tpu_torch.serving\n"
        "import mxnet_tpu_torch.serving.generate\n"
        "import mxnet_tpu_torch.serving.generate.migrate\n"
        "import mxnet_tpu_torch.parallel, mxnet_tpu_torch.parallel.mesh\n"
        "import mxnet_tpu_torch.parallel.collectives\n"
        "import mxnet_tpu_torch.parallel.layout\n"
        "import mxnet_tpu_torch.parallel.tensor_parallel\n"
        "import mxnet_tpu_torch.parallel.ulysses\n"
        "import mxnet_tpu_torch.parallel.ring_attention\n"
        "import mxnet_tpu_torch.parallel.pipeline\n"
        "import mxnet_tpu_torch.parallel.moe\n"
        "import mxnet_tpu_torch.ops.attention, mxnet_tpu_torch.ops._build\n"
        "import mxnet_tpu_torch.ops.contrib\n"
        "import mxnet_tpu_torch.ops.int8, mxnet_tpu_torch.ops.quantized\n"
        "import mxnet_tpu_torch.ndarray, mxnet_tpu_torch.symbol\n"
        "import mxnet_tpu_torch.executor, mxnet_tpu_torch.io\n"
        "import mxnet_tpu_torch.model, mxnet_tpu_torch.model_zoo\n"
        "import mxnet_tpu_torch.subgraph\n"
        "import mxnet_tpu_torch.contrib.quantization\n"
        "import mxnet_tpu_torch.ops.fused_opt\n"
        "import mxnet_tpu_torch.ops.optimizer_ops\n"
        "import mxnet_tpu_torch.gluon, mxnet_tpu_torch.gluon.model_zoo.vision\n"
        "import mxnet_tpu_torch.predictor, mxnet_tpu_torch.serving.variants\n"
        "from mxnet_tpu_torch.contrib.quantization import quantize_net\n"
        "import mxnet_tpu_torch.autograd, mxnet_tpu_torch.symbol.trace\n"
        "import mxnet_tpu_torch.optimizer, mxnet_tpu_torch.metric\n"
        "import mxnet_tpu_torch.lr_scheduler, mxnet_tpu_torch.gluon.loss\n"
        "import mxnet_tpu_torch.gluon.trainer\n"
        "import mxnet_tpu_torch.kvstore, mxnet_tpu_torch.kvstore.kvstore\n"
        "import mxnet_tpu_torch.kvstore.dist, mxnet_tpu_torch.kvstore.fault\n"
        "import mxnet_tpu_torch.kvstore.collective\n"
        "import mxnet_tpu_torch.kvstore.gradient_compression\n"
        "import mxnet_tpu_torch.kvstore_server, mxnet_tpu_torch._native\n"
        "import mxnet_tpu_torch.recordio, mxnet_tpu_torch.image\n"
        "import mxnet_tpu_torch.io.pipeline\n"
        "import mxnet_tpu_torch.io._pipeline_worker\n"
        "import mxnet_tpu_torch.gluon.data\n"
        "import mxnet_tpu_torch.gluon.data.vision\n"
        "import mxnet_tpu_torch.contrib.io\n"
        "import mxnet_tpu_torch.image.detection\n"
        "import mxnet_tpu_torch.ops.detection\n"
        "import mxnet_tpu_torch.telemetry, mxnet_tpu_torch.tracing\n"
        "import mxnet_tpu_torch.tracing.wire, mxnet_tpu_torch.profiler\n"
        "import mxnet_tpu_torch.monitor\n"
        "import runpy\n"
        f"runpy.run_path({LAUNCH!r})\n"
        "new = set(sys.modules) - before\n"
        f"print(sorted(m for m in new if m.split('.')[0] in "
        f"{FORBIDDEN + LAZY!r}))\n")
    # -I: no PYTHONPATH or user site, so nothing outside the port can
    # import jax first
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax_and_no_mxnet_tpu(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {name}"


def _module_imports(tree):
    """Names the module imports when it is imported: its top-level
    statements, inside ``if`` / ``try`` blocks too, not in functions."""
    todo, names = list(tree.body), []
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif isinstance(node, (ast.If, ast.Try)):
            todo += node.body + node.orelse + getattr(node, "finalbody", [])
            todo += [s for h in getattr(node, "handlers", []) for s in h.body]
    return names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_ml_dtypes_only_lazily(path):
    """No module of the port imports ml_dtypes when it is imported, and
    chip_smoke.py not at all (it reads bf16 values through torch)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    if path.endswith("chip_smoke.py"):
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names] + [
            n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 0]
    else:
        names = _module_imports(tree)
    assert not [n for n in names if n.split(".")[0] in LAZY], path


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _require_no_cuda()
    with pytest.raises(MXNetError):
        Gateway()
    with pytest.raises(MXNetError):
        GenerativeDecoder(vocab_size=10, d_model=8, num_layers=1,
                          num_heads=2)
    with pytest.raises(MXNetError):
        BlockPool(num_layers=1, num_heads=2, head_dim=4, block_tokens=4,
                  max_blocks=4)


def test_resolve_device_rules():
    assert context.resolve_device("cpu") == torch.device("cpu")
    assert context.cpu() == torch.device("cpu")
    assert context.gpu(1) == torch.device("cuda", 1)
    with pytest.raises(MXNetError):
        context.resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            context.resolve_device(None)
        with pytest.raises(MXNetError):
            context.resolve_device("cuda")


def test_decoder_and_gateway_devices_must_agree(monkeypatch):
    gw = Gateway(device="cpu")
    dec = GenerativeDecoder(vocab_size=10, d_model=8, num_layers=1,
                            num_heads=2, device="cpu")
    # a decoder whose weights live elsewhere than the gateway's device
    monkeypatch.setattr(GenerativeDecoder, "device",
                        property(lambda self: torch.device("meta")))
    try:
        with pytest.raises(ServingError):
            gw.register_generator("lm", dec, max_blocks=8,
                                  max_new_tokens=4, warmup=False)
    finally:
        gw.close()


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(MXNetError):
        _build.build_all()


def test_unsupported_dtype_raises():
    """float32 and bfloat16 decoders are served; float16, which no path
    of the JAX package produces, waits for its kernels and raises."""
    with pytest.raises(MXNetError):
        GenerativeDecoder(vocab_size=10, d_model=8, num_layers=1,
                          num_heads=2, dtype="float16", device="cpu")
    dec = GenerativeDecoder(vocab_size=10, d_model=8, num_layers=1,
                            num_heads=2, dtype="bfloat16", device="cpu")
    assert dec.dtype == torch.bfloat16


def _tiny_symbol():
    import mxnet_tpu_torch as tmx
    data = tmx.sym.var("data")
    return tmx.sym.FullyConnected(data, name="fc", num_hidden=2)


def test_symbolic_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    import numpy as np

    import mxnet_tpu_torch as tmx
    _require_no_cuda()
    assert tmx.current_context() == tmx.gpu(0)
    net = _tiny_symbol()
    with pytest.raises(MXNetError):
        tmx.nd.array([1.0, 2.0])
    with pytest.raises(MXNetError):
        tmx.nd.zeros((2, 2))
    with pytest.raises(MXNetError):
        net.simple_bind(grad_req="null", data=(3, 4))
    with tmx.cpu():
        ex = net.simple_bind(grad_req="null", data=(3, 4))
        args = dict(ex.arg_dict)
    with pytest.raises(MXNetError):
        net.bind(args=args)
    prefix = str(tmp_path / "tiny")
    tmx.model.save_checkpoint(prefix, 0, net, args, {})
    with pytest.raises(MXNetError):
        tmx.model.load_checkpoint(prefix, 0)
    with pytest.raises(MXNetError):
        list(tmx.io.NDArrayIter(np.zeros((4, 4), np.float32),
                                batch_size=2))


def test_cpu_scope_and_ctx_put_the_symbolic_path_on_the_cpu(tmp_path):
    import numpy as np

    import mxnet_tpu_torch as tmx
    net = _tiny_symbol()
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        ex = net.simple_bind(grad_req="null", data=(3, 4))
        out = ex.forward(data=tmx.nd.array(np.ones((3, 4), np.float32)))
        assert out[0].context == tmx.cpu()
        assert out[0]._data.device == torch.device("cpu")
        prefix = str(tmp_path / "tiny")
        tmx.model.save_checkpoint(prefix, 0, net, ex.arg_dict, {})
    _, arg, _ = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    assert all(v.context == tmx.cpu() for v in arg.values())
    assert tmx.nd.array([1.0], ctx=tmx.cpu()).context == tmx.cpu()


def _tiny_loss_symbol():
    import mxnet_tpu_torch as tmx
    return tmx.sym.SoftmaxOutput(_tiny_symbol(), name="softmax")


def test_training_entry_points_default_to_cuda_and_raise_without_it():
    import mxnet_tpu_torch as tmx
    _require_no_cuda()
    net = _tiny_loss_symbol()
    with pytest.raises(MXNetError):
        net.simple_bind(grad_req="write", data=(3, 4))
    with tmx.cpu():
        ex = net.simple_bind(grad_req="write", data=(3, 4))
    with pytest.raises(MXNetError):
        tmx.nd.zeros(ex.arg_dict["fc_weight"].shape)   # a momentum buffer


def test_training_path_runs_on_the_cpu_when_asked():
    import numpy as np

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.ops import fused_opt
    net = _tiny_loss_symbol()
    fused_opt.reset_launches()
    with tmx.cpu():
        ex = net.simple_bind(grad_req="write", data=(3, 4))
        ex.arg_dict["fc_weight"]._data.fill_(0.5)
        mom = tmx.nd.zeros((2, 4))
        ex.forward(is_train=True, data=tmx.nd.array(np.ones((3, 4))),
                   softmax_label=tmx.nd.array([0, 1, 1]))
        ex.backward()
        w = ex.arg_dict["fc_weight"]
        tmx.nd.sgd_mom_update(w, ex.grad_dict["fc_weight"], mom, out=w,
                              lr=0.1, momentum=0.9)
        tmx.nd.adam_update(w, ex.grad_dict["fc_weight"], tmx.nd.zeros(
            (2, 4)), tmx.nd.zeros((2, 4)), out=w, lr=0.1)
    assert w.context == tmx.cpu() and mom.context == tmx.cpu()
    assert ex.grad_dict["fc_weight"].context == tmx.cpu()
    assert float(np.abs(mom.asnumpy()).max()) > 0
    # a CPU tensor never reaches the kernel
    assert fused_opt.fused_sgd_mom.launches == 0
    assert fused_opt.fused_adam.launches == 0


def _tiny_gluon_net():
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix="iso_")
    with net.name_scope():
        net.add(nn.Conv2D(2, 3, in_channels=1), nn.Flatten(),
                nn.Dense(2, in_units=8))
    return net


def test_gluon_and_oneshot_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    import numpy as np

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import VariantSet
    _require_no_cuda()
    net = _tiny_gluon_net()
    with pytest.raises(MXNetError):
        net.initialize()
    net.initialize(ctx=tmx.cpu())
    prefix = str(tmp_path / "iso")
    with tmx.cpu():
        net(tmx.nd.array(np.zeros((1, 1, 4, 4), np.float32)))
    net.save_parameters(prefix + ".params")
    net.export(prefix)
    with pytest.raises(MXNetError):
        _tiny_gluon_net().load_parameters(prefix + ".params")
    with pytest.raises(MXNetError):
        SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                            prefix + "-0000.params")
    sym, arg, aux = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    with pytest.raises(MXNetError):
        Predictor(sym, arg, aux, {"data": (1, 1, 4, 4)})
    with pytest.raises(MXNetError):
        Predictor.from_checkpoint(prefix, 0, {"data": (1, 1, 4, 4)})
    with pytest.raises(MXNetError):
        VariantSet(sym, arg, aux, "data", (1, 4, 4))
    with pytest.raises(MXNetError):
        quantize_net(net, 1, np.zeros((2, 1, 4, 4), np.float32))
    with pytest.raises(MXNetError):
        Gateway().register("m", sym, arg, aux, {"data": (1, 4, 4)})


def test_gluon_and_oneshot_entry_points_run_on_the_cpu_when_asked(tmp_path):
    import numpy as np

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.predictor import Predictor
    net = _tiny_gluon_net()
    net.initialize(ctx=tmx.cpu())
    x = np.ones((2, 1, 4, 4), np.float32)
    with tmx.cpu():
        want = net(tmx.nd.array(x)).asnumpy()
    prefix = str(tmp_path / "iso")
    net.export(prefix)
    pred = Predictor.from_checkpoint(prefix, 0, {"data": x.shape},
                                     dev_type="cpu")
    np.testing.assert_allclose(pred.forward(data=x)[0], want, rtol=1e-6)
    gw = Gateway(device="cpu")
    try:
        gw.register_checkpoint("m", prefix, 0, {"data": (1, 4, 4)},
                               buckets=(2,))
        np.testing.assert_allclose(gw.infer("m", x)[0], want, rtol=1e-6)
    finally:
        gw.close()
    fwd, params = quantize_net(net, 2, x, ctx=tmx.cpu())
    out = fwd(params, x)
    assert out.device == torch.device("cpu") and out.shape == (2, 2)


def test_launcher_imports_no_torch_and_no_package():
    """The launcher runs as a script in a bare interpreter: loading it
    and printing its help imports neither torch nor any package of this
    repository."""
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({LAUNCH!r})\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'mxnet_tpu', 'mxnet_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout
    out = subprocess.run([sys.executable, "-I", LAUNCH, "--help"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    assert "--env-server" in out.stdout and "--restart-policy" in out.stdout


def test_pipeline_worker_imports_no_torch_and_no_package():
    """The decode worker runs as a plain script in a bare interpreter:
    loading it imports neither torch nor jax nor either package."""
    worker = os.path.join(REPO, "mxnet_tpu_torch", "io",
                          "_pipeline_worker.py")
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({worker!r}, run_name='worker')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'mxnet_tpu', 'mxnet_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_comm_builds_under_build_never_beside_a_source():
    from mxnet_tpu_torch import _native
    lib = _native.load_comm()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(str(_native.comm_library_path()))
    assert path.startswith(os.path.join(os.path.realpath(REPO), "build",
                                        "native") + os.sep)
    for src_dir in ("mxnet_tpu_torch/_native", "mxnet_tpu/_native"):
        assert os.path.dirname(path) != os.path.realpath(
            os.path.join(REPO, src_dir))
    assert not [f for f in os.listdir(os.path.join(
        REPO, "mxnet_tpu_torch", "_native")) if f.endswith(".so")]


def test_dist_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    """A serverless dist_device_sync worker takes its device from the
    context (NCCL on a card, gloo on the CPU, never chosen by probing),
    and the server its own from MXNET_KVSTORE_SERVER_DEVICE: both raise
    on a host without CUDA unless asked for the CPU."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.kvstore import dist
    _require_no_cuda()
    monkeypatch.setenv("DMLC_NUM_SERVER", "0")
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "1")
    with pytest.raises(MXNetError):
        tmx.kv.create("dist_device_sync")
    monkeypatch.delenv(dist.SERVER_DEVICE_ENV, raising=False)
    with pytest.raises(MXNetError):
        dist.server_device()
    monkeypatch.setenv(dist.SERVER_DEVICE_ENV, "cpu")
    assert dist.server_device() == torch.device("cpu")


def test_record_pipeline_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    """ImageRecordIter's batches, the device feeder and mx.image's
    NDArrays go to the card unless the caller asks for the CPU."""
    import io as _io

    import numpy as np
    from PIL import Image

    import mxnet_tpu_torch as tmx
    _require_no_cuda()
    buf = _io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="PNG")
    rec = str(tmp_path / "one.rec")
    w = tmx.recordio.MXRecordIO(rec, "w")
    w.write(tmx.recordio.pack(tmx.recordio.IRHeader(0, 1.0, 0, 0),
                              buf.getvalue()))
    w.close()
    kw = dict(path_imgrec=rec, data_shape=(3, 8, 8), batch_size=1)
    it = tmx.io.ImageRecordIter(**kw)
    with pytest.raises(MXNetError):
        it.next()
    it.close()
    with pytest.raises(MXNetError):
        tmx.io.DeviceFeeder(iter([]))
    with pytest.raises(MXNetError):
        tmx.image.imdecode(buf.getvalue())
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw)
        assert it.next().data[0].context == tmx.cpu()
        it.close()
        assert tmx.image.imdecode(buf.getvalue()).context == tmx.cpu()


def test_dataloader_raises_outside_a_cpu_scope_without_cuda():
    """Every loader path, the device feeder's included, raises when it
    starts outside ``with mx.cpu():`` on a host without CUDA; inside the
    scope its batches lie on the CPU, from pool threads too."""
    import numpy as np

    import mxnet_tpu_torch as tmx
    _require_no_cuda()
    ds = tmx.gluon.data.ArrayDataset(np.arange(8, dtype=np.float32))
    for kw in ({}, {"num_workers": 2}, {"prefetch_to_device": True}):
        loader = tmx.gluon.data.DataLoader(ds, batch_size=4, **kw)
        with pytest.raises(MXNetError):
            next(iter(loader))
        with tmx.cpu():
            assert all(b.context == tmx.cpu() for b in loader)
