"""The port stands alone and never runs on the CPU unasked:
``mxnet_tpu_torch`` (and ``chip_smoke.py``) import neither ``jax`` nor
``mxnet_tpu``, its entry points default to the first CUDA card and
raise on a host without one, and its kernel build raises instead of
falling back when ``nvcc`` is missing."""
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
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


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
        "import mxnet_tpu_torch.ops.attention, mxnet_tpu_torch.ops._build\n"
        "new = set(sys.modules) - before\n"
        f"print(sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r}))\n")
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


def test_decoder_and_gateway_devices_must_agree():
    gw = Gateway(device="cpu")
    dec = GenerativeDecoder(vocab_size=10, d_model=8, num_layers=1,
                            num_heads=2, device="cpu")
    dec.to("meta")
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
    with pytest.raises(MXNetError):
        GenerativeDecoder(vocab_size=10, d_model=8, num_layers=1,
                          num_heads=2, dtype="bfloat16", device="cpu")
