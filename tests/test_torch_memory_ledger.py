"""The port's liveness ledger (``profiling.memory``: ``buffer_intervals``,
``build_memory_ledger``, ``from_fn`` / ``from_compiled``, ``summarize``,
``diff``, ``load`` / ``dump``), the OOM postmortem's ranked table, and
``python -m mxnet_tpu_torch.profiling.bench_ledger``, against the JAX
package's documents (tests/test_memory.py):

- a chain whose peak is counted by hand: the peak, the op at it, and the
  buffers live there (arguments, temporaries, outputs), in the JAX
  document's keys;
- in-place updates and views add no buffer; a hand kernel's scratch is
  none, what it hands on is;
- the OOM postmortem carries the ranked table of the program it is given;
- the bench pass's ``tiny`` stage as a subprocess: bounded summaries and
  ``stage_error`` for a stage it does not know.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os
import subprocess
import sys

import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.profiling import memory as jmemory
from mxnet_tpu_torch.profiling import memory, optrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIB = 1024


def _chain(x, w):
    """x (16 x 16 f32, 1 KiB) and w (16 x 16): a = x @ w, b = relu(a),
    c = b * 2, d = c.sum(). Live at the product: x, w, a (3 KiB); at
    relu: x, w, a, b (4 KiB, the peak); a dies there; at the multiply:
    x, w, b, c (4 KiB); at the sum: x, w, c, d."""
    a = x @ w
    b = torch.relu(a)
    c = b * 2
    return c.sum()


def _xw():
    g = torch.Generator().manual_seed(0)
    return torch.randn(16, 16, generator=g), torch.randn(16, 16, generator=g)


def test_chain_peak_counted_by_hand():
    doc = memory.from_fn(_chain, *_xw())
    assert doc["peak_live_bytes"] == 4 * KIB
    assert doc["peak_index"] == 1 and doc["peak_instr"] == "1:relu"
    kinds = sorted((b["hlo_op"], b["kind"], b["bytes"])
                   for b in doc["buffers"])
    assert kinds == [("mm", "temp", KIB), ("parameter", "argument", KIB),
                     ("parameter", "argument", KIB), ("relu", "temp", KIB)]
    t = doc["totals"]
    assert (t["instructions"], t["buffers"], t["live_at_peak"]) == (4, 6, 4)
    assert (t["arg_bytes"], t["output_bytes"]) == (2 * KIB, 4)
    # the JAX package's document keys, at every level
    jdoc = jmemory.build_memory_ledger(
        "HloModule m\n\nENTRY %e (p: f32[4]) -> f32[4] {\n"
        "  ROOT %p = f32[4]{0} parameter(0)\n}\n", fn_map={}, rule_map={})
    assert set(doc) - {"program", "device"} == set(jdoc)
    assert set(doc["totals"]) == set(jdoc["totals"])
    assert set(doc["buffers"][0]) >= {"buffer", "hlo_op", "op", "bytes",
                                      "kind", "born", "dies"}
    assert {g["op"] for g in doc["by_op"]} == {"parameter", "mm", "relu"}


def test_inplace_and_views_add_no_buffer():
    def f(x):
        y = x * 3                   # one new buffer
        y.add_(1).mul_(2)           # in place: none
        return y.view(-1)[:8].sum()  # views: none; the sum: 4 bytes
    trace, _ = optrace.record(f, torch.ones(8, 8))
    assert [e["name"] for e in trace.entries] == ["mul", "add_", "mul_",
                                                  "sum"]
    assert [b["bytes"] for b in trace.buffers] == [256, 256, 4]
    assert memory.build_memory_ledger(trace)["peak_live_bytes"] == 512 + 4


def test_hand_kernel_scratch_is_not_a_buffer():
    """The flash wrapper on the CPU runs its plain version (scores,
    softmax, products: temporaries several times the output); the ledger
    holds q, k, v and the output, as on the card."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 64, 8, generator=g) for _ in range(3))
    doc = memory.from_fn(lambda: tmx.ops.attention.flash_attention(
        q, k, v, causal=True))
    assert doc["peak_live_bytes"] == 4 * q.numel() * 4
    assert doc["totals"]["buffers"] == 4


def test_summarize_diff_load_dump(tmp_path):
    before = memory.from_fn(_chain, *_xw())
    after = memory.from_fn(lambda x, w: (x @ w).sum(), *_xw())
    s = memory.summarize(before, top=2)
    assert s["peak_live_mb"] == round(4 * KIB / 1e6, 3)
    assert len(s["top"]) == 2 and set(s) == set(jmemory.summarize(
        before, top=2))
    d = memory.diff(before, after)
    assert d["peak_delta"] == after["peak_live_bytes"] - 4 * KIB
    assert set(d) == {"peak_before", "peak_after", "peak_delta", "by_op"}
    path = str(tmp_path / "m.json")
    memory.dump(before, path)
    assert memory.load(path) == json.loads(json.dumps(before))
    with pytest.raises(ValueError):
        memory.load(_write(tmp_path / "x.json", {"kind": "other"}))
    # buffer_intervals of the same trace: the ledger's intervals
    trace, _ = optrace.record(_chain, *_xw())
    iv = memory.buffer_intervals(trace)
    assert sorted((b["def"], b["last_use"], b["kind"]) for b in iv.values()) \
        == [(0, 1, "temp"), (0, 3, "argument"), (0, 3, "argument"),
            (1, 2, "temp"), (2, 3, "temp"), (3, 3, "output")]


def _write(path, doc):
    path.write_text(json.dumps(doc))
    return str(path)


def test_oom_postmortem_carries_the_ranked_table(tmp_path):
    x, w = _xw()
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 9 GiB")
    doc = memory.oom_postmortem(
        err, source="executor", path=str(tmp_path / "oom.json"),
        hlo_text=lambda: optrace.record(_chain, x, w)[0])
    led = doc["memory_ledger"]
    assert led["kind"] == "memory_ledger"
    assert led["peak_live_bytes"] == 4 * KIB
    assert [b["bytes"] for b in led["buffers"]] == [KIB] * 4
    saved = json.loads((tmp_path / "oom.json").read_text())
    assert saved["memory_ledger"]["peak_instr"] == "1:relu"
    assert "memory_ledger_pending" not in saved
    # no program given: no table, as in the JAX package
    bare = memory.oom_postmortem(err, path=str(tmp_path / "b.json"))
    assert "memory_ledger" not in bare


def _bench(tmp_path, stages):
    out = tmp_path / "ledger.json"
    env = dict(os.environ, MXTPU_LEDGER_OUT=str(out),
               MXTPU_LEDGER_STAGES=stages, PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.profiling.bench_ledger"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=60)
    return proc, json.loads(out.read_text())


def test_bench_ledger_tiny_stage_and_stage_error(tmp_path):
    proc, doc = _bench(tmp_path, "tiny,nonsense")
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert doc["kind"] == "bench_cost_ledger" and doc["backend"] == "meta"
    tiny = doc["stages"]["tiny"]
    assert "stage_error" not in tiny
    assert len(tiny["top"]) <= 10
    assert set(tiny["top"][0]) == {"op", "gflops", "mb", "est_ms", "share",
                                   "bound"}
    # 2 x outputs x in-channels x 9 a convolution: the first's forward
    # and weight gradient, the second's forward and both gradients
    conv1, conv2 = (2 * 8 * 16 * 32 * 32 * 9 * c for c in (3, 16))
    products = {g["op"]: g["gflops"] for g in tiny["top"]}
    assert products["convolution"] == round((conv1 + conv2) / 1e9, 3)
    assert products["convolution_backward"] == round(
        (conv1 + 2 * conv2) / 1e9, 3)
    assert tiny["memory"]["peak_live_mb"] > 0
    assert len(tiny["memory"]["top"]) <= 3
    assert "unknown ledger stage" in doc["stages"]["nonsense"]["stage_error"]
    assert len(json.dumps(doc)) < 8000
