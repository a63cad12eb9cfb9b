"""Cost-ledger pass over ResNet-50 v1's programs (the port of
``mxnet_tpu/profiling/bench_ledger.py``), run as::

    python -m mxnet_tpu_torch.profiling.bench_ledger

It prices the port's own programs, traced on ``meta`` tensors (shapes
and dtypes, no data, no device), so batch 128 costs a few seconds of
one CPU core, and writes their cost and memory summaries to
``MXTPU_LEDGER_OUT`` (default ``bench_ledger.json``). The file is
written atomically after every stage: a pass killed mid-way leaves the
finished stages behind, and a stage that fails records ``stage_error``
(never ``error``: bench gates read a top-level ``"error"`` as a failed
measurement) and the exit code is 1.

Stages (``MXTPU_LEDGER_STAGES``, comma-separated; batch
``MXTPU_BENCH_BATCH``, default 128):

- ``infer_bf16``: the model zoo's ResNet-50 v1 graph
  (``model_zoo/resnet50_v1-symbol.json``) forward in bfloat16 through
  the graph executor;
- ``train_bf16``: the same graph's training step in bfloat16: forward
  (batch statistics), softmax cross-entropy, backward, and
  ``sgd_mom_update`` (K2) on each of its 161 trainable tensors;
- ``tiny``: two 3x3 convolutions' SGD step on (8, 3, 32, 32), traced in
  well under a second.

FLOPs and bytes are properties of the program's ops and shapes, so the
ledger of a meta trace is the card's; the document says how it was
made (``backend: "meta"``).
"""
from __future__ import annotations

import os
import sys
import time

import torch


def _tiny_step():
    w1 = torch.zeros(16, 3, 3, 3, device="meta", requires_grad=True)
    w2 = torch.zeros(16, 16, 3, 3, device="meta", requires_grad=True)
    x = torch.zeros(8, 3, 32, 32, device="meta")

    def step():
        y = torch.relu(torch.nn.functional.conv2d(x, w1, padding=1))
        y = torch.nn.functional.conv2d(y, w2, padding=1)
        loss = (y * y).mean()
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        with torch.no_grad():
            w1.sub_(0.01 * g1)
            w2.sub_(0.01 * g2)
        return loss

    return step, 8


def _resnet_values(batch, dtype, train):
    from ..model_zoo import load_symbol
    sym = load_symbol("resnet50_v1")
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(batch, 3, 224, 224))[0]))
    aux = dict(zip(sym.list_auxiliary_states(),
                   sym.infer_shape(data=(batch, 3, 224, 224))[2]))
    values = {}
    for name, shape in {**shapes, **aux}.items():
        t = torch.empty(shape, dtype=dtype, device="meta")
        if train and name in shapes and name != "data":
            t.requires_grad_(True)
        values[name] = t
    return sym, values


def _stage_program(stage, batch):
    """(callable, items per call) of a stage's program."""
    from ..executor import _run
    from ..ops import registry as _reg
    if stage == "tiny":
        return _tiny_step()
    if stage == "infer_bf16":
        sym, values = _resnet_values(batch, torch.bfloat16, train=False)
        return (lambda: _run(sym, values, training=False)[0]), batch
    if stage == "train_bf16":
        sym, values = _resnet_values(batch, torch.bfloat16, train=True)
        params = [v for v in values.values() if v.requires_grad]
        moms = [torch.empty_like(p, requires_grad=False) for p in params]
        labels = torch.empty(batch, dtype=torch.int64, device="meta")
        update = _reg.get("sgd_mom_update")

        def step():
            with torch.enable_grad():
                out = _run(sym, values, training=True)[0][0]
                loss = torch.nn.functional.cross_entropy(out.float(),
                                                         labels)
                grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g, m in zip(params, grads, moms):
                    update(p.detach(), g, m, lr=0.1, momentum=0.9)
            return loss
        return step, batch
    raise ValueError("unknown ledger stage %r" % (stage,))


def main(argv=None):
    out_path = os.environ.get("MXTPU_LEDGER_OUT") or "bench_ledger.json"
    stages = [s.strip() for s in os.environ.get(
        "MXTPU_LEDGER_STAGES", "infer_bf16,train_bf16").split(",")
        if s.strip()]
    batch = int(os.environ.get("MXTPU_BENCH_BATCH", "128"))

    from . import ledger, memory, optrace

    doc = {"version": 1, "kind": "bench_cost_ledger",
           "backend": "meta", "batch": batch, "stages": {}}
    rc = 0
    for stage in stages:
        stage_t0 = time.time()
        try:
            fn, items = _stage_program(stage, batch)
            trace, _ = optrace.record(fn, module=stage)
            led = ledger.build_ledger(trace)
            summary = ledger.summarize(led)
            summary["gflops_per_item"] = round(
                led["totals"]["flops"] / items / 1e9, 3)
            summary["trace_s"] = round(time.time() - stage_t0, 1)
            try:
                summary["memory"] = memory.summarize(
                    memory.build_memory_ledger(trace), top=3)
            except Exception as e:  # noqa: BLE001 — memory must not
                summary["memory"] = {   # sink the flop ledger
                    "stage_error": repr(e)[:120]}
            doc["stages"][stage] = summary
        except Exception as e:  # noqa: BLE001 — a failed stage must not
            doc["stages"][stage] = {"stage_error": repr(e)[:300]}
            rc = 1
        ledger.dump(doc, out_path)
    return rc


if __name__ == "__main__":
    sys.exit(main())
