"""Shared set-up of the port's observability parity tests
(``test_torch_telemetry.py``, ``test_torch_tracing.py``,
``test_torch_profiler.py``): the same small flows run through the JAX
package and the port, and the normalizations their results are compared
under.

Each flow resets both planes of the package it runs (registry, step
state, spans, the model-health state), runs on the CPU (the port inside
``with mx.cpu():``) and returns the package's metric snapshot and spans.
The model-health plane and the live-tensor census are on in both
packages (their default), so the ``mx_health_*`` and
``mx_memory_live_*`` families and the step spans' health attrs are
compared too.
"""
import contextlib

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

# families the schema comparison leaves out, each for its reason
EXCLUDED_FAMILIES = {
    # the port counts its nvcc kernel builds under these names; the JAX
    # package counts XLA compiles and jaxpr traces: different events
    "mx_jit_compiles_total": "kernel builds vs XLA compiles",
    "mx_jit_compile_seconds_total": "kernel builds vs XLA compiles",
    "mx_jit_traces_total": "the port traces nothing",
    "mx_jit_trace_seconds_total": "the port traces nothing",
    # the host dependency engine (engine.py) waits for its port
    "mx_engine_eager_ops_total": "engine.py not ported",
    "mx_engine_queue_depth": "engine.py not ported",
    "mx_host_engine_ops_total": "engine.py not ported",
    "mx_host_engine_inflight": "engine.py not ported",
}

# span attributes that are measurements of time, not structure
TIME_ATTRS = ("_ns",)


def scope(mx):
    """The CPU scope a flow of ``mx`` runs in."""
    return mx.cpu() if mx is tmx else contextlib.nullcontext()


def reset(mx):
    """Both planes of ``mx`` on and empty, its health state cleared."""
    mx.telemetry.metrics.set_enabled(True)
    mx.telemetry.metrics.registry().reset()
    mx.telemetry.step.reset()
    mx.tracing.set_sample(1.0)
    mx.tracing.reset()
    mx.profiling.health.reset()


def reset_both():
    reset(tmx)
    reset(jmx)


@contextlib.contextmanager
def jax_health_off():
    """The JAX package's health probes off, and their policy put back
    after (a test process runs other files after these): for a test that
    drives the JAX package's plane against something the port's health
    plane has no part in."""
    from mxnet_tpu.profiling import health
    saved = health._policy[0]
    health._policy[0] = None
    try:
        yield
    finally:
        health._policy[0] = saved


def data(rows=32, feat=8, out=4, seed=7):
    rs = np.random.RandomState(seed)
    return (rs.rand(rows, feat).astype("float32"),
            rs.rand(rows, out).astype("float32"))


def trainer_flow(mx, rows=32, batch=16):
    """A gluon Dense trained by a Trainer over a ``local`` KVStore, fed by
    an NDArrayIter: every seam of a training step (data, comm, step)."""
    x, y = data(rows)
    with scope(mx):
        net = mx.gluon.nn.Dense(4, in_units=8, prefix="obs_")
        net.initialize(mx.initializer.Zero())
        kv = mx.kv.create("local")
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05}, kvstore=kv)
        loss_fn = mx.gluon.loss.L2Loss()
        for b in mx.io.NDArrayIter(x, y, batch_size=batch):
            with mx.autograd.record():
                loss = loss_fn(net(b.data[0]), b.label[0])
            loss.backward()
            trainer.step(batch)


def softmax_net(mx, hidden=4):
    d = mx.sym.var("data")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(d, num_hidden=hidden, name="fc"),
        name="softmax")


def module_iter(mx, rows=32, batch=8):
    rs = np.random.RandomState(3)
    x = rs.rand(rows, 8).astype("float32")
    y = rs.randint(0, 4, (rows,)).astype("float32")
    return mx.io.NDArrayIter(x, y, batch_size=batch,
                             label_name="softmax_label")


def module_fit(mx, contexts=None, epochs=2, monitor=None):
    """``Module.fit`` of a FullyConnected + SoftmaxOutput net (2 epochs
    of 4 batches), on the CPU or over ``contexts``."""
    with scope(mx):
        if contexts is None:
            contexts = mx.cpu()
        mod = mx.mod.Module(softmax_net(mx), context=contexts)
        mod.fit(module_iter(mx), num_epoch=epochs,
                initializer=mx.initializer.Xavier(), monitor=monitor,
                optimizer_params={"learning_rate": 0.1})
    return mod


def executor_flow(mx):
    """``simple_bind`` of a FullyConnected, one training forward and its
    backward."""
    x, _ = data(4)
    with scope(mx):
        ex = softmax_net(mx).simple_bind(
            mx.cpu() if mx is tmx else None, data=(4, 8),
            softmax_label=(4,))
        ex.forward(is_train=True, data=mx.nd.array(x))
        ex.backward()
    return ex


def _touched(fam):
    return any(s.get("value", s.get("count", 0)) for s in fam["series"])


def family_schemas(a, b):
    """{name: (type, help, label names)} of each snapshot, over the
    families either flow recorded into (a registry reset keeps every
    family earlier code created, at zero: those a flow left at zero are
    not its), the excluded ones left out; a family the other snapshot
    lacks is None there."""
    names = {n for snap in (a, b) for n, fam in snap["metrics"].items()
             if _touched(fam)} - set(EXCLUDED_FAMILIES)
    out = []
    for snap in (a, b):
        schema = {}
        for name in names:
            fam = snap["metrics"].get(name)
            schema[name] = None if fam is None else (
                fam["type"], fam["help"],
                tuple(sorted({k for s in fam["series"]
                              for k in s["labels"]})))
        out.append(schema)
    return out


def event_counts(snap, names):
    """{(family, labels): count} for event families: counters' values,
    histograms' observation counts."""
    out = {}
    for name in names:
        fam = snap["metrics"].get(name)
        if fam is None:
            continue
        for s in fam["series"]:
            n = s["count"] if "count" in s else s["value"]
            if n:
                out[name, tuple(sorted(s["labels"].items()))] = n
    return out


def span_tree(spans):
    """The structure of a span list: for each span (in start order) its
    name, cat, its parent's name (None for a root) and its attributes but
    those that measure time. Raises if a parent link points at a span
    not in the list (an orphan)."""
    by_id = {s["span"]: s for s in spans}
    out = []
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        parent = s["parent"]
        if parent is not None and parent not in by_id:
            raise AssertionError(f"orphan span {s['name']}: parent "
                                 f"{parent:x} not recorded")
        attrs = {k: v for k, v in (s["attrs"] or {}).items()
                 if not k.endswith(TIME_ATTRS)}
        out.append((s["name"], s["cat"],
                    by_id[parent]["name"] if parent else None, attrs))
    return out


def roots(spans):
    return [s for s in spans if s["parent"] is None]


class SyncCounter:
    """Counts the calls that make the host wait for a device value:
    ``Tensor.item`` / ``tolist`` / ``cpu`` and ``torch.cuda.synchronize``
    (patched for the duration of the ``with``)."""

    NAMES = ("item", "tolist", "cpu")

    def __init__(self):
        self.count = 0

    def __enter__(self):
        import torch
        self._saved = [(torch.Tensor, n, getattr(torch.Tensor, n))
                       for n in self.NAMES]
        self._saved.append((torch.cuda, "synchronize",
                            torch.cuda.synchronize))
        for owner, name, fn in self._saved:
            setattr(owner, name, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def counted(*a, **k):
            self.count += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False
