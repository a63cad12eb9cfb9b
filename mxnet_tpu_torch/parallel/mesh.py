"""Device meshes, ``shard_map`` and placement over ``torch.device``s
(counterpart of ``mxnet_tpu/parallel/mesh.py``).

The JAX mesh is single-controller: one process drives every device of
a mesh. The port keeps that model in process. A :class:`Mesh` is a
numpy array of ``torch.device``s with axis names, and
:func:`shard_map` runs a function once for each mesh position, each run
on that position's local tensors, on a thread of its own from a pool
the mesh keeps (one thread per position). The collectives of
:mod:`.collectives` name mesh axes, as ``lax.psum`` and friends do, and
meet at a rendezvous keyed by the axis group and the call order:

- **deterministic**: a reduction is taken in rank order on the first
  rank's device, so a run gives the bits of the run before;
- **no hang**: a shard that raises aborts every rendezvous of its run,
  so the other shards raise too, and each rendezvous gives up after
  :data:`COLLECTIVE_TIMEOUT_S` seconds;
- **across devices**: tensors move between shards by ``.to(device)``
  (a device-to-device copy that orders the two devices' current
  streams), never through the host;
- **shards may share a device**: a mesh may name one device more than
  once when the caller passes that device list explicitly (one card
  then holds every shard, the counterpart of the JAX tests' virtual CPU
  devices). The default device list, every visible card, never repeats
  one.

Each shard thread runs under the caller's grad / inference mode, with
its own device current and, on every CUDA device of the mesh, the
caller's current stream, so work the caller queued before the call is
ordered before the shards' and the shards' before the caller's next.

Replica placement (:func:`replica_devices`, :func:`replica_slices`)
degrades gracefully when there are fewer devices than lanes: lanes and
slices wrap around the devices given, and the ``degraded`` flag says
when they share one.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import queue
import threading
import time
import weakref
from concurrent.futures import Future

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

#: seconds a rendezvous waits for the rest of its group (read at each
#: ``shard_map`` call)
COLLECTIVE_TIMEOUT_S = 300.0


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array (``jax.sharding.
    PartitionSpec``): each entry is None (replicated), an axis name, or
    a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec(%s)" % ", ".join(map(repr, self))


P = PartitionSpec


def entry_axes(entry):
    """The axis names of one spec entry, as a tuple."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _device_list(devices):
    """``devices`` resolved, or every visible CUDA device (raises on a
    host without CUDA)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(max(torch.cuda.device_count(), 1))]
    return [resolve_device(d) for d in devices]


def _handles(devices):
    """An explicit device list as given (placement compares devices by
    name only), or every visible CUDA device."""
    return list(devices) if devices is not None else _device_list(None)


class Mesh:
    """Devices laid out over named axes: ``devices`` is a numpy object
    array of ``torch.device``s, ``axis_names`` its axes, ``shape`` the
    ordered ``{axis: size}``. The mesh keeps the shard threads of
    :func:`shard_map`, started at its first call; :meth:`close` stops
    them."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(str(a) for a in axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} given "
                             f"{len(axis_names)} axis names")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)
        self._lock = threading.Lock()
        self._run_lock = threading.Lock()
        self._workers = None
        #: collectives of the last :func:`run_shards` call, by kind, and
        #: their counts, bytes (one rank's output) and first shapes
        self.last_collectives = {}
        self.last_collective_log = {}

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"

    def positions(self):
        """Every mesh position as ``{axis: index}``, in row-major
        order."""
        return [dict(zip(self.axis_names, idx))
                for idx in np.ndindex(self.devices.shape)]

    def device_at(self, coords):
        return self.devices[tuple(coords[a] for a in self.axis_names)]

    def _pool(self):
        with self._lock:
            if self._workers is None:
                self._workers = [_Worker(f"mxtorch-mesh{id(self):x}-{i}")
                                 for i in range(self.size)]
                # a mesh dropped unclosed (a Module's) ends its threads
                # when collected; at exit they stay parked (daemons)
                weakref.finalize(self, _Worker.release,
                                 self._workers).atexit = False
            return self._workers

    def close(self):
        """Stop the shard threads (idempotent; a later ``shard_map``
        starts new ones)."""
        with self._lock:
            workers, self._workers = self._workers, None
        for w in workers or ():
            w.stop()


class _Worker:
    """One shard thread: runs the callables handed to it, in order."""

    def __init__(self, name):
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                         name=name)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — read by the caller
                fut.set_exception(e)

    def submit(self, fn):
        fut = Future()
        self._q.put((fn, fut))
        return fut

    def stop(self):
        self._q.put(None)
        self._thread.join(timeout=30.0)

    @staticmethod
    def release(workers):
        """Tell ``workers`` to end after their queued work (no join)."""
        for w in workers:
            w._q.put(None)


def create_mesh(axes=None, devices=None):
    """Build a :class:`Mesh`.

    ``axes``: ordered ``{axis: size}``, e.g. ``{"dp": 2, "tp": 4}``;
    ``-1`` for at most one axis means "all remaining devices". Default:
    all devices on one ``"dp"`` axis. ``devices`` defaults to every
    visible CUDA device (raises without CUDA); an explicit list may name
    one device more than once."""
    devices = _device_list(devices)
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    axes = dict(axes)
    known = [s for s in axes.values() if s != -1]
    wild = [k for k, s in axes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    prod = math.prod(known) if known else 1
    if wild:
        if n % prod:
            raise ValueError(f"{n} devices not divisible by {prod}")
        axes[wild[0]] = n // prod
        prod = n
    if prod != n:
        raise ValueError(f"mesh {axes} needs {prod} devices, have {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(axes.values())), tuple(axes.keys()))


def auto_mesh_shape(n, axis_names=("dp", "tp", "sp")):
    """Factor ``n`` devices over the given axes, biggest axis first:
    8 -> {"dp": 2, "tp": 2, "sp": 2}, 4 -> {"dp": 2, "tp": 2, "sp": 1},
    6 -> {"dp": 3, "tp": 2, "sp": 1}."""
    shape = {a: 1 for a in axis_names}
    names = list(axis_names)
    i = 0
    rem = n
    while rem > 1:
        # smallest prime factor of rem goes to the current axis
        f = next((p for p in range(2, int(rem ** 0.5) + 1) if rem % p == 0),
                 rem)
        shape[names[i % len(names)]] *= f
        rem //= f
        i += 1
    return shape


# ---------------------------------------------------------------------------
# specs over a mesh
# ---------------------------------------------------------------------------

def _spec_axes(spec, mesh, ndim):
    """Per-dimension axis tuples of ``spec`` for an array of ``ndim``
    dims, checked against ``mesh``."""
    entries = tuple(spec or ())
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"array's {ndim} dims")
    dims = [entry_axes(e) for e in entries] + [()] * (ndim - len(entries))
    seen = set()
    for axes in dims:
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not in "
                                 f"the mesh's {mesh.axis_names}")
            if a in seen:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            seen.add(a)
    return dims


def _chunk_index(axes, coords, mesh):
    """Row-major index of ``coords`` over ``axes`` and their count."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def _local(x, spec, mesh, coords):
    """Position ``coords``' local block of the global ``x`` under
    ``spec``, on that position's device. A :class:`Sharded` laid out
    that way over ``mesh`` gives its own block, uncopied; any other
    Sharded is assembled first."""
    if isinstance(x, Sharded):
        if x.mesh is mesh and x.same_layout(spec):
            return x.local(coords)
        x = x.full()
    if not isinstance(x, torch.Tensor):
        return x
    sharded = False
    for dim, axes in enumerate(_spec_axes(spec, mesh, x.ndim)):
        if not axes:
            continue
        idx, n = _chunk_index(axes, coords, mesh)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split into {n} over {axes}")
        c = x.shape[dim] // n
        x = x.narrow(dim, idx * c, c)
        sharded = True
    x = x.to(mesh.device_at(coords))
    return x.contiguous() if sharded else x


def _assemble(spec, mesh, parts):
    """The global value of per-position ``parts`` (``{position index:
    local}``) under ``spec``, on the mesh's first device. Dims over an
    axis concatenate in axis order; over the axes the spec leaves out
    the value is taken from index 0."""
    positions = mesh.positions()
    first = parts[0]
    if not isinstance(first, torch.Tensor):
        return first
    dims = _spec_axes(spec, mesh, first.ndim)
    named = {a for axes in dims for a in axes}
    if not named:
        return first
    dev0 = mesh.devices.flat[0]
    shape = [s * math.prod(mesh.shape[a] for a in axes)
             for s, axes in zip(first.shape, dims)]
    out = torch.empty(shape, dtype=first.dtype, device=dev0)
    for i, coords in enumerate(positions):
        if any(coords[a] for a in mesh.axis_names if a not in named):
            continue
        part = parts[i]
        view = out
        for dim, axes in enumerate(dims):
            if axes:
                idx, _ = _chunk_index(axes, coords, mesh)
                view = view.narrow(dim, idx * part.shape[dim],
                                   part.shape[dim])
        view.copy_(part)
    return out


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`
    (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def shard(self, x):
        """``x`` cut into one local tensor per position, each on its
        position's device: a :class:`Sharded`. A block the spec cuts
        holds its own bytes (never a view into ``x``), so a position
        holds what its spec says it holds."""
        x = torch.as_tensor(x)
        blocks = []
        for coords in self.mesh.positions():
            b = _local(x, self.spec, self.mesh, coords)
            if b is not x and b.untyped_storage().nbytes() != b.nbytes:
                b = b.clone()
            blocks.append(b)
        return Sharded.from_locals(self.mesh, self.spec, blocks)


class Sharded:
    """A tensor laid out over a mesh (a sharded ``jax.Array``): one
    local tensor per position in ``shards`` (a numpy object array of the
    mesh's shape); :meth:`full` assembles it. :func:`shard_map` takes
    each position's own block of an argument laid out as its in_spec
    asks, and assembles any other. ``np.asarray`` gives the global
    value on the host."""

    def __init__(self, mesh, spec, shards):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*(spec or ()))
        self.shards = shards

    @classmethod
    def from_locals(cls, mesh, spec, parts):
        """A Sharded of per-position tensors given in
        :meth:`Mesh.positions` order."""
        shards = np.empty(mesh.size, dtype=object)
        for i, part in enumerate(parts):   # one by one: never as arrays
            shards[i] = part
        return cls(mesh, spec, shards.reshape(mesh.devices.shape))

    @property
    def sharding(self):
        return NamedSharding(self.mesh, self.spec)

    def _first(self):
        if self.shards is None:
            raise MXNetError("this Sharded value was donated to a step "
                             "and its shards are gone")
        return self.shards.flat[0]

    @property
    def dtype(self):
        return self._first().dtype

    @property
    def shape(self):
        """The global shape."""
        first = self._first()
        dims = _spec_axes(self.spec, self.mesh, first.ndim)
        return tuple(s * math.prod(self.mesh.shape[a] for a in axes)
                     for s, axes in zip(first.shape, dims))

    def same_layout(self, spec):
        """Whether ``spec`` lays a value out as this one is."""
        ndim = self._first().ndim
        return (_spec_axes(spec, self.mesh, ndim)
                == _spec_axes(self.spec, self.mesh, ndim))

    def local(self, coords):
        """The block at mesh position ``coords`` (``{axis: index}``)."""
        self._first()
        return self.shards[tuple(coords[a] for a in self.mesh.axis_names)]

    def full(self):
        """The global tensor, on the mesh's first device."""
        self._first()
        return _assemble(self.spec, self.mesh,
                         list(self.shards.reshape(-1)))

    def delete(self):
        """Drop the shards (what donating a value to a step does)."""
        self.shards = None

    def __array__(self, dtype=None, copy=None):
        out = self.full().detach().cpu().numpy()
        return out if dtype is None else out.astype(dtype)


def mesh_sharding(mesh, *spec):
    """``NamedSharding(mesh, PartitionSpec(*spec))`` shorthand."""
    return NamedSharding(mesh, PartitionSpec(*spec))


def shard_batch(batch, mesh, axis="dp"):
    """Place a host batch (a pytree of arrays) onto the mesh, split
    along the leading dim over ``axis`` and replicated over the other
    axes: a pytree of :class:`Sharded`."""
    sharding = NamedSharding(mesh, PartitionSpec(axis))
    return _map_leaves(sharding.shard, batch)


# ---------------------------------------------------------------------------
# pytrees (dict / list / tuple) with spec prefixes
# ---------------------------------------------------------------------------

def _map_leaves(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)) and not isinstance(t0, PartitionSpec):
        return type(t0)(_map_leaves(fn, *(t[i] for t in trees))
                        for i in range(len(t0)))
    return fn(*trees)


def _map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over ``trees`` with ``specs`` a pytree
    prefix of them (a spec or None covers a whole subtree)."""
    if specs is None or isinstance(specs, PartitionSpec):
        return _map_leaves(lambda *ls: fn(specs, *ls), *trees)
    t0 = trees[0]
    if isinstance(specs, dict):
        if not isinstance(t0, dict) or set(specs) != set(t0):
            raise ValueError(f"specs {specs} do not match the tree's keys")
        return {k: _map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in t0}
    if not isinstance(t0, (list, tuple)) or len(specs) != len(t0):
        raise ValueError(f"specs {specs} do not match the tree "
                         f"{type(t0).__name__}")
    return type(t0)(_map_specs(fn, s, *(t[i] for t in trees))
                    for i, s in enumerate(specs))


# ---------------------------------------------------------------------------
# shard_map and the rendezvous under the collectives
# ---------------------------------------------------------------------------

_local_state = threading.local()


class _Run:
    """One ``shard_map`` call: its rendezvous slots and the first
    failure of any of its shards (which aborts the rest)."""

    def __init__(self, mesh, timeout):
        self.mesh = mesh
        self.timeout = float(timeout)
        self.cond = threading.Condition()
        self.slots = {}
        self.error = None
        # kind -> {"count", "bytes" (one rank's output), "dtype",
        # "shapes" (the first 8)}
        self.collective_log = {}

    def fail(self, err):
        with self.cond:
            if self.error is None:
                self.error = err
            self.cond.notify_all()

    def check(self):
        """Raise when another shard of the run failed (caller holds
        ``cond``)."""
        if self.error is not None:
            raise MXNetError(f"collective aborted: a shard of this "
                             f"shard_map failed ({self.error!r})")


class _Slot:
    __slots__ = ("vals", "outs", "taken")

    def __init__(self):
        self.vals = {}
        self.outs = None
        self.taken = 0


class _Shard:
    """The thread-local state of one shard while it runs."""

    def __init__(self, run, coords, device):
        self.run = run
        self.coords = coords
        self.device = device
        self.seq = {}


def current_shard():
    """The running shard's state; raises outside :func:`shard_map`."""
    sh = getattr(_local_state, "shard", None)
    if sh is None:
        raise MXNetError("a collective must run inside shard_map (it "
                         "names a mesh axis)")
    return sh


def group_axes(axis_name):
    """``axis_name`` (a name or a tuple of names) as a checked tuple."""
    sh = current_shard()
    axes = entry_axes(axis_name)
    for a in axes:
        if a not in sh.run.mesh.shape:
            raise ValueError(f"unknown axis {a!r} (mesh axes "
                             f"{sh.run.mesh.axis_names})")
    return sh, axes


def rendezvous(axis_name, value, combine, kind="collective"):
    """Meet the other shards of this shard's group over ``axis_name``
    (the shards whose other coordinates equal this one's) at their next
    collective over those axes. Every member deposits ``value`` at its
    rank; the last to arrive calls ``combine(values, devices)`` with the
    values and the members' devices in rank order, which returns one
    result per rank; each member returns its own. The run counts one
    collective of ``kind`` a group."""
    sh, axes = group_axes(axis_name)
    run, mesh = sh.run, sh.run.mesh
    rank, n = _chunk_index(axes, sh.coords, mesh)
    other = tuple(sh.coords[a] for a in mesh.axis_names if a not in axes)
    seq = sh.seq.get(axes, 0) + 1
    sh.seq[axes] = seq
    key = (axes, other, seq)
    with run.cond:
        run.check()
        slot = run.slots.setdefault(key, _Slot())
        slot.vals[rank] = (value, sh.device)
        last = len(slot.vals) == n
    if last:
        ordered = [slot.vals[r] for r in range(n)]
        try:
            outs = combine([v for v, _ in ordered], [d for _, d in ordered])
        except BaseException as e:
            run.fail(e)
            raise
        with run.cond:
            slot.outs = outs
            _log_collective(run.collective_log, kind, outs[0])
            run.cond.notify_all()
    else:
        deadline = time.monotonic() + run.timeout
        with run.cond:
            while slot.outs is None:
                run.check()
                left = deadline - time.monotonic()
                if left <= 0:
                    err = MXNetError(
                        f"collective over {axes} timed out after "
                        f"{run.timeout} s: {len(slot.vals)} of {n} shards "
                        "arrived (a shard skipped it or hangs)")
                    run.error = run.error or err
                    run.cond.notify_all()
                    raise err
                run.cond.wait(left)
    with run.cond:
        out = slot.outs[rank]
        slot.taken += 1
        if slot.taken == n:
            del run.slots[key]
    return out


def _log_collective(log, kind, out):
    row = log.setdefault(kind, {"count": 0, "bytes": 0, "shapes": []})
    row["count"] += 1
    if isinstance(out, torch.Tensor):
        row["bytes"] += out.numel() * out.element_size()
        row.setdefault("dtype", str(out.dtype).rsplit(".", 1)[-1])
        if len(row["shapes"]) < 8:
            row["shapes"].append(tuple(out.shape))


def _shard_main(run, coords, device, f, args, streams, grad, inference):
    sh = _Shard(run, coords, device)
    _local_state.shard = sh
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode(inference))
            stack.enter_context(torch.set_grad_enabled(grad))
            if device.type == "cuda":
                stack.enter_context(torch.cuda.device(device))
                # a runtime call makes the device's context current on a
                # fresh shard thread (cuBLAS warns when it finds none)
                torch.cuda.current_stream(device).query()
            for s in streams:
                stack.enter_context(torch.cuda.stream(s))
            return f(*args)
    except BaseException as e:
        run.fail(e)
        raise
    finally:
        _local_state.shard = None


def shard_map(f, mesh=None, in_specs=None, out_specs=None, check_vma=None):
    """``f`` run once for each position of ``mesh`` on that position's
    local blocks (``jax.shard_map``): the returned function splits each
    argument by its spec in ``in_specs`` (a pytree prefix of the
    arguments; None or ``P()`` replicates), moves each block to its
    position's device, runs ``f`` on the mesh's shard threads, and
    assembles each output by its spec in ``out_specs`` on the mesh's
    first device (a dim over an axis concatenates in axis order; over
    the axes a spec leaves out, position index 0 gives the value: the
    port does not check that it is replicated, as ``check_vma=False``).
    Collectives inside ``f`` name the mesh's axes;
    :data:`COLLECTIVE_TIMEOUT_S` bounds each of their rendezvous. A shard
    that raises makes the others raise too, and the call re-raises the
    first failure. Calls on one mesh run one at a time."""
    if mesh is None:
        raise ValueError("shard_map needs a mesh")

    def run_sharded(*args):
        specs = tuple(in_specs) if isinstance(in_specs, list) else in_specs
        if isinstance(specs, tuple) and not isinstance(specs, PartitionSpec) \
                and len(specs) != len(args):
            raise ValueError(f"{len(specs)} in_specs for {len(args)} "
                             "arguments")
        local_args = [
            _map_specs(lambda s, x, c=c: _local(x, s, mesh, c), specs, args)
            for c in mesh.positions()]
        results = run_shards(mesh, f, local_args)
        return _map_specs(
            lambda s, *parts: _assemble(s, mesh, parts), out_specs,
            *results)
    return run_sharded


def run_shards(mesh, f, local_args):
    """``f(*local_args[i])`` at each position i of ``mesh`` (in
    :meth:`Mesh.positions` order), each on its shard thread as
    :func:`shard_map` runs it; returns the per-position results, in that
    order, unassembled. The counts of the collectives the call ran, by
    kind, are left in ``mesh.last_collectives``."""
    outer = getattr(_local_state, "shard", None)
    if outer is not None and outer.run.mesh is mesh:
        raise MXNetError("shard_map over a mesh inside a shard of that "
                         "same mesh")
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    cuda_devs = sorted({d for d in mesh.devices.flat if d.type == "cuda"},
                       key=str)
    streams = [torch.cuda.current_stream(d) for d in cuda_devs]
    positions = mesh.positions()
    with mesh._run_lock:
        run = _Run(mesh, COLLECTIVE_TIMEOUT_S)
        # each position runs in its own copy of the caller's context
        # variables, so a tracing span opened in a shard is a child of
        # the caller's span (a new thread would start with none)
        futs = [w.submit(lambda c=c, a=a, cx=contextvars.copy_context():
                         cx.run(_shard_main, run, c, mesh.device_at(c), f,
                                a, streams, grad, inference))
                for w, c, a in zip(mesh._pool(), positions, local_args)]
        results = []
        for fut in futs:
            try:
                results.append(fut.result())
            except BaseException:  # noqa: BLE001 — the root cause below
                results.append(None)
        mesh.last_collectives = {k: r["count"]
                                  for k, r in run.collective_log.items()}
        mesh.last_collective_log = run.collective_log
    if run.error is not None:
        raise run.error
    return results


# ---------------------------------------------------------------------------
# replica placement
# ---------------------------------------------------------------------------

def replica_devices(n, devices=None, exclude=()):
    """Devices for ``n`` replica lanes: ``(devices_list, degraded)``.

    ``devices`` defaults to every visible CUDA device (``cuda:0`` ...),
    and raises on a host without CUDA. Lanes wrap around the devices
    left after ``exclude`` (devices committed elsewhere, e.g. held by tp
    slices); when nothing is left they wrap onto the full list with
    ``degraded`` forced True. ``degraded`` is True when lanes share a
    device. Devices are compared by name (``str``)."""
    devs = _handles(devices)
    if not devs:
        raise MXNetError("replica_devices: no devices")
    excluded = {str(d) for d in exclude}
    pool = [d for d in devs if str(d) not in excluded]
    if not pool:
        return [devs[i % len(devs)] for i in range(n)], True
    return [pool[i % len(pool)] for i in range(n)], n > len(pool)


def replica_slices(n, tp, devices=None, exclude=()):
    """``n`` replica lanes of ``tp`` devices each, carved from disjoint
    contiguous runs of the device list after ``exclude``:
    ``(slices, degraded)``, ``slices`` a list of ``n`` tuples of ``tp``
    devices. When the free pool cannot hold one slice, the full list is
    used (``degraded``); slices that run past the pool wrap
    (``degraded``). Raises when the list has fewer than ``tp`` devices.
    ``devices`` defaults to every visible CUDA device, which never
    repeats one, so there a slice is always ``tp`` distinct devices; an
    explicit list may repeat a device (``[cuda:0, cuda:0]``: one card
    holds both shards), and a slice that then holds a device twice is
    ``degraded`` as well. Devices are compared by name (``str``), so an
    explicit list may hold any device handles."""
    n, tp = int(n), int(tp)
    if n < 1 or tp < 1:
        raise ValueError(
            f"replica_slices: need n >= 1 slices of tp >= 1 devices, "
            f"got n={n}, tp={tp}")
    devs = _handles(devices)
    excluded = {str(d) for d in exclude}
    pool = [d for d in devs if str(d) not in excluded]
    degraded = False
    if len(pool) < tp:
        if len(devs) < tp:
            raise ValueError(
                f"replica_slices: cannot carve a tp={tp} slice from "
                f"{len(devs)} device(s) — a mesh cannot repeat a "
                "device")
        pool = devs
        degraded = True
    slices = []
    for i in range(n):
        start = i * tp
        if start + tp <= len(pool):
            slices.append(tuple(pool[start:start + tp]))
        else:
            degraded = True
            slices.append(tuple(pool[(start + j) % len(pool)]
                                for j in range(tp)))
    if any(len({str(d) for d in s}) < len(s) for s in slices):
        degraded = True
    return slices, degraded


def free_pool(devices=None, held=()):
    """The devices NOT named in ``held`` (string identity, order
    preserved): what a workload may place on."""
    held_names = {str(d) for d in held}
    return [d for d in _handles(devices) if str(d) not in held_names]


# degraded wraps already warned, keyed (ask, devices): a scale storm
# re-enters the placement on every event, and the same unchanged wrap
# warns once
_DEGRADE_WARNED = set()
_DEGRADE_LOCK = threading.Lock()


def should_warn_degraded(n, devices):
    """True exactly once per (ask, devices) combination."""
    key = (int(n), tuple(str(d) for d in devices))
    with _DEGRADE_LOCK:
        if key in _DEGRADE_WARNED:
            return False
        _DEGRADE_WARNED.add(key)
        return True


def _reset_degrade_warnings():
    """Test hook: forget which (ask, devices) wraps already warned."""
    with _DEGRADE_LOCK:
        _DEGRADE_WARNED.clear()
