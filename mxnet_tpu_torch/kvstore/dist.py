"""Multi-process KVStore worker and server glue over the native
transport (the port of ``mxnet_tpu/kvstore/dist.py``).

Roles follow the reference's launcher contract (ref: tools/launch.py +
the dmlc-core tracker): ``DMLC_ROLE`` is ``worker`` or ``server``, the
server's address is ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` (server
i listens on root + i), the worker count ``DMLC_NUM_WORKER``. The data
plane is ``_native/comm.cc`` (the ps-lite equivalent): ranks assigned at
connect, BSP merge rounds, barriers, and an optional server-side
optimizer shipped as a pickled blob (ref: python/mxnet/kvstore.py:450-495
set_optimizer). The wire carries float32 host bytes: a worker's push
copies its gradient off its device once, a pull writes into the
caller's tensor on its device.

The server applies the pickled optimizer (this package's optimizer
classes) on its device: the card unless the job asks for the CPU with
``MXNET_KVSTORE_SERVER_DEVICE=cpu`` in the server's environment (the
launcher's ``--env-server``), resolved by ``context.resolve_device`` as
every entry point resolves its device (no CUDA and no ``cpu`` asked
for: it raises). Its optimizer states stay on that device.

Recovery (ref: kvstore_dist.h:118-123 dead-node detection + ps-lite
resend-on-timeout): every request carries an increasing id, so when a
request dies with its connection the worker reconnects (reclaiming its
rank), pins the failed id and resends, idempotent at the server. Retries
run under exponential backoff with jitter until
``MXNET_KVSTORE_RECOVERY_BUDGET_MS`` is spent, then raise one
``MXNetError``; with the budget 0 (the default) the transport fails
fast. With ``MXNET_KVSTORE_SNAPSHOT_PATH`` set the server snapshots its
whole state on SIGTERM and restores it on start, so a server the
launcher restarts (``--restart-policy=server``) rejoins with its state.
Deterministic fault injection: ``MXNET_KVSTORE_FAULT_PLAN``
(:mod:`.fault`).

Observability: every request runs inside a ``kv.<op>`` span whose
``(trace_id, span_id)`` rides the request header; a traced server
records the matching ``server_recv:<op>`` child span
(``tracing/wire.py``) and a ``server_update`` span under the push that
completed a round. Each recovery incident goes to
``profiler.note_recovery``. ``send_profiler_command`` runs a profiler
directive in the server process (``set_config`` / ``set_state`` /
``pause`` / ``resume`` / ``dump``, ``metrics_snapshot`` and
``trace_dump``; :func:`_apply_profiler_directive`), the channel of
``telemetry.export.pull_server_metrics`` and
``tracing.export.pull_server_trace``. Not ported yet, and refused
rather than dropped: row-granular pulls (they need sparse NDArray).
"""
from __future__ import annotations

import ctypes
import json
import os
import pickle
import signal
import sys
import time

import numpy as np
import torch
# at module scope: the updater runs on a transport thread while, in a
# server process, the main thread may still be importing the package
from numpy.ctypeslib import as_array

from .. import _native
from .. import checkpoint as ckpt
# at module scope too: the server's updater records into them on a
# transport thread while the main thread may still be importing
from .. import profiler
from .. import tracing as _tracing
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray import NDArray
from ..telemetry import metrics as _tm_metrics
from . import fault as fault_mod

# server-process families (a worker pulls them into its own dump with
# the metrics_snapshot directive)
_server_met = _tm_metrics.lazy_metrics(lambda reg: {
    "updates": reg.counter(
        "mx_server_updates_total",
        "merge-round optimizer updates applied",
        labelnames=("key",)),
    "update_s": reg.histogram(
        "mx_server_update_seconds",
        "server-side optimizer update latency").labels(),
})

CMD_SYNC_MODE = 1
CMD_STOP = 2
CMD_SERVER_PROFILER = 3
# profiler directives ride the server's blob FIFO beside pickled
# optimizers; pickles start with b"\x80", so this prefix is unambiguous
PROF_MAGIC = b"PROF\x00"
CMD_SET_OPTIMIZER = 4
# exit code of a SIGTERM'd server that snapshotted its state: tells the
# launcher "restartable death with state on disk" apart from a clean
# stop (0, never restarted) and a crash (anything else)
SERVER_RESTART_EXITCODE = 17
# the server's device, for the job to set through the launcher's
# --env-server (cpu, gpu, cuda or cuda:N; the card when unset)
SERVER_DEVICE_ENV = "MXNET_KVSTORE_SERVER_DEVICE"


def role():
    return os.environ.get("DMLC_ROLE", "worker")


def server_address():
    uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
    return uri, port


def num_workers_env():
    return int(os.environ.get("DMLC_NUM_WORKER", "1"))


def num_servers_env():
    return int(os.environ.get("DMLC_NUM_SERVER", "1"))


def server_ports():
    """Every server's port: root_port + server_index (the launcher's
    contract; multi-server key sharding dials them all)."""
    uri, root = server_address()
    return uri, [root + i for i in range(num_servers_env())]


def request_timeout_ms():
    return int(os.environ.get("MXNET_KVSTORE_REQUEST_TIMEOUT_MS",
                              "120000"))


def recovery_budget_ms():
    """Total wall-clock the client may spend recovering ONE request
    (reconnect + resend loop). 0 disables recovery: fail fast."""
    return int(os.environ.get("MXNET_KVSTORE_RECOVERY_BUDGET_MS", "0"))


def recovery_backoff_ms():
    return int(os.environ.get("MXNET_KVSTORE_RECOVERY_BACKOFF_MS", "50"))


def recovery_backoff_max_ms():
    return int(os.environ.get("MXNET_KVSTORE_RECOVERY_BACKOFF_MAX_MS",
                              "2000"))


def server_device():
    """The device the server's optimizer runs on: the job's
    ``MXNET_KVSTORE_SERVER_DEVICE``, else the current context's
    (``cuda:0``), through ``resolve_device``."""
    name = os.environ.get(SERVER_DEVICE_ENV) or None
    if name == "gpu":
        name = "cuda"
    return resolve_device(name)


_client_faults_installed = False


def _ensure_client_faults(lib):
    """Install the worker-side rules of MXNET_KVSTORE_FAULT_PLAN into
    the native client seams, once per process."""
    global _client_faults_installed
    if _client_faults_installed:
        return
    _client_faults_installed = True
    rules = fault_mod.plan_from_env()
    if rules:
        fault_mod.install_client_rules(lib, rules)


def _host_f32(value):
    """A contiguous float32 numpy copy of a tensor, NDArray or array (the
    wire's format): one copy off the device."""
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).contiguous().numpy()
    return np.ascontiguousarray(value, dtype=np.float32)


class WorkerConnection:
    """One worker's connection to one parameter server, with reconnect
    and resend under the recovery budget."""

    def __init__(self, host=None, port=None, timeout=30.0):
        self._lib = _native.load_comm()
        if host is None:
            host, port = server_address()
        self._host, self._port = host, int(port)
        _ensure_client_faults(self._lib)
        self._budget_ms = recovery_budget_ms()
        self.telemetry = fault_mod.RecoveryTelemetry()
        t0 = time.monotonic()
        handle = None
        while time.monotonic() < t0 + timeout:
            handle = self._lib.mxtpu_client_connect(host.encode(), self._port)
            if handle:
                break
            time.sleep(0.1)
        if not handle:
            raise MXNetError(
                f"kvstore rendezvous with server at {host}:{self._port} "
                f"failed: no connection after {time.monotonic() - t0:.1f}s "
                f"(deadline {timeout:.0f}s): server process not up, wrong "
                "DMLC_PS_ROOT_URI/PORT, or the server died during startup")
        self._h = ctypes.c_void_p(handle)
        self.rank = self._lib.mxtpu_client_rank(self._h)
        self.num_workers = self._lib.mxtpu_client_num_workers(self._h)
        # bounded requests: a dead server or worker fails the job instead
        # of hanging it (ref: kvstore_dist.h:118-123)
        self._lib.mxtpu_client_set_timeout(self._h, request_timeout_ms())

    @staticmethod
    def _fptr(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    @staticmethod
    def _explain(rc):
        if rc == -1:
            return ("request timed out or connection lost: the server or a "
                    "peer worker may have died")
        if rc == -3:
            return ("server rejected the request (degraded: a worker died "
                    "mid-round, or the command was refused)")
        return f"rc={rc}"

    # -- recovery core -----------------------------------------------------
    def _call(self, op, invoke):
        """:meth:`_call_impl` inside a ``kv.<op>`` span whose (trace_id,
        span_id) is stamped into the request header, so the server
        records the matching ``server_recv:<op>`` child span."""
        if not _tracing.enabled():
            return self._call_impl(op, invoke)
        set_trace = self._lib.mxtpu_client_set_trace
        with _tracing.span("kv.%s" % op, cat="comm", rank=self.rank) as sp:
            def stamped(h, _invoke=invoke, _sp=sp):
                # stamped again each attempt: a resend on a fresh
                # connection carries the same span context
                set_trace(h, _sp.trace_id, _sp.span_id)
                return _invoke(h)
            rc = self._call_impl(op, stamped)
            if rc < 0:   # pull-style calls return positive sizes
                sp.set_attr("rc", int(rc))
            return rc

    def _call_impl(self, op, invoke):
        """Run ``invoke(handle) -> rc``; on a transport failure (rc -1)
        with a recovery budget armed, reconnect with the reclaimed rank,
        pin the failed request id and resend until the budget is spent.
        Other errors (-2 size, -3 rejected) pass through: the server
        answered, so a resend cannot help. Requests on one connection
        are serialized (the resend id is the connection's last)."""
        rc = invoke(self._h)
        if rc != -1 or self._budget_ms <= 0:
            return rc
        failed_id = int(self._lib.mxtpu_client_get_next_req_id(self._h)) - 1
        tel = self.telemetry
        tel.last_op = op
        tel.last_req_id = failed_id
        reconnects_before = tel.reconnects
        sched = fault_mod.BackoffSchedule(
            self._budget_ms, base_ms=recovery_backoff_ms(),
            max_ms=recovery_backoff_max_ms())
        last_err = "request timed out or connection lost"
        while True:
            wait = sched.next_wait()
            if wait is None:
                break
            time.sleep(wait)
            tel.attempts += 1
            newh = self._lib.mxtpu_client_connect_as(
                self._host.encode(), self._port, self.rank)
            if not newh:
                last_err = "reconnect refused (server down or restarting)"
                continue
            old, self._h = self._h, ctypes.c_void_p(newh)
            # the resend carries the SAME id the failed request consumed:
            # that is what makes it idempotent at the server
            self._lib.mxtpu_client_set_next_req_id(self._h, failed_id)
            # one resend may not outlast the remaining budget
            self._lib.mxtpu_client_set_timeout(
                self._h, max(1, min(request_timeout_ms(),
                                    int(sched.remaining_ms()))))
            self._lib.mxtpu_client_close(old)
            tel.reconnects += 1
            rc = invoke(self._h)
            if rc != -1:
                # recovered: the next request is a normal one and may
                # wait on the server (a BSP straggler) the full timeout
                self._lib.mxtpu_client_set_timeout(self._h,
                                                   request_timeout_ms())
                tel.recovered += 1
                tel.backoff_wait_ms += sched.total_wait_ms
                self._note(op, failed_id, "recovered", sched,
                           tel.reconnects - reconnects_before)
                return rc
            last_err = "resent request timed out or connection lost again"
        tel.exhausted += 1
        tel.backoff_wait_ms += sched.total_wait_ms
        tel.last_error = last_err
        self._note(op, failed_id, "exhausted", sched,
                   tel.reconnects - reconnects_before, last_err)
        raise MXNetError(
            f"kvstore recovery budget exhausted for {op} (request id "
            f"{failed_id}) against {self._host}:{self._port}: "
            f"{sched.attempts} attempts, "
            f"{tel.reconnects - reconnects_before} reconnects, "
            f"{sched.elapsed_ms():.0f}ms elapsed of {self._budget_ms}ms "
            f"budget; last error: {last_err}. Raise "
            "MXNET_KVSTORE_RECOVERY_BUDGET_MS or restart the server "
            "(tools/launch.py --restart-policy=server)")

    def _note(self, op, req_id, outcome, sched, reconnects, error=""):
        """One recovery incident: this connection's record and the
        profiler's (values of this recovery, not cumulative)."""
        self.telemetry.events.append((op, req_id, outcome))
        profiler.note_recovery({
            "op": op, "req_id": req_id, "outcome": outcome,
            "rank": self.rank, "attempts": sched.attempts,
            "reconnects": reconnects,
            "backoff_wait_ms": round(sched.total_wait_ms, 3),
            "elapsed_ms": round(sched.elapsed_ms(), 1),
            "budget_ms": self._budget_ms, "error": error,
        })

    # -- data plane --------------------------------------------------------
    def init(self, key, value):
        arr = _host_f32(value).reshape(-1)
        rc = self._call("init", lambda h: self._lib.mxtpu_client_init(
            h, key, self._fptr(arr), arr.size))
        if rc != 0:
            raise MXNetError(f"dist init failed for key {key}: "
                             f"{self._explain(rc)}")

    def push(self, key, value):
        arr = _host_f32(value).reshape(-1)
        rc = self._call("push", lambda h: self._lib.mxtpu_client_push(
            h, key, self._fptr(arr), arr.size))
        if rc != 0:
            raise MXNetError(f"dist push failed for key {key}: "
                             f"{self._explain(rc)}")

    def push_compressed(self, key, payload):
        rc = self._call(
            "push_2bit", lambda h: self._lib.mxtpu_client_push_2bit(
                h, key, payload, len(payload)))
        if rc != 0:
            raise MXNetError(f"dist compressed push failed for key {key}: "
                             f"{self._explain(rc)}")

    def pull(self, key, shape):
        """The key's float32 value as a numpy array of ``shape``."""
        n = int(np.prod(shape)) if shape else 1
        out = np.empty(n, dtype=np.float32)
        got = self._call("pull", lambda h: self._lib.mxtpu_client_pull(
            h, key, self._fptr(out), n))
        if got < 0:
            raise MXNetError(f"dist pull failed for key {key}: "
                             f"{self._explain(got)}")
        if got != n:
            raise MXNetError(f"dist pull size mismatch for key {key}: got "
                             f"{got}, want {n} (was the key initialized?)")
        return out.reshape(shape)

    def barrier(self):
        rc = self._call("barrier",
                        lambda h: self._lib.mxtpu_client_barrier(h))
        if rc != 0:
            raise MXNetError(f"dist barrier failed: {self._explain(rc)}")

    def command(self, cmd, body=b""):
        rc = self._call("command", lambda h: self._lib.mxtpu_client_command(
            h, cmd, body, len(body)))
        if rc != 0:
            raise MXNetError(f"dist command {cmd} failed: "
                             f"{self._explain(rc)}")

    def set_sync_mode(self, sync):
        self.command(CMD_SYNC_MODE, b"\x01" if sync else b"\x00")

    def send_optimizer(self, optimizer):
        self.command(CMD_SET_OPTIMIZER, pickle.dumps(optimizer))

    def send_profiler_command(self, directive):
        """Remote-control the server process's profiler (ref:
        include/mxnet/kvstore.h:43-49 kSetConfig / kState / kPause /
        kDump; kvstore_dist_server.h:199). ``directive`` is a dict such as
        ``{"cmd": "set_state", "state": "run"}``, run by the server's
        poll loop (:func:`_apply_profiler_directive`)."""
        self.command(CMD_SERVER_PROFILER,
                     PROF_MAGIC + pickle.dumps(directive))

    def trace_clock_sync(self, rounds=5):
        """Send ``rounds`` traced no-op directives: each a ``kv.clock_sync``
        span whose server-side ``server_recv:command`` child carries the
        server clock's receive time, the (send, recv, ack) triples
        ``tools/trace_merge.py`` estimates clock offsets from. A no-op
        when tracing is off."""
        if not _tracing.enabled():
            return
        body = PROF_MAGIC + pickle.dumps({"cmd": "noop"})
        for _ in range(max(int(rounds), 1)):
            self._call("clock_sync",
                       lambda h: self._lib.mxtpu_client_command(
                           h, CMD_SERVER_PROFILER, body, len(body)))

    def stop_server(self):
        self.command(CMD_STOP)

    def close(self):
        if self._h:
            self._lib.mxtpu_client_close(self._h)
            self._h = None


class ShardedConnection:
    """Worker connections to S servers with key sharding (ref:
    kvstore_dist.h:532 EncodeDefaultKey): small keys round-robin over
    the servers; a key of MXNET_KVSTORE_BIGARRAY_BOUND elements or more
    is cut into S contiguous slices, one a server, whose requests run
    at once. Slice keys are 1_000_000 + key * 64 + slice, so user keys
    stay below 1e6. Recovery composes per shard."""

    _SHARD_BASE = 1_000_000

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor

        host, ports = server_ports()
        self._conns = [WorkerConnection(host, p) for p in ports]
        self.rank = self._conns[0].rank
        self.num_workers = self._conns[0].num_workers
        self._big = int(float(os.environ.get(
            "MXNET_KVSTORE_BIGARRAY_BOUND", "1000000")))
        self._sizes = {}
        # each server's socket IO releases the GIL inside ctypes
        self._pool = ThreadPoolExecutor(max_workers=len(self._conns))

    @property
    def num_servers(self):
        return len(self._conns)

    @property
    def telemetry(self):
        return [c.telemetry for c in self._conns]

    def _srv(self, key):
        return self._conns[key % len(self._conns)]

    def _slices(self, key, n):
        """[(server, derived_key, start, stop)] covering [0, n), or None
        for an unsliced key."""
        s = len(self._conns)
        if key >= self._SHARD_BASE:
            raise MXNetError(f"kvstore key {key} out of range (<1e6)")
        if n < self._big or s == 1:
            return None
        per = (n + s - 1) // s
        out = []
        for i in range(s):
            start, stop = i * per, min((i + 1) * per, n)
            if start >= stop:
                break
            out.append((self._conns[i], self._SHARD_BASE + key * 64 + i,
                        start, stop))
        return out

    def init(self, key, value):
        flat = _host_f32(value).reshape(-1)
        self._sizes[key] = flat.size
        sl = self._slices(key, flat.size)
        if sl is None:
            self._srv(key).init(key, flat)
            return
        for conn, dk, start, stop in sl:
            conn.init(dk, flat[start:stop])

    def push(self, key, value):
        flat = _host_f32(value).reshape(-1)
        sl = self._slices(key, flat.size)
        if sl is None:
            self._srv(key).push(key, flat)
            return
        for f in [self._pool.submit(conn.push, dk, flat[start:stop])
                  for conn, dk, start, stop in sl]:
            f.result()

    def push_compressed(self, key, payload):
        if self._slices(key, self._sizes.get(key, 0)) is not None:
            raise MXNetError(
                "gradient compression cannot be combined with multi-server "
                f"big-array sharding (key {key}, {self._sizes[key]} "
                f"elements >= bound {self._big}); raise "
                "MXNET_KVSTORE_BIGARRAY_BOUND or use one server")
        self._srv(key).push_compressed(key, payload)

    def pull(self, key, shape):
        n = int(np.prod(shape)) if shape else 1
        sl = self._slices(key, n)
        if sl is None:
            return self._srv(key).pull(key, shape)
        out = np.empty(n, np.float32)

        def one(conn, dk, start, stop):
            out[start:stop] = conn.pull(dk, (stop - start,))

        for f in [self._pool.submit(one, *args) for args in sl]:
            f.result()
        return out.reshape(shape)

    def barrier(self):
        self._conns[0].barrier()

    def command(self, cmd, body=b""):
        for c in self._conns:
            c.command(cmd, body)

    def set_sync_mode(self, sync):
        self.command(CMD_SYNC_MODE, b"\x01" if sync else b"\x00")

    def send_optimizer(self, optimizer):
        self.command(CMD_SET_OPTIMIZER, pickle.dumps(optimizer))

    def send_profiler_command(self, directive):
        # every shard server gets the directive, as set_optimizer
        self.command(CMD_SERVER_PROFILER,
                     PROF_MAGIC + pickle.dumps(directive))

    def trace_clock_sync(self, rounds=5):
        for c in self._conns:
            c.trace_clock_sync(rounds)

    def stop_server(self):
        self.command(CMD_STOP)

    def close(self):
        for c in self._conns:
            c.close()
        self._conns = []
        self._pool.shutdown(wait=False)


def connect_workers():
    """One server: a plain connection; several: a sharded one."""
    if num_servers_env() > 1:
        return ShardedConnection()
    return WorkerConnection()


def _apply_profiler_directive(body):
    """Run a worker-sent profiler directive in this (server) process (ref:
    src/kvstore/kvstore_dist_server.h:199: the server's controller runs
    kSetConfig / kState / kPause / kDump on its own profiler).
    ``metrics_snapshot`` writes this process's metric snapshot to the
    requested path and ``trace_dump`` its trace file; the worker polls
    them into its own files (``telemetry.export.pull_server_metrics``,
    ``tracing.export.pull_server_trace``). A malformed directive is
    reported on stderr and never stops the poll loop: the worker already
    has its acknowledgement."""
    cmd = "?"
    try:
        d = pickle.loads(body)
        cmd = d.get("cmd")
        if cmd == "set_config":
            profiler.set_config(**d.get("kwargs", {}))
        elif cmd == "set_state":
            profiler.set_state(d.get("state", "stop"))
        elif cmd == "pause":
            profiler.pause()
        elif cmd == "resume":
            profiler.resume()
        elif cmd == "dump":
            profiler.dump()
        elif cmd == "metrics_snapshot":
            from ..telemetry import export as _tm_export
            _tm_export.dump(d["path"])
        elif cmd == "trace_dump":
            _tracing.export.write_trace(d["path"])
        elif cmd == "noop":
            pass   # clock-sync probe: the traced request is the payload
    except Exception as e:  # noqa: BLE001 — see the docstring
        print("kvstore server: profiler command %r failed: %r"
              % (cmd, e), file=sys.stderr, flush=True)
        return
    profiler.record_event("server_profiler_cmd:%s" % cmd, "kvstore",
                          profiler._now_us(), 0)


def snapshot_path():
    return os.environ.get("MXNET_KVSTORE_SNAPSHOT_PATH", "")


def _write_snapshot(lib, path, optimizer_blob):
    """Serialize the whole native server state (committed stores,
    in-flight merges, idempotency watermarks) and the optimizer blob to
    ``path`` (atomically, with its CRC in the manifest), FREEZING the
    server: nothing the snapshot missed is acknowledged afterwards.
    Returns True on success."""
    cap = max(int(lib.mxtpu_server_snapshot(None, 0, 0)), 0) + (1 << 16)
    for _ in range(5):
        buf = ctypes.create_string_buffer(cap)
        got = int(lib.mxtpu_server_snapshot(buf, cap, 1))
        if got < 0:
            return False
        if got <= cap:
            blob = {"version": 1, "native": buf.raw[:got],
                    "optimizer_blob": optimizer_blob,
                    "saved_at": time.time()}
            try:
                with ckpt.atomic_write(path) as f:
                    pickle.dump(blob, f)
            except OSError:
                # the caller is a SIGTERM handler: it must still reach its
                # restartable exit
                return False
            return True
        cap = got + (1 << 16)   # the state grew between query and copy
    return False


def _read_snapshot(path):
    """The snapshot at ``path``, or None (missing, malformed, or failing
    its CRC check: the server then starts empty, and says so)."""
    try:
        ckpt.verify(path)
        with open(path, "rb") as f:
            snap = pickle.load(f)
        if isinstance(snap, dict) and snap.get("version") == 1:
            return snap
    except MXNetError as e:
        print(f"kvstore server: snapshot {path} failed CRC verification, "
              f"starting empty ({e})", file=sys.stderr, flush=True)
        profiler.note_checkpoint_rejected({"path": path,
                                           "reason": "snapshot_crc"})
    except (OSError, ValueError, pickle.UnpicklingError, EOFError):
        pass
    return None


def run_server(port=None, num_workers=None, poll_ms=200):
    """The server process's main loop (ref: python/mxnet/
    kvstore_server.py). Starts the native transport, then waits for
    control blobs: a pickled optimizer installs an updater applied to
    each completed merge round on :func:`server_device`; a stop command
    ends the loop, and the server prints one line, ``kvstore server:
    {...}``, with its device, updates and their milliseconds. With
    MXNET_KVSTORE_SNAPSHOT_PATH set, SIGTERM snapshots the state before
    exiting, and a start that finds the snapshot restores it before
    listening."""
    lib = _native.load_comm()
    device = server_device()
    if port is None:
        _, port = server_address()
        port += int(os.environ.get("DMLC_SERVER_ID", "0"))
    if num_workers is None:
        num_workers = num_workers_env()

    if _tracing.enabled():
        # traced worker requests become server_recv:* child spans in
        # this process's rings (the trace_dump directive writes them)
        from ..tracing import wire as _tw
        _tw.install_server_sink(lib)

    rules = fault_mod.plan_from_env()
    if rules:
        fault_mod.install_server_rules(lib, rules)

    snap_file = snapshot_path()
    restored = None
    if snap_file and os.path.exists(snap_file):
        restored = _read_snapshot(snap_file)
        if restored is not None:
            native = restored.get("native", b"")
            if not native or lib.mxtpu_server_preload(native,
                                                      len(native)) != 0:
                print(f"kvstore server: snapshot {snap_file} is malformed, "
                      "starting empty", file=sys.stderr, flush=True)
                restored = None
            else:
                print(f"kvstore server: restored {len(native)}-byte "
                      f"snapshot from {snap_file}", file=sys.stderr,
                      flush=True)

    states = {}
    stats = {"updates": 0, "update_ms": 0.0}
    # the optimizer blob travels in the snapshot, so a restarted server
    # keeps applying updates without the workers resending it
    current = {"optimizer_blob": None}

    def install_updater(blob):
        optimizer = pickle.loads(blob)
        current["optimizer_blob"] = blob

        update_series = {}   # per-key counter series, resolved once

        def updater(key, recved, stored, n, _opt=optimizer, _states=states):
            # runs on a connection thread of the transport: everything it
            # needs is imported at module scope
            t0 = time.perf_counter()
            tr = _tracing.NOOP
            if _tracing.enabled():
                # parented to the worker push that completed the round
                # (the connection thread's request context, comm.cc);
                # an untraced push (0, 0) records nothing
                from ..tracing import wire as _tw
                ctx = _tw.server_parent_ctx(lib)
                if ctx[0]:
                    tr = _tracing.span_at(ctx, "server_update",
                                          cat="comm", key=key,
                                          role="server")
            with tr, profiler.timed_region("server_update:key%d" % key,
                                           "kvstore"):
                host = as_array(stored, shape=(n,))
                w = NDArray(torch.from_numpy(host).to(device, copy=True))
                g = NDArray(torch.from_numpy(as_array(recved, shape=(n,)))
                            .to(device, copy=True))
                if key not in _states:
                    _states[key] = _opt.create_state_multi_precision(key, w)
                _opt.update_multi_precision(key, w, g, _states[key])
                host[:] = w._data.cpu().numpy()
            dt = time.perf_counter() - t0
            stats["updates"] += 1
            stats["update_ms"] += dt * 1e3
            if _tm_metrics.enabled():
                m = _server_met()
                series = update_series.get(key)
                if series is None:
                    series = update_series[key] = m["updates"].labels(
                        key=str(key))
                series.inc()
                m["update_s"].observe(dt)

        _native.set_server_updater(updater)

    if snap_file:
        # installed before the listen socket opens and before a consumed
        # snapshot is unlinked: a SIGTERM at any point either finds the
        # old file or snapshots the live state
        def _snapshot_and_exit(signum, frame):
            ok = _write_snapshot(lib, snap_file, current["optimizer_blob"])
            print(f"kvstore server: SIGTERM, snapshot {snap_file}: "
                  + ("saved" if ok else "FAILED"), file=sys.stderr,
                  flush=True)
            os._exit(SERVER_RESTART_EXITCODE)

        signal.signal(signal.SIGTERM, _snapshot_and_exit)

    # reconnect tolerance: the grace defaults to the workers' recovery
    # budget (the launcher forwards the whole environment); a restored
    # server always gets a floor. Staged before start, so no resend racing
    # a restart can degrade the job or complete a round without the
    # optimizer
    grace = os.environ.get("MXNET_KVSTORE_RECOVERY_GRACE_MS")
    if grace is None:
        grace = os.environ.get("MXNET_KVSTORE_RECOVERY_BUDGET_MS", "0")
    grace = int(grace)
    if restored is not None and grace <= 0:
        grace = 30000
    if grace > 0:
        lib.mxtpu_server_set_recovery_grace(grace)
    if restored is not None and restored.get("optimizer_blob"):
        # the optimizer STATE (momentum etc.) restarts empty: only
        # stateless server optimizers keep exact trajectories over a
        # restart
        install_updater(restored["optimizer_blob"])

    rc = lib.mxtpu_server_start(int(port), int(num_workers))
    if rc != 0:
        raise MXNetError(f"kvstore server failed to start (rc={rc})")
    if restored is not None:
        try:
            os.unlink(snap_file)
        except OSError:
            pass

    buf = ctypes.create_string_buffer(64 << 20)
    while True:
        got = lib.mxtpu_server_poll(buf, len(buf), poll_ms)
        if got < 0:
            break
        if got > 0:
            blob = buf.raw[:got]
            if blob.startswith(PROF_MAGIC):
                _apply_profiler_directive(blob[len(PROF_MAGIC):])
                continue
            install_updater(blob)
    print("kvstore server: " + json.dumps(
        {"device": str(device), "updates": stats["updates"],
         "update_ms": stats["update_ms"]}), file=sys.stderr, flush=True)
