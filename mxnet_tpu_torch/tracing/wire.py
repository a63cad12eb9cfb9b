"""Kvstore wire propagation, the server half (the port of
``mxnet_tpu/tracing/wire.py``).

Every request header of ``_native/comm.cc`` ends with
``u64 trace_id | u64 span_id``; zeros mean untraced. The worker stamps
them a request (``kvstore/dist.py`` ``WorkerConnection._call`` calls
``mxtpu_client_set_trace`` inside its span); this module is what the
server process installs so those ids become spans on its side:

- :func:`install_server_sink` registers a ctypes callback the C++
  connection threads call once per traced request, with recv / done
  CLOCK_MONOTONIC ns measured natively. Each call records one
  ``server_recv:<op>`` span in the server's rings, parented to the
  worker's span id: the cross-process edge ``tools/trace_merge.py``
  stitches on.
- :func:`server_parent_ctx` reads the trace context of the request the
  current native connection thread is handling, so the server's
  optimizer updater parents its ``server_update`` span to the worker
  push that completed the round.
"""
from __future__ import annotations

import ctypes

from .. import _native
from . import enabled, record_span

OP_NAMES = {1: "init", 2: "push", 3: "pull", 4: "barrier", 5: "command",
            6: "push_2bit", 7: "pull_rows"}

_installed = [False]


def _sink(op, key, req_id, rank, trace_id, span_id, recv_ns, done_ns):
    # runs on a C++ connection thread (ctypes takes the GIL); must never
    # raise across the C boundary
    try:
        if not enabled() or not trace_id:
            return
        record_span(
            "server_recv:%s" % OP_NAMES.get(int(op), str(op)),
            trace_id, span_id, recv_ns, done_ns, cat="comm",
            attrs={"role": "server", "key": int(key),
                   "rank": int(rank), "req_id": int(req_id)})
    except Exception:  # noqa: BLE001 — tracing must not kill the server
        pass


def install_server_sink(lib=None):
    """Install the trace sink on the native transport (idempotent;
    ``kvstore/dist.py`` ``run_server`` calls it)."""
    if _installed[0]:
        return
    _installed[0] = True
    _native.set_server_trace_sink(_sink, lib=lib)


def server_parent_ctx(lib=None):
    """(trace_id, span_id) of the request being handled on this native
    connection thread; (0, 0) outside a traced request."""
    if lib is None:
        lib = _native.load_comm()
    tid = ctypes.c_uint64(0)
    sid = ctypes.c_uint64(0)
    lib.mxtpu_server_current_trace(ctypes.byref(tid), ctypes.byref(sid))
    return (int(tid.value), int(sid.value))
