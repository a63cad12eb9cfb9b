"""The port's native runtime pieces (C++), built on demand with ``g++``.

``comm.cc`` is the distributed KVStore's transport (the ps-lite
equivalent) and ``imgdec.cc`` the threaded libjpeg batch decoder of the
record input pipeline, the port's own copies of the JAX package's. Each
compiles at first use into ``build/native/libmxtorch_<name>-<hash>.so``
under the repository root (a directory ``.gitignore`` lists; the hash is
of the source and the flags, so an edited source never loads a stale
library), never beside the source. An ``flock`` serializes concurrent
builders (the processes of one launcher job reaching the transport
together). This module imports neither torch nor numpy at import time:
the launcher's processes and the server load it too.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")
# link flags follow the source on the command line (link order), as the
# JAX package's loader orders them
IMGDEC_LINK = ("-ljpeg",)


def library_path(name, extra_flags=()):
    """Where ``<name>.cc`` builds to: ``build/native/`` under the
    repository root, named by the hash of the source and the flags."""
    src = (SRC_DIR / f"{name}.cc").read_bytes()
    flags = " ".join(GXX_FLAGS + tuple(extra_flags))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"libmxtorch_{name}-{digest[:16]}.so"


def comm_library_path():
    """Where ``comm.cc`` builds to."""
    return library_path("comm")


def imgdec_library_path():
    """Where ``imgdec.cc`` builds to (linked with libjpeg)."""
    return library_path("imgdec", IMGDEC_LINK)


def _build(src, out, extra_flags=()):
    """Compile ``src`` into the shared library ``out`` unless it exists;
    ``extra_flags`` (link flags) go after the source. A failed compile
    raises ``CalledProcessError`` with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp),
                            *extra_flags],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_comm_lib = None


def load_comm():
    """The distributed KVStore transport (``comm.cc``), built if needed,
    with every entry point's argument and result types set."""
    global _comm_lib
    if _comm_lib is not None:
        return _comm_lib
    out = comm_library_path()
    _build(SRC_DIR / "comm.cc", out)
    lib = ctypes.CDLL(str(out))
    c_int, c_u64, c_vp = ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.mxtpu_server_start.restype = c_int
    lib.mxtpu_server_start.argtypes = [c_int, c_int]
    lib.mxtpu_server_poll.restype = ctypes.c_long
    lib.mxtpu_server_poll.argtypes = [ctypes.c_char_p, c_u64, c_int]
    lib.mxtpu_server_set_updater.argtypes = [c_vp]
    lib.mxtpu_server_snapshot.restype = ctypes.c_long
    lib.mxtpu_server_snapshot.argtypes = [ctypes.c_char_p, c_u64, c_int]
    lib.mxtpu_server_preload.restype = c_int
    lib.mxtpu_server_preload.argtypes = [ctypes.c_char_p, c_u64]
    lib.mxtpu_server_set_recovery_grace.argtypes = [c_int]
    lib.mxtpu_fault_client_add.argtypes = [
        c_int, c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong]
    lib.mxtpu_fault_server_add.argtypes = lib.mxtpu_fault_client_add.argtypes
    lib.mxtpu_client_connect.restype = c_vp
    lib.mxtpu_client_connect.argtypes = [ctypes.c_char_p, c_int]
    lib.mxtpu_client_connect_as.restype = c_vp
    lib.mxtpu_client_connect_as.argtypes = [ctypes.c_char_p, c_int, c_int]
    lib.mxtpu_client_get_next_req_id.restype = c_u64
    lib.mxtpu_client_get_next_req_id.argtypes = [c_vp]
    lib.mxtpu_client_set_next_req_id.argtypes = [c_vp, c_u64]
    lib.mxtpu_client_rank.argtypes = [c_vp]
    lib.mxtpu_client_rank.restype = c_int
    lib.mxtpu_client_num_workers.argtypes = [c_vp]
    lib.mxtpu_client_num_workers.restype = c_int
    for name in ("mxtpu_client_init", "mxtpu_client_push",
                 "mxtpu_client_pull"):
        fn = getattr(lib, name)
        fn.argtypes = [c_vp, ctypes.c_uint32, fptr, c_u64]
        fn.restype = c_int
    lib.mxtpu_client_push_2bit.argtypes = [c_vp, ctypes.c_uint32,
                                           ctypes.c_char_p, c_u64]
    lib.mxtpu_client_push_2bit.restype = c_int
    lib.mxtpu_client_barrier.argtypes = [c_vp]
    lib.mxtpu_client_barrier.restype = c_int
    lib.mxtpu_client_command.argtypes = [c_vp, ctypes.c_uint32,
                                         ctypes.c_char_p, c_u64]
    lib.mxtpu_client_command.restype = c_int
    lib.mxtpu_client_close.argtypes = [c_vp]
    lib.mxtpu_client_set_timeout.argtypes = [c_vp, c_int]
    # tracing: a request's span context on the wire, and the server's
    # sink of traced requests
    lib.mxtpu_client_set_trace.argtypes = [c_vp, c_u64, c_u64]
    lib.mxtpu_server_set_trace_sink.argtypes = [c_vp]
    lib.mxtpu_server_current_trace.argtypes = [
        ctypes.POINTER(c_u64), ctypes.POINTER(c_u64)]
    _comm_lib = lib
    return lib


# the server's optimizer callback (comm.cc UpdaterFn): key, the merged
# push (n floats), n, the stored value (n floats, updated in place)
UPDATER_CFUNC = ctypes.CFUNCTYPE(
    None, ctypes.c_uint32, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
    ctypes.POINTER(ctypes.c_float))
# callbacks handed to the transport live as long as the process
_updater_keepalive = []


def set_server_updater(py_fn):
    """Install ``py_fn(key, recved, stored, n)`` as the server's updater:
    ``recved`` and ``stored`` are ctypes float pointers to ``n`` values
    each, and ``py_fn`` writes the updated value into ``stored`` (the
    reference applies its pickled optimizer the same way,
    kvstore_dist_server.h:346 ApplyUpdates)."""
    lib = load_comm()

    def trampoline(key, recved, n, stored):
        py_fn(int(key), recved, stored, int(n))

    cb = UPDATER_CFUNC(trampoline)
    _updater_keepalive.append(cb)
    lib.mxtpu_server_set_updater(ctypes.cast(cb, ctypes.c_void_p))


# the server's callback for each traced request (comm.cc TraceSinkFn):
# op, key, req_id, rank, trace_id, span_id, recv_ns, done_ns
TRACE_SINK_CFUNC = ctypes.CFUNCTYPE(
    None, ctypes.c_uint8, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int,
    ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64)
_trace_sink_keepalive = []


def set_server_trace_sink(py_fn, lib=None):
    """Install ``py_fn`` as the transport's sink of traced requests,
    called once a request from the server's connection threads. The
    callback object lives as long as the process: a collected one would
    crash the server at its next traced request."""
    if lib is None:
        lib = load_comm()
    cb = TRACE_SINK_CFUNC(py_fn)
    _trace_sink_keepalive.append(cb)
    lib.mxtpu_server_set_trace_sink(ctypes.cast(cb, ctypes.c_void_p))


# -- imgdec.cc: the libjpeg batch decoder --------------------------------

_jpeg_header = None


def jpeg_header_present():
    """Whether ``g++`` finds ``jpeglib.h`` on this host (asked of the
    preprocessor once a process). Only its absence lets the pipeline
    decode through PIL instead of the native decoder."""
    global _jpeg_header
    if _jpeg_header is None:
        probe = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                               input="#include <jpeglib.h>\n",
                               capture_output=True, text=True)
        _jpeg_header = probe.returncode == 0
    return _jpeg_header


_imgdec_lib = None


def load_imgdec():
    """The threaded JPEG batch decoder (``imgdec.cc``), built if needed,
    with the JAX package's argument types; None only where the host has
    no ``jpeglib.h`` (callers then decode with PIL). A build or load that
    fails with the header present raises :class:`MXNetError`."""
    global _imgdec_lib
    if _imgdec_lib is not None:
        return _imgdec_lib
    if not jpeg_header_present():
        return None
    from ..base import MXNetError
    out = imgdec_library_path()
    try:
        _build(SRC_DIR / "imgdec.cc", out, IMGDEC_LINK)
        lib = ctypes.CDLL(str(out))
    except subprocess.CalledProcessError as e:
        raise MXNetError(f"building imgdec.cc failed with jpeglib.h "
                         f"present:\n{e.stderr}") from e
    except OSError as e:
        raise MXNetError(f"loading {out} failed: {e}") from e
    c_int, c_i64 = ctypes.c_int, ctypes.c_int64
    fptr = ctypes.POINTER(ctypes.c_float)
    u8ptr = ctypes.POINTER(ctypes.c_uint8)
    bufs = ctypes.POINTER(ctypes.c_char_p)
    lens = ctypes.POINTER(c_i64)
    lib.mxtpu_decode_batch.restype = c_int
    lib.mxtpu_decode_batch.argtypes = [
        bufs, lens, c_int, c_int, c_int,            # n, th, tw
        fptr, u8ptr, fptr, fptr, fptr,         # uv, mirror, mean, std, out
        c_int, ctypes.c_char_p, c_int]              # nthreads, errbuf
    lib.mxtpu_jpeg_dims.restype = c_int
    lib.mxtpu_jpeg_dims.argtypes = [
        ctypes.c_char_p, c_i64, ctypes.POINTER(c_int), ctypes.POINTER(c_int),
        ctypes.c_char_p, c_int]
    lib.mxtpu_decode_jpeg.restype = c_int
    lib.mxtpu_decode_jpeg.argtypes = [
        ctypes.c_char_p, c_i64, u8ptr, ctypes.c_char_p, c_int]
    _imgdec_lib = lib
    return lib


def decode_jpeg(payload):
    """One JPEG as an HWC uint8 RGB numpy array through libjpeg; None
    when the host has no libjpeg or the payload is not a JPEG (callers
    then decode with cv2 or PIL). The per-image seam of
    ``ImageRecordIter``'s per-record path and ``mx.image.imdecode``."""
    import numpy as np
    if payload[:2] != b"\xff\xd8":
        return None
    lib = load_imgdec()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.mxtpu_jpeg_dims(payload, len(payload), ctypes.byref(h),
                           ctypes.byref(w), err, len(err)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.mxtpu_decode_jpeg(
            payload, len(payload),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            err, len(err)) != 0:
        return None
    return out


def decode_batch(payloads, th, tw, uv, mirror, mean, std, nthreads=None):
    """Decode, crop, mirror and normalize a batch of JPEG payloads
    through the libjpeg thread pool into a new (n, 3, th, tw) float32
    array (ref: src/io/iter_image_recordio_2.cc:364-445). None where the
    host has no libjpeg; a decode failure raises :class:`MXNetError`.

    ``uv``: (n, 2) float32 crop offsets in [0, 1), negative = center;
    ``mirror``: (n,) uint8; ``mean`` / ``std``: 3 floats each, applied
    to the raw 0..255 pixel values."""
    import numpy as np

    from ..base import MXNetError
    lib = load_imgdec()
    if lib is None:
        return None
    n = len(payloads)
    if nthreads is None:
        nthreads = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS",
                                      str(os.cpu_count() or 4)))
    uv = np.ascontiguousarray(uv, np.float32)
    mirror = np.ascontiguousarray(mirror, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32).ravel()
    std = np.ascontiguousarray(std, np.float32).ravel()
    out = np.empty((n, 3, th, tw), np.float32)
    bufs = (ctypes.c_char_p * n)(*payloads)
    lens = (ctypes.c_int64 * n)(*[len(p) for p in payloads])
    errbuf = ctypes.create_string_buffer(512)
    fptr = ctypes.POINTER(ctypes.c_float)
    rc = lib.mxtpu_decode_batch(
        ctypes.cast(bufs, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(lens, ctypes.POINTER(ctypes.c_int64)),
        n, th, tw, uv.ctypes.data_as(fptr),
        mirror.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mean.ctypes.data_as(fptr), std.ctypes.data_as(fptr),
        out.ctypes.data_as(fptr), int(nthreads), errbuf, len(errbuf))
    if rc != 0:
        raise MXNetError("native decode failed: %s"
                         % errbuf.value.decode(errors="replace"))
    return out
