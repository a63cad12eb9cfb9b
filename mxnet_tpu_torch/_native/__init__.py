"""The port's native runtime pieces (C++), built on demand with ``g++``.

``comm.cc`` is the distributed KVStore's transport (the ps-lite
equivalent), the port's own copy of the JAX package's. It compiles at
first use into ``build/native/libmxtorch_comm-<hash>.so`` under the
repository root (a directory ``.gitignore`` lists; the hash is of the
source and the flags, so an edited source never loads a stale library),
never beside the source. An ``flock`` serializes concurrent builders
(the processes of one launcher job reaching the transport together).
This module imports neither torch nor numpy: the launcher's processes
and the server load it too.
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


def comm_library_path():
    """Where ``comm.cc`` builds to: ``build/native/`` under the
    repository root, named by the hash of the source and the flags."""
    src = (SRC_DIR / "comm.cc").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmxtorch_comm-{digest[:16]}.so"


def _build(src, out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
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
