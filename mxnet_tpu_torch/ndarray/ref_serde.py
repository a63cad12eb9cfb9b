"""Reference-format NDArray-list (de)serialization.

The reference writes parameter files with dmlc streams (ref:
src/ndarray/ndarray.cc:1574 NDArray::Save and :1776 list save): u64
magic 0x112 | u64 reserved | vector<NDArray> | vector<string> keys.
Each dense NDArray is u32 magic 0xF993FAC9 | i32 stype | TShape (u32
ndim + u32 dims) | Context (i32, i32) | i32 mshadow type flag | raw
data; sparse entries carry storage shape and aux (indices) arrays.
These byte-level readers/writers make reference checkpoints a wire
format this framework speaks natively (nd.load_frombuffer,
tools/import_params.py, the MXPred C ABI's param blobs).
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import MXNetError

LIST_MAGIC = 0x112
ND_MAGIC_V2 = 0xF993FAC9
ND_MAGIC_V1 = 0xF993FAC8

# mshadow type flags (ref: mshadow/base.h TypeFlag)
TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
              4: np.int32, 5: np.int8, 6: np.int64}
FLAG_OF = {np.dtype(v): k for k, v in TYPE_FLAGS.items()}

_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2


class _Reader:
    def __init__(self, data):
        self.b = data
        self.o = 0

    def read(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.b, self.o)
        self.o += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def raw(self, n):
        out = self.b[self.o:self.o + n]
        self.o += n
        return out


def _read_shape(r):
    ndim = r.read("I")
    if ndim > 32:
        raise MXNetError(f"implausible ndim {ndim}: not a TShape")
    return tuple(r.read("I") for _ in range(ndim)) if ndim else ()


def _read_ndarray(r):
    magic = r.read("I")
    if magic == ND_MAGIC_V1:
        # legacy dense: shape | context | type_flag | data
        shape = _read_shape(r)
        r.read("ii")  # context
        flag = r.read("i")
        dt = np.dtype(TYPE_FLAGS[flag])
        n = int(np.prod(shape)) if shape else 0
        return np.frombuffer(r.raw(n * dt.itemsize), dt).reshape(shape)
    if magic != ND_MAGIC_V2:
        raise MXNetError(f"bad NDArray magic {magic:#x}")
    stype = r.read("i")
    nad = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}[stype]
    sshape = _read_shape(r) if nad else None
    shape = _read_shape(r)
    if not shape:
        return np.zeros((0,), np.float32)
    r.read("ii")  # context dev_type/dev_id
    flag = r.read("i")
    dt = np.dtype(TYPE_FLAGS[flag])
    aux = []
    for _ in range(nad):
        aflag = r.read("i")
        ashape = _read_shape(r)
        aux.append((np.dtype(TYPE_FLAGS[aflag]), ashape))
    data_shape = sshape if nad else shape
    n = int(np.prod(data_shape)) if data_shape else 0
    values = np.frombuffer(r.raw(n * dt.itemsize), dt).reshape(data_shape)
    aux_arrays = []
    for adt, ashape in aux:
        an = int(np.prod(ashape)) if ashape else 0
        aux_arrays.append(
            np.frombuffer(r.raw(an * adt.itemsize), adt).reshape(ashape))
    if stype == _STYPE_ROW_SPARSE:
        dense = np.zeros(shape, dt)
        dense[aux_arrays[0].astype(np.int64)] = values
        return dense
    if stype == _STYPE_CSR:
        dense = np.zeros(shape, dt)
        indptr = aux_arrays[0].astype(np.int64)
        indices = aux_arrays[1].astype(np.int64)
        for row in range(shape[0]):
            cols = indices[indptr[row]:indptr[row + 1]]
            dense[row, cols] = values[indptr[row]:indptr[row + 1]]
        return dense
    return values


def is_reference_format(data):
    return len(data) >= 8 and \
        struct.unpack_from("<Q", data, 0)[0] == LIST_MAGIC


def load_reference_buffer(data):
    """Reference .params bytes -> {name: np.ndarray} ('arg:'/'aux:'
    prefixes preserved; Gluon-style files have bare names)."""
    r = _Reader(data)
    header, _reserved = r.read("QQ")
    if header != LIST_MAGIC:
        raise MXNetError(
            f"not a reference .params buffer (magic {header:#x})")
    count = r.read("Q")
    arrays = [_read_ndarray(r) for _ in range(count)]
    nkeys = r.read("Q")
    names = []
    for _ in range(nkeys):
        ln = r.read("Q")
        names.append(r.raw(ln).decode())
    if names and len(names) != len(arrays):
        raise MXNetError("corrupt buffer: key/array count mismatch")
    if not names:
        names = [f"ndarray_{i}" for i in range(len(arrays))]
    return dict(zip(names, arrays))


def save_reference_buffer(params):
    """{name: np.ndarray} -> reference dense .params bytes."""
    out = [struct.pack("<QQ", LIST_MAGIC, 0),
           struct.pack("<Q", len(params))]
    for arr in params.values():
        arr = np.ascontiguousarray(arr)
        flag = FLAG_OF.get(arr.dtype)
        if flag is None:
            arr = arr.astype(np.float32)
            flag = 0
        out.append(struct.pack("<Ii", ND_MAGIC_V2, _STYPE_DEFAULT))
        out.append(struct.pack("<I", arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        out.append(struct.pack("<ii", 1, 0))  # cpu:0
        out.append(struct.pack("<i", flag))
        out.append(arr.tobytes())
    out.append(struct.pack("<Q", len(params)))
    for name in params:
        enc = name.encode()
        out.append(struct.pack("<Q", len(enc)))
        out.append(enc)
    return b"".join(out)
