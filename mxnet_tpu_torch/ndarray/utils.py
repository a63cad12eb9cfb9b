"""NDArray save/load (the port of ``mxnet_tpu/ndarray/utils.py``).

Two containers, both read and written the way the JAX package does, so
either package loads the other's files:

- the framework's own: numpy ``.npz`` (a list saves under ``__list__:i``
  keys);
- the reference's dmlc ``.params`` byte format (``ref_serde``), which
  :func:`load` recognises by its magic number and :func:`save_reference`
  writes.

Files are written through ``checkpoint.atomic_write`` (a temporary
name, fsync, rename), which records each file's size and CRC32 in its
directory's ``MANIFEST.json`` as the JAX package does; :func:`load`
checks a listed file against that entry (``checkpoint.verify``) before
it decodes a byte, so a torn or flipped file is refused, and a file
either package writes stays loadable by the other.
"""
from __future__ import annotations

import io

import numpy as np

from .. import checkpoint as _ckpt
from ..base import MXNetError
from .ndarray import NDArray, array
from .ref_serde import (is_reference_format, load_reference_buffer,
                        save_reference_buffer)

_LIST_PREFIX = "__list__:"


def _coerce(key, value):
    if isinstance(value, NDArray):
        return value.asnumpy()
    if isinstance(value, np.ndarray):
        return value
    raise TypeError(
        f"nd.save: value for {key!r} must be an NDArray or numpy "
        f"ndarray, got {type(value).__name__}")


def _payload(data):
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        return {f"{_LIST_PREFIX}{i}": _coerce(i, d)
                for i, d in enumerate(data)}
    if isinstance(data, dict):
        return {k: _coerce(k, v) for k, v in data.items()}
    raise TypeError("save expects NDArray, list or dict of NDArrays")


def _write(fname, raw):
    with _ckpt.atomic_write(fname) as f:
        f.write(raw)


def save(fname, data):
    """Save an NDArray, list or str->NDArray dict as ``.npz``."""
    buf = io.BytesIO()
    np.savez(buf, **_payload(data))
    _write(fname, buf.getvalue())


def save_reference(fname, data):
    """Save a str->NDArray dict in the reference's ``.params`` format."""
    _write(fname, save_reference_buffer(_payload(data)))


def _decode_error(name, head, exc):
    if head[:2] == b"PK" or is_reference_format(head):
        cause = ("probable torn/truncated write: the container header is "
                 "valid but its contents do not decode")
    else:
        cause = ("not a recognized NDArray container (npz or reference "
                 ".params)")
    return MXNetError(f"failed to load NDArray file {name}: {cause} "
                      f"[{type(exc).__name__}: {exc}]")


def load_frombuffer(buf, ctx=None):
    """Deserialize an NDArray dict (or list) from bytes in either
    container, onto ``ctx`` (the current context when None)."""
    head = bytes(buf[:8])
    try:
        if is_reference_format(buf):
            arrays = load_reference_buffer(buf)
        else:
            with np.load(io.BytesIO(buf), allow_pickle=False) as npz:
                arrays = {k: npz[k] for k in npz.keys()}
    except Exception as e:  # noqa: BLE001 — one clean error per bad file
        raise _decode_error("<buffer>", head, e) from e
    keys = list(arrays)
    if keys and all(k.startswith(_LIST_PREFIX) for k in keys):
        keys.sort(key=lambda k: int(k[len(_LIST_PREFIX):]))
        return [array(arrays[k], ctx=ctx) for k in keys]
    return {k: array(v, ctx=ctx) for k, v in arrays.items()}


def load(fname, ctx=None):
    # the CRC gate first: a manifest-listed file with any flipped or
    # missing byte is refused before a decoder can misread it
    _ckpt.verify(fname)
    with open(fname, "rb") as f:
        buf = f.read()
    if not (buf[:2] == b"PK" or is_reference_format(buf)):
        raise _decode_error(fname, buf[:8], ValueError("unknown header"))
    return load_frombuffer(buf, ctx=ctx)
