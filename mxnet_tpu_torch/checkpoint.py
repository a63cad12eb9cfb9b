"""Crash-safe checkpoint files (the port of ``mxnet_tpu/checkpoint.py``'s
:func:`atomic_write` and :func:`verify`, which ``Module``'s optimizer
states use; the rest of that module, ``CheckpointManager`` and the
preemption guard, is not ported yet).

A file is written to ``<fname>.tmp``, flushed, ``fsync``'d and renamed
into place, and its CRC32 and size are recorded in the directory's
``MANIFEST.json`` in the JAX package's format, so either package
verifies the files the other wrote. ``MXNET_CHECKPOINT_MANIFEST=0``
skips the manifest.
"""
from __future__ import annotations

import contextlib
import json
import os
import zlib

from .base import MXNetError, get_env

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1


def manifest_enabled():
    return get_env("MXNET_CHECKPOINT_MANIFEST", True, bool)


def file_crc32(fname, _chunk=1 << 20):
    """CRC32 of a file's bytes (zlib polynomial, unsigned)."""
    crc = 0
    with open(fname, "rb") as f:
        while True:
            block = f.read(_chunk)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def _manifest_path(fname):
    return os.path.join(os.path.dirname(os.path.abspath(fname)),
                        MANIFEST_NAME)


def read_manifest(dirpath):
    """The directory's MANIFEST.json dict, or None when absent or not
    a version-1 manifest."""
    try:
        with open(os.path.join(dirpath, MANIFEST_NAME), "rb") as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or \
            man.get("version") != MANIFEST_VERSION or \
            not isinstance(man.get("files"), dict):
        return None
    return man


def _record_in_manifest(fname, crc, size):
    """Read-modify-write the sibling MANIFEST.json atomically, keyed by
    basename; the superseded entry is kept one generation under
    ``prev`` (the entry is recorded before the rename, so a crash
    between the two leaves a pair :func:`verify` still accepts)."""
    mpath = _manifest_path(fname)
    man = read_manifest(os.path.dirname(mpath)) or \
        {"version": MANIFEST_VERSION, "files": {}}
    entry = {"crc32": int(crc), "size": int(size)}
    old = man["files"].get(os.path.basename(fname))
    if old is not None and (old.get("crc32") != entry["crc32"]
                            or old.get("size") != entry["size"]):
        entry["prev"] = {"crc32": old.get("crc32"), "size": old.get("size")}
    man["files"][os.path.basename(fname)] = entry
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, mpath)


def manifest_entry(fname):
    """This file's manifest record ({"crc32", "size"}) or None."""
    man = read_manifest(os.path.dirname(os.path.abspath(fname)))
    return None if man is None else man["files"].get(
        os.path.basename(fname))


def verify(fname, required=False):
    """CRC-check ``fname`` against its MANIFEST.json entry: True when it
    matches, False when there is no entry (unless ``required``) or
    manifests are off; a size or CRC mismatch raises ``MXNetError``."""
    if not manifest_enabled():
        return False
    entry = manifest_entry(fname)
    if entry is None:
        if required:
            raise MXNetError(f"checkpoint {fname} has no {MANIFEST_NAME} "
                             "entry: cannot prove integrity")
        return False
    size = os.path.getsize(fname)
    crc = None
    for cand in (entry, entry.get("prev")):
        if not cand or size != cand.get("size"):
            continue
        if crc is None:
            crc = file_crc32(fname)
        if crc == cand.get("crc32"):
            return True
    if crc is None:
        crc = file_crc32(fname)
    raise MXNetError(
        f"checkpoint {fname} failed integrity check: size {size} / CRC32 "
        f"{crc:#010x} match neither the manifest entry (size "
        f"{entry.get('size')}, CRC32 {int(entry.get('crc32', 0)):#010x}) "
        "nor its predecessor; refusing to load it")


def _fsync_dir(dirpath):
    """Record the rename durably (best effort)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(fname, mode="wb", manifest=None):
    """Write ``fname`` through ``<fname>.tmp`` -> flush -> fsync ->
    ``os.replace``, recording the CRC32 of what reached the disk in the
    directory's MANIFEST.json (unless ``manifest=False`` or manifests
    are off)::

        with atomic_write(path) as f:
            f.write(payload)
    """
    if mode not in ("w", "wb"):
        raise MXNetError(f"atomic_write mode must be 'w' or 'wb', "
                         f"got {mode!r}")
    fname = os.fspath(fname)
    record = manifest if manifest is not None else manifest_enabled()
    tmp = fname + ".tmp"
    try:
        with open(tmp, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        if record:
            _record_in_manifest(fname, file_crc32(tmp),
                                os.path.getsize(tmp))
        os.replace(tmp, fname)
        _fsync_dir(os.path.dirname(os.path.abspath(fname)))
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
