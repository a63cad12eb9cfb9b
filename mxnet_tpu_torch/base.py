"""Framework-wide error type, environment reader and attr helpers (the
port's own copies of ``mxnet_tpu/base.py``'s, so this package never
imports the JAX one)."""
from __future__ import annotations

import os


class MXNetError(RuntimeError):
    """Default error raised by the framework (ref: python/mxnet/base.py MXNetError)."""


def get_env(name, default=None, dtype=str):
    """Read an env var the way the reference reads dmlc::GetEnv at point of use."""
    val = os.environ.get(name)
    if val is None:
        return default
    if dtype is bool:
        return val not in ("0", "false", "False", "")
    return dtype(val)


def attr_bool(val, default=False):
    """A graph-attr boolean that may arrive as bool, int or a string
    spelling from symbol JSON ("True", "true", "1", "False", "false",
    "0"): plain truthiness would read "false" as True."""
    if val is None:
        return default
    if isinstance(val, str):
        s = val.strip().lower()
        if s in ("true", "1"):
            return True
        if s in ("false", "0", ""):
            return False
        raise MXNetError(f"cannot parse boolean attr {val!r}")
    return bool(val)


class Registry:
    """Name -> class registry, names case-insensitive (the port's copy
    of the JAX package's ``base.registry``; ref:
    python/mxnet/registry.py)."""

    def __init__(self, kind):
        self.kind = kind
        self._entries = {}

    def register(self, obj, name=None, aliases=()):
        name = name or obj.__name__
        for key in (name,) + tuple(aliases):
            self._entries[key.lower()] = obj
        return obj

    def get(self, name):
        try:
            return self._entries[name.lower()]
        except KeyError:
            raise MXNetError(f"{self.kind} {name!r} is not registered. "
                             f"Known: {sorted(self._entries)}") from None
