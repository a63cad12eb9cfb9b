"""Framework-wide error type and environment reader (the port's own
copies of ``mxnet_tpu/base.py``'s, so this package never imports the
JAX one)."""
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
