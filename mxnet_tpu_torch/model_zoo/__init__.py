"""Model graphs the port ships as symbol JSON:
``resnet50_v1-symbol.json`` is the JAX package's
``gluon.model_zoo.vision.resnet50_v1`` traced once (``trace_block``,
then ``Symbol.tojson``) at 3x224x224. ``tests/test_torch_symbol.py``
re-exports it from the JAX package, and ``tests/test_torch_gluon.py``
from the port's gluon, and each checks they are one graph."""
from __future__ import annotations

import os

from ..symbol import load

_HERE = os.path.dirname(os.path.abspath(__file__))


def symbol_path(name):
    return os.path.join(_HERE, f"{name}-symbol.json")


def load_symbol(name):
    """The shipped graph of model ``name`` (e.g. "resnet50_v1")."""
    return load(symbol_path(name))
