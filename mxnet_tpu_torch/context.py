"""Device contexts (the port's counterpart of ``mxnet_tpu/context.py``).

``cpu()`` / ``gpu(i)`` keep the MXNet spelling and return a
:class:`Context`, which compares equal to the ``torch.device`` it names.
``with mx.cpu():`` makes the CPU the default inside the block, as the
reference's ``Context`` scope does. Outside any scope the default is
``gpu(0)`` (``cuda:0``), where the JAX package defaults to the CPU:
the port is built for the card, and :func:`resolve_device`, the one
rule every entry point applies, raises on a host without CUDA instead
of quietly running on the CPU. The CPU is taken only when asked for.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

_state = threading.local()


class Context:
    """Execution device: ``cpu()`` or ``gpu(i)``."""

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        elif isinstance(device_type, torch.device):
            device_id = device_type.index or 0
            device_type = {"cuda": "gpu"}.get(device_type.type,
                                              device_type.type)
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unsupported device type {device_type!r} "
                             "(cpu or gpu)")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device(self):
        """The ``torch.device`` this context names (no availability
        check: see :func:`resolve_device`)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        if isinstance(other, torch.device):
            return self.device == other
        return (isinstance(other, Context)
                and self.device == other.device)

    def __hash__(self):
        return hash(self.device)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()
        return False


def cpu(device_id=0):
    # torch has one CPU device; the id is kept for MXNet parity
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def dp_mesh(ctx_list):
    """A one-axis ``"dp"`` mesh (``parallel.mesh.Mesh``) over a context
    list, or None when the list repeats a context (the JAX package's
    ``dp_mesh``, which Module binding and gluon's ``split_and_load``
    both read).

    The rule: distinct ``(device_type, device_id)`` pairs are distinct
    mesh positions, and each position runs on the torch device its
    context resolves to. torch has one CPU device, so every ``cpu(i)``
    lands on the CPU (the counterpart of the JAX package's virtual CPU
    devices); ``gpu(i)`` is ``cuda:i`` and raises where that card is
    absent (:func:`resolve_device`)."""
    ctxs = [c if isinstance(c, Context) else Context(c) for c in ctx_list]
    keys = [(c.device_type, c.device_id) for c in ctxs]
    if len(set(keys)) != len(keys):
        return None
    from .parallel.mesh import create_mesh
    return create_mesh({"dp": len(ctxs)},
                       devices=[resolve_device(c) for c in ctxs])


def current_context():
    """The innermost ``with`` context, else ``gpu(0)``."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else gpu(0)


def resolve_device(device=None):
    """``None`` -> the current context (``cuda:0`` outside any ``with``
    scope); a :class:`Context`, string or ``torch.device`` as given.
    A CUDA device on a host without CUDA raises :class:`MXNetError`."""
    if device is None:
        device = current_context()
    dev = device.device if isinstance(device, Context) \
        else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {dev} requested but CUDA is not available; pass "
                "ctx=mx.cpu() / device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise MXNetError(
                f"device {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev} (cpu or cuda)")
    return dev
