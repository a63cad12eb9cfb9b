"""Recording and training-mode flags (the mode half of
``mxnet_tpu/autograd.py``). BatchNorm and Dropout read
:func:`is_training`; the imperative ``nd`` dispatch passes it to every op
with a ``training`` attr, as the reference's imperative engine does.

``backward`` and ``grad`` wait for gluon training: the port's symbolic
executor differentiates with ``torch.autograd`` already
(``Executor.backward``).
"""
from __future__ import annotations

import threading

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.train_mode = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().train_mode


def set_recording(is_record):
    """Set the recording flag; returns the previous value."""
    st = _st()
    prev = st.recording
    st.recording = bool(is_record)
    return prev


def set_training(train_mode):
    """Set the training-mode flag; returns the previous value."""
    st = _st()
    prev = st.train_mode
    st.train_mode = bool(train_mode)
    return prev


class _RecordingStateScope:
    """Scope that sets either flag (None leaves it alone) and restores
    both on exit."""

    def __init__(self, is_record, train_mode):
        self._is_record = is_record
        self._train_mode = train_mode
        self._prev = None
        self._prev_train = None

    def __enter__(self):
        if self._is_record is not None:
            self._prev = set_recording(self._is_record)
        if self._train_mode is not None:
            self._prev_train = set_training(self._train_mode)
        return self

    def __exit__(self, *exc):
        if self._is_record is not None:
            set_recording(self._prev)
        if self._train_mode is not None:
            set_training(self._prev_train)
        return False


def record(train_mode=True):
    """Scope: operations are recorded (training mode by default)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope: recording off (predict mode by default)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)
