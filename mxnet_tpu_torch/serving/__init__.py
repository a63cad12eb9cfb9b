"""Serving front of the port (generative decode; the one-shot path is a
later slice)."""
from __future__ import annotations

from .batcher import RejectedError, ServingError
from .gateway import Gateway

__all__ = ["Gateway", "RejectedError", "ServingError"]
