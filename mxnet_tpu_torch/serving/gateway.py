"""The serving front for generative decode (the ``register_generator``
/ ``submit_generate`` / ``generate`` subset of
``mxnet_tpu/serving/gateway.py``; the one-shot ``register`` /
``submit`` path is a later slice).

Quickstart::

    gw = Gateway()                       # cuda:0; Gateway(device="cpu")
    dec = GenerativeDecoder(vocab_size=32000, d_model=512, num_layers=8,
                            num_heads=8, max_prompt_tokens=512)
    gw.register_generator("lm", dec, block_tokens=16, max_blocks=4096,
                          max_new_tokens=256, max_decode_batch=32)
    tokens = gw.generate("lm", prompt_ids, max_new_tokens=128)
    for tok in gw.generate("lm", prompt_ids, stream=True).stream():
        ...
    gw.close()
"""
from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..base import get_env
from ..context import resolve_device
from .batcher import RejectedError, ServingError

logger = logging.getLogger(__name__)


class Gateway:
    """Serves registered generators on one device: ``cuda:0`` unless
    ``device`` says otherwise; without CUDA it raises unless ``device``
    is ``"cpu"``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # greedy decode is held token for token against fp32 references:
        # cuBLAS float32 products stay full float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        self._generators = {}          # name -> generate.GenModel
        self._gen_lock = threading.Lock()
        self._closed = False

    def register_generator(self, name, decoder, block_tokens=None,
                           max_blocks=None, max_new_tokens=None,
                           max_decode_batch=8, max_queue=None, warmup=True):
        """Register a decoder LM for token-granular generation.

        ``decoder`` is a :class:`~.generate.GenerativeDecoder` on this
        gateway's device. The lane gets a paged KV block pool of
        ``max_blocks`` x ``block_tokens``-token blocks and, with
        ``warmup``, runs every prefill and decode bucket once.
        ``max_new_tokens`` is the per-request generation cap (and the
        default for requests that don't pass one); the knob defaults
        come from ``MXTPU_GEN_BLOCK_TOKENS`` / ``MXTPU_GEN_MAX_BLOCKS``
        / ``MXTPU_GEN_MAX_NEW_TOKENS`` / ``MXTPU_SERVING_MAX_QUEUE``.
        """
        from .generate.scheduler import GenModel

        if self._closed:
            raise ServingError("serving: gateway is closed")
        if decoder.device != self.device:
            raise ServingError(
                f"serving: decoder on {decoder.device}, gateway on "
                f"{self.device}")
        if block_tokens is None:
            block_tokens = get_env("MXTPU_GEN_BLOCK_TOKENS", 16, int)
        if max_blocks is None:
            max_blocks = get_env("MXTPU_GEN_MAX_BLOCKS", 256, int)
        if max_new_tokens is None:
            max_new_tokens = get_env("MXTPU_GEN_MAX_NEW_TOKENS", 64, int)
        if max_queue is None:
            max_queue = get_env("MXTPU_SERVING_MAX_QUEUE", 256, int)
        with self._gen_lock:
            if name in self._generators:
                raise ServingError(
                    f"serving: generator {name!r} already registered")
            # claim the name before paying for the pool and warmup
            self._generators[name] = None
        try:
            gen = GenModel(name, decoder, block_tokens=block_tokens,
                           max_blocks=max_blocks,
                           max_new_tokens=max_new_tokens,
                           max_decode_batch=max_decode_batch,
                           max_queue=max_queue, warmup=warmup)
        except BaseException:
            with self._gen_lock:
                del self._generators[name]
            raise
        with self._gen_lock:
            self._generators[name] = gen
        logger.info(
            "serving: registered generator %r on %s — %d-token blocks x "
            "%d, warmup %.1fs", name, self.device, block_tokens, max_blocks,
            gen.warmup_seconds)
        return gen

    def unregister(self, name):
        with self._gen_lock:
            gen = self._generators.pop(name, None)
        if gen is not None:
            gen.close()

    def _get_generator(self, name):
        with self._gen_lock:
            gen = self._generators.get(name)
            known = sorted(n for n, g in self._generators.items() if g)
        if gen is None:
            raise ServingError(
                f"serving: unknown generator {name!r} (registered: "
                f"{known})")
        return gen

    def submit_generate(self, model, prompt, max_new_tokens=None):
        """Admit one generation request; returns the streaming
        :class:`~.generate.GenRequest` future. Fast-rejects with
        :class:`RejectedError` (reason ``kv_cache_full`` when the
        block pool cannot cover the request's token budget)."""
        from .generate.scheduler import GenRequest

        gen = self._get_generator(model)
        if max_new_tokens is None:
            max_new_tokens = gen.max_new_tokens
        prompt = np.asarray(prompt, np.int32).ravel()
        if len(prompt) < 1 or len(prompt) > gen.decoder.max_prompt_tokens:
            raise ServingError(
                f"serving: prompt of {len(prompt)} tokens outside "
                f"[1, {gen.decoder.max_prompt_tokens}] for {model!r}")
        if max_new_tokens < 1 or max_new_tokens > gen.max_new_tokens:
            raise ServingError(
                f"serving: max_new_tokens {max_new_tokens} outside "
                f"[1, {gen.max_new_tokens}] for {model!r}")
        req = GenRequest(model, prompt, max_new_tokens)
        reason = "closed" if self._closed else gen.try_admit(req)
        if reason is not None:
            raise RejectedError(reason, self._gen_reject_msg(
                gen, reason, len(prompt), max_new_tokens))
        return req

    def _gen_reject_msg(self, gen, reason, plen, max_new):
        if reason == "kv_cache_full":
            need = gen.lane.pool.blocks_for(plen + max_new)
            return (f"serving: {gen.name!r} KV block pool cannot cover "
                    f"{plen}+{max_new} tokens ({need} blocks) — shed "
                    "(retry with backoff, or lower max_new_tokens)")
        if reason == "queue_full":
            return (f"serving: {gen.name!r} generation queue at depth "
                    f"limit {gen.max_queue} — shed")
        return f"serving: {gen.name!r} is shutting down"

    def generate(self, model, prompt, max_new_tokens=None,
                 stream=False, timeout=120.0):
        """Greedy generation: token-id prompt in, generated token ids
        out. ``stream=True`` returns the request itself — iterate
        ``req.stream()`` for tokens as they decode."""
        req = self.submit_generate(model, prompt,
                                   max_new_tokens=max_new_tokens)
        if stream:
            return req
        return req.result(timeout)

    def stats(self):
        """Bounded per-generator snapshot (queue, batch, pool, step
        counts and times)."""
        with self._gen_lock:
            gens = [g for g in self._generators.values() if g is not None]
        return {g.name: {"generator": True, **g.stats()} for g in gens}

    def close(self):
        """Drain and stop everything; pending requests fail cleanly."""
        if self._closed:
            return
        self._closed = True
        with self._gen_lock:
            names = sorted(n for n, g in self._generators.items() if g)
        for name in names:
            self.unregister(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
