"""The decode plane's model path (counterpart of
``mxnet_tpu/serving/generate/model.py``): a pre-norm causal
transformer LM as an ``nn.Module``, and the prefill / decode steps that
read and write the paged cache.

- ``prefill``: one request's (padded) prompt through the stack with the
  causal :func:`~mxnet_tpu_torch.ops.attention.flash_attention`,
  writing every layer's K/V into the request's pool blocks and
  returning the first greedy token;
- ``decode``: one token per in-flight request (iteration-level batch),
  K/V written at each request's position, attention over the paged
  cache via :func:`~mxnet_tpu_torch.ops.attention.paged_attention`,
  next greedy tokens out.

On a CUDA device both attention calls launch the port's hand-written
kernels; the products around them are ``torch.matmul`` (cuBLAS), as
the JAX package leaves them to XLA. PyTorch runs eagerly, so there is
nothing to compile per bucket; the lane still warms every bucket once.

:func:`reference_generate` is the correctness oracle: an *unpaged*
single-request greedy decode that re-runs the full causal forward per
emitted token through the *plain* attention, so it checks the kernels
independently. The gateway's paged output must match it token for
token.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...initializer import Uniform
from ...ops.attention import (flash_attention, flash_attention_plain,
                              paged_attention)
from ...ops.nn import activation, fully_connected, layer_norm
from ...ops.tensor import embedding
from ...random import generator


class Dense(nn.Module):
    """``nn.Dense(units, flatten=False)``: weight (units, in_units)."""

    def __init__(self, units, in_units, use_bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(units, in_units))
        self.bias = nn.Parameter(torch.empty(units)) if use_bias else None

    def forward(self, x):
        return fully_connected(x, self.weight, self.bias, flatten=False)


class LayerNorm(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(in_channels))
        self.beta = nn.Parameter(torch.empty(in_channels))

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta)


class Embedding(nn.Module):
    def __init__(self, input_dim, output_dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim))

    def forward(self, tokens):
        return embedding(tokens, self.weight)


class DecoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, ff_mult):
        super().__init__()
        self.num_heads = num_heads
        self.ln1 = LayerNorm(d_model)
        self.qkv = Dense(3 * d_model, d_model)
        self.proj = Dense(d_model, d_model)
        self.ln2 = LayerNorm(d_model)
        self.ff1 = Dense(ff_mult * d_model, d_model)
        self.ff2 = Dense(d_model, ff_mult * d_model)

    def qkv_split(self, x):
        """q, k, v of shape (..., d): ``jnp.split(qkv, 3, -1)``, which
        equals the gluon path's ``reshape(b, t, 3, H, hd)``."""
        return self.qkv(self.ln1(x)).chunk(3, dim=-1)

    def tail(self, x, attn_flat):
        """Residual + projection + pre-norm MLP. Shapes (..., d)."""
        y = x + self.proj(attn_flat)
        z = activation(self.ff1(self.ln2(y)), "relu")
        return y + self.ff2(z)

    def forward(self, x):
        b, t, d = x.shape
        q, k, v = (_heads(y, self.num_heads)
                   for y in self.qkv_split(x))
        a = flash_attention_plain(q, k, v, causal=True)
        return self.tail(x, a.transpose(1, 2).reshape(b, t, d))


def _heads(y, num_heads):
    """(B, T, d) -> (B, H, T, hd) view."""
    b, t, d = y.shape
    return y.view(b, t, num_heads, d // num_heads).transpose(1, 2)


class GenerativeDecoder(nn.Module):
    """Pre-norm causal transformer LM + serving config, for
    ``Gateway.register_generator``.

    ``num_heads * head_dim == d_model``; ``max_prompt_tokens`` and the
    per-request ``max_new_tokens`` cap bound the block-table width.
    Parameters initialise as gluon's defaults do (``Uniform(0.07)``
    weights, zero biases, LayerNorm gamma 1 and beta 0) from a
    ``torch.Generator`` seeded with ``seed``, then move to ``device``
    (``cuda:0`` by default; raises without CUDA unless ``"cpu"``).
    """

    def __init__(self, vocab_size, d_model=64, num_layers=2, num_heads=4,
                 ff_mult=4, max_prompt_tokens=64, eos_id=None,
                 dtype="float32", device=None, seed=0):
        super().__init__()
        if d_model % num_heads:
            raise MXNetError(
                f"generate: d_model {d_model} not divisible by "
                f"num_heads {num_heads}")
        if dtype not in ("float32", torch.float32):
            raise MXNetError(
                f"generate: dtype {dtype!r} unsupported; the port's decode "
                "kernels take float32")
        device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = self.d_model // self.num_heads
        self.ff_mult = int(ff_mult)
        self.max_prompt_tokens = int(max_prompt_tokens)
        self.eos_id = eos_id
        self.dtype = torch.float32
        self.embed = Embedding(self.vocab_size, self.d_model)
        self.layers = nn.ModuleList(
            DecoderLayer(self.d_model, self.num_heads, self.ff_mult)
            for _ in range(self.num_layers))
        self.ln_f = LayerNorm(self.d_model)
        self.head = Dense(self.vocab_size, self.d_model, use_bias=False)
        init, gen = Uniform(), generator(seed)
        for name, p in self.named_parameters():
            init(name, p, gen)
        self.requires_grad_(False)   # a serving model: no autograd state
        self.to(device)

    @property
    def device(self):
        return self.head.weight.device

    def logits(self, x):
        return self.head(self.ln_f(x))

    def hidden(self, tokens):
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x)
        return x

    def forward(self, tokens):
        """Full causal forward with the plain attention: int tokens
        (B, T) -> logits (B, T, vocab)."""
        return self.logits(self.hidden(tokens))

    def full_logits(self, tokens):
        """Reference path over an int array (B, T) -> logits tensor."""
        with torch.inference_mode():
            return self(torch.as_tensor(np.asarray(tokens, np.int64),
                                        device=self.device))


def params_from_jax(tree):
    """The JAX decoder's ``param_tree()`` (arrays convertible with
    ``np.asarray``) as a ``state_dict`` for :class:`GenerativeDecoder`:
    ``decoder.load_state_dict(params_from_jax(jax_decoder.param_tree()))``.
    """
    names = {"ln1_g": "ln1.gamma", "ln1_b": "ln1.beta",
             "qkv_w": "qkv.weight", "qkv_b": "qkv.bias",
             "proj_w": "proj.weight", "proj_b": "proj.bias",
             "ln2_g": "ln2.gamma", "ln2_b": "ln2.beta",
             "ff1_w": "ff1.weight", "ff1_b": "ff1.bias",
             "ff2_w": "ff2.weight", "ff2_b": "ff2.bias"}
    sd = {"embed.weight": tree["embed_w"], "ln_f.gamma": tree["lnf_g"],
          "ln_f.beta": tree["lnf_b"], "head.weight": tree["head_w"]}
    for i, lp in enumerate(tree["layers"]):
        for jax_name, name in names.items():
            sd[f"layers.{i}.{name}"] = lp[jax_name]
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


class DecodeSteps:
    """One lane's prefill/decode steps over a decoder and a
    :class:`~.kvcache.BlockPool` on the same device. ``prefills`` and
    ``decodes`` count the calls (warmup included): each launches one
    attention kernel per layer on a CUDA device."""

    def __init__(self, decoder, pool):
        if decoder.device != pool.device:
            raise MXNetError(
                f"generate: decoder on {decoder.device} but block pool on "
                f"{pool.device}")
        self.decoder = decoder
        self.pool = pool
        self.prefills = 0
        self.decodes = 0

    @torch.inference_mode()
    def prefill(self, tokens, n_valid, blocks):
        """tokens (Tpad,) int, n_valid int, blocks (Tpad // BT,) int (tail
        entries = pad sink). Returns the first greedy token (a device
        scalar; the caller's reply transfer reads it)."""
        dec, pool = self.decoder, self.pool
        dev, bt = pool.device, pool.block_tokens
        t = len(tokens)
        nblk = t // bt
        hd, d = dec.head_dim, dec.d_model
        tok = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=dev).view(1, t)
        blk = torch.as_tensor(np.asarray(blocks, np.int64), device=dev)
        x = dec.embed(tok)                                   # (1, T, d)
        for li, layer in enumerate(dec.layers):
            q, k, v = layer.qkv_split(x)                     # (1, T, d) each
            pool.k[li][blk] = k.reshape(nblk, bt, dec.num_heads, hd)
            pool.v[li][blk] = v.reshape(nblk, bt, dec.num_heads, hd)
            a = flash_attention(_heads(q, dec.num_heads),
                                _heads(k, dec.num_heads),
                                _heads(v, dec.num_heads), causal=True)
            x = layer.tail(x, a.transpose(1, 2).reshape(1, t, d))
        self.prefills += 1
        # only the last prompt row's logits are read: the head runs on it
        # alone
        return torch.argmax(dec.logits(x[0, int(n_valid) - 1]))

    @torch.inference_mode()
    def decode(self, tokens, positions, tables):
        """One iteration-level decode step. tokens/positions (B,) int,
        tables (B, W) int. Padding rows carry position 0 and an
        all-pad-sink table; their output is discarded by the caller.
        Returns next-token ids (device tensor (B,))."""
        dec, pool = self.decoder, self.pool
        bt = pool.block_tokens
        tokens = np.asarray(tokens, np.int32)
        positions = np.asarray(positions, np.int32)
        tables = np.asarray(tables, np.int32)
        bsz, width = tables.shape
        blk = tables[np.arange(bsz), positions // bt]
        # one host->device copy carries every per-step input
        packed = torch.from_numpy(np.concatenate(
            [tokens, blk, positions % bt, positions + 1, tables.ravel()]))
        packed = packed.to(pool.device)
        tok, blk, slot, seq_lens = packed[:4 * bsz].view(4, bsz)
        blk, slot = blk.long(), slot.long()
        tab = packed[4 * bsz:].view(bsz, width)
        hd = dec.head_dim
        x = dec.embed(tok)                                   # (B, d)
        for li, layer in enumerate(dec.layers):
            q, k, v = layer.qkv_split(x)                     # (B, d) each
            # the token's own K/V lands in the cache BEFORE attention:
            # position p attends over [0, p] including itself
            pool.k[li][blk, slot] = k.view(bsz, dec.num_heads, hd)
            pool.v[li][blk, slot] = v.view(bsz, dec.num_heads, hd)
            a = paged_attention(q.view(bsz, dec.num_heads, hd), pool.k[li],
                                pool.v[li], tab, seq_lens)   # (B, H, hd)
            x = layer.tail(x, a.reshape(bsz, dec.d_model))
        self.decodes += 1
        return torch.argmax(dec.logits(x), dim=-1)


def reference_generate(decoder, prompt, max_new_tokens):
    """Unpaged single-request greedy oracle: re-run the full causal
    forward (plain attention, no cache, no paging, no batching) for
    every emitted token — what the decode plane must match token for
    token."""
    toks = [int(t) for t in np.asarray(prompt).ravel()]
    out = []
    with torch.inference_mode():
        for _ in range(int(max_new_tokens)):
            x = decoder.hidden(torch.tensor([toks], device=decoder.device))
            nxt = int(torch.argmax(decoder.logits(x[0, -1])))
            out.append(nxt)
            toks.append(nxt)
            if decoder.eos_id is not None and nxt == decoder.eos_id:
                break
    return out
