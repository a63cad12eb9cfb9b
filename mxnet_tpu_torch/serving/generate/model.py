"""The decode plane's model path (counterpart of
``mxnet_tpu/serving/generate/model.py``): a pre-norm causal transformer
LM as a gluon block, and the prefill / decode steps that read and write
the paged cache.

- :class:`DecoderLM` / :class:`DecoderLayer`: the gluon
  ``HybridBlock``s of the JAX package's ``_build_block`` (same parameter
  names, same ``hybrid_forward``, attention through
  ``F.flash_attention(q, k, v, causal=True)``). Under
  ``autograd.record`` they train with ``gluon.loss`` and
  ``gluon.Trainer``; on a CUDA device the attention's forward and
  backward are the port's hand-written kernels;
- ``prefill``: one request's (padded) prompt through the stack with the
  causal :func:`~mxnet_tpu_torch.ops.attention.flash_attention`,
  writing every layer's K/V into the request's pool blocks and
  returning the first greedy token;
- ``decode``: one token per in-flight request (iteration-level batch),
  K/V written at each request's position, attention over the paged
  cache via :func:`~mxnet_tpu_torch.ops.attention.paged_attention`,
  next greedy tokens out.

There is one copy of the weights: the block's parameters. The serving
steps read them through :meth:`GenerativeDecoder.param_tree` at every
call, so a decoder trained after it was registered serves what
``Trainer.step`` wrote. On a CUDA device both attention calls launch the
port's hand-written kernels; the products around them are
``torch.matmul`` (cuBLAS), as the JAX package leaves them to XLA.
PyTorch runs eagerly, so there is nothing to compile per bucket; the
lane still warms every bucket once.

:func:`reference_generate` is the correctness oracle: an *unpaged*
single-request greedy decode that re-runs the full causal forward per
emitted token through the *plain* attention, so it checks the kernels
independently. The gateway's paged output must match it token for
token.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import ndarray as nd
from ...base import MXNetError
from ...context import resolve_device
from ...gluon import nn
from ...gluon.block import HybridBlock
from ...ops.attention import (flash_attention, flash_attention_plain,
                              paged_attention)
from ...ops.nn import activation, fully_connected, layer_norm
from ...ops.registry import dtype_name, torch_dtype
from ...ops.tensor import embedding
from ...random import generator


class DecoderLayer(HybridBlock):
    """Pre-norm causal self-attention + ReLU MLP (JAX ``_build_block``):
    the Dense weights in ``dtype``, LayerNorm in float32."""

    def __init__(self, d_model, num_heads, ff_mult, dtype="float32", **kw):
        super().__init__(**kw)
        self._d_model = d_model
        self._num_heads = num_heads
        with self.name_scope():
            self.ln1 = nn.LayerNorm(in_channels=d_model)
            self.qkv = nn.Dense(3 * d_model, flatten=False,
                                in_units=d_model, dtype=dtype)
            self.proj = nn.Dense(d_model, flatten=False, in_units=d_model,
                                 dtype=dtype)
            self.ln2 = nn.LayerNorm(in_channels=d_model)
            self.ff1 = nn.Dense(ff_mult * d_model, flatten=False,
                                in_units=d_model, dtype=dtype)
            self.ff2 = nn.Dense(d_model, flatten=False,
                                in_units=ff_mult * d_model, dtype=dtype)

    def hybrid_forward(self, F, x):
        b, t, _ = x.shape
        nh, d_model = self._num_heads, self._d_model
        h = self.ln1(x)
        qkv = self.qkv(h).reshape(b, t, 3, nh, d_model // nh)
        q = F.transpose(F.slice_axis(qkv, axis=2, begin=0, end=1)
                        .reshape(b, t, nh, -1), axes=(0, 2, 1, 3))
        k = F.transpose(F.slice_axis(qkv, axis=2, begin=1, end=2)
                        .reshape(b, t, nh, -1), axes=(0, 2, 1, 3))
        v = F.transpose(F.slice_axis(qkv, axis=2, begin=2, end=3)
                        .reshape(b, t, nh, -1), axes=(0, 2, 1, 3))
        a = F.flash_attention(q, k, v, causal=True)
        a = F.transpose(a, axes=(0, 2, 1, 3)).reshape(b, t, d_model)
        x = x + self.proj(a)
        h2 = self.ln2(x)
        return x + self.ff2(F.Activation(self.ff1(h2), act_type="relu"))


class DecoderLM(HybridBlock):
    """Embedding, ``num_layers`` :class:`DecoderLayer`, final LayerNorm
    and an untied vocabulary head: int tokens (B, T) -> logits
    (B, T, vocab). Embedding and Dense weights in ``dtype``, LayerNorm
    in float32, as the JAX ``_build_block``."""

    def __init__(self, vocab_size, d_model, num_layers, num_heads,
                 ff_mult, dtype="float32", **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, d_model, dtype=dtype)
            self.layers = []
            for i in range(num_layers):
                layer = DecoderLayer(d_model, num_heads, ff_mult, dtype)
                setattr(self, "layer%d" % i, layer)
                self.layers.append(layer)
            self.ln_f = nn.LayerNorm(in_channels=d_model)
            self.head = nn.Dense(vocab_size, use_bias=False, flatten=False,
                                 in_units=d_model, dtype=dtype)

    def hybrid_forward(self, F, tokens):
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.head(self.ln_f(x))


# param_tree() key -> (DecoderLayer child, parameter) and the structured
# state_dict name of :func:`params_from_jax`
_LAYER_PARAMS = {"ln1_g": ("ln1", "gamma"), "ln1_b": ("ln1", "beta"),
                 "qkv_w": ("qkv", "weight"), "qkv_b": ("qkv", "bias"),
                 "proj_w": ("proj", "weight"), "proj_b": ("proj", "bias"),
                 "ln2_g": ("ln2", "gamma"), "ln2_b": ("ln2", "beta"),
                 "ff1_w": ("ff1", "weight"), "ff1_b": ("ff1", "bias"),
                 "ff2_w": ("ff2", "weight"), "ff2_b": ("ff2", "bias")}
_TOP_PARAMS = {"embed_w": ("embed", "weight"), "lnf_g": ("ln_f", "gamma"),
               "lnf_b": ("ln_f", "beta"), "head_w": ("head", "weight")}


class GenerativeDecoder:
    """Model + config bundle for ``Gateway.register_generator``.

    ``num_heads * head_dim == d_model``; ``max_prompt_tokens`` and the
    per-request ``max_new_tokens`` cap bound the block-table width. The
    model is the gluon block :attr:`block` (:class:`DecoderLM`), whose
    parameters initialise through gluon (``Uniform(0.07)`` weights, zero
    biases, LayerNorm gamma 1 and beta 0) from a ``torch.Generator``
    seeded with ``seed``, on ``device`` (``cuda:0`` by default; raises
    without CUDA unless ``"cpu"``). ``dtype`` is float32 or bfloat16:
    the Embedding and Dense weights and the paged pool take it, the
    LayerNorm parameters stay float32, so the residual stream is f32
    and the decode step's paged attention reads f32 queries over a
    bf16 cache, as the JAX package's. A JAX decoder's weights (its
    ``param_tree()``, which holds its block's gluon parameters) load
    through :func:`params_from_jax` and :meth:`load_state_dict`.
    """

    def __init__(self, vocab_size, d_model=64, num_layers=2, num_heads=4,
                 ff_mult=4, max_prompt_tokens=64, eos_id=None,
                 dtype="float32", device=None, seed=0):
        if d_model % num_heads:
            raise MXNetError(
                f"generate: d_model {d_model} not divisible by "
                f"num_heads {num_heads}")
        if dtype_name(dtype) not in ("float32", "bfloat16"):
            raise MXNetError(
                f"generate: dtype {dtype!r} unsupported; the port's decode "
                "kernels take float32 or bfloat16 caches")
        device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = self.d_model // self.num_heads
        self.ff_mult = int(ff_mult)
        self.max_prompt_tokens = int(max_prompt_tokens)
        self.eos_id = eos_id
        self.dtype = torch_dtype(dtype)
        self.block = DecoderLM(self.vocab_size, self.d_model,
                               self.num_layers, self.num_heads,
                               self.ff_mult, dtype_name(dtype))
        self.block.initialize(ctx=device, generator=generator(seed))

    @property
    def device(self):
        return self.block.head.weight.data()._data.device

    # -- parameters ----------------------------------------------------------
    def _params(self):
        """(param_tree key, layer index or None, gluon Parameter)."""
        b = self.block
        for key, (child, name) in _TOP_PARAMS.items():
            yield key, None, getattr(getattr(b, child), name)
        for i, layer in enumerate(b.layers):
            for key, (child, name) in _LAYER_PARAMS.items():
                yield key, i, getattr(getattr(layer, child), name)

    def param_tree(self):
        """The block's parameter tensors, structured as the JAX
        package's ``param_tree()`` (the serving steps' weights; no
        copy)."""
        tree = {"layers": [{} for _ in self.block.layers]}
        for key, i, p in self._params():
            (tree if i is None else tree["layers"][i])[key] = \
                p.data()._data
        return tree

    def state_dict(self):
        """Detached parameter tensors by structured name
        (``layers.0.qkv.weight``), the names :func:`params_from_jax`
        gives."""
        return {_sd_name(key, i): p.data()._data.detach()
                for key, i, p in self._params()}

    def load_state_dict(self, state):
        """Set every parameter from a :meth:`state_dict`-named mapping
        (values copied onto the block's device)."""
        mine = {_sd_name(key, i): p for key, i, p in self._params()}
        if set(state) != set(mine):
            raise MXNetError(
                f"load_state_dict: missing {sorted(set(mine) - set(state))}"
                f", unexpected {sorted(set(state) - set(mine))}")
        for name, p in mine.items():
            p.set_data(state[name])

    def full_logits(self, tokens):
        """Reference path: the gluon block's own full causal forward.
        ``tokens``: int array (B, T) -> logits NDArray (B, T, vocab)."""
        return self.block(nd.array(np.asarray(tokens, np.int32),
                                   ctx=self.device))


def _sd_name(key, layer):
    if layer is None:
        child, name = _TOP_PARAMS[key]
        return f"{child}.{name}"
    child, name = _LAYER_PARAMS[key]
    return f"layers.{layer}.{child}.{name}"


def params_from_jax(tree):
    """The JAX decoder's ``param_tree()`` (arrays convertible with
    ``np.asarray``) as a :meth:`GenerativeDecoder.state_dict` mapping:
    ``decoder.load_state_dict(params_from_jax(jax_decoder.param_tree()))``.
    bfloat16 leaves stay bfloat16: they travel as float32, exact both
    ways, so this needs no numpy bfloat16 type."""
    sd = {_sd_name(key, None): tree[key] for key in _TOP_PARAMS}
    for i, lp in enumerate(tree["layers"]):
        for key in _LAYER_PARAMS:
            sd[_sd_name(key, i)] = lp[key]
    return {k: _tensor_of(v) for k, v in sd.items()}


def _tensor_of(value):
    value = np.asarray(value)
    t = torch.from_numpy(np.array(value, np.float32))
    return t.to(torch.bfloat16) if value.dtype.name == "bfloat16" else t


# ---------------------------------------------------------------------------
# layer math of the serving steps, over param_tree()
# ---------------------------------------------------------------------------

def _qkv(lp, x):
    """q, k, v of shape (..., d): ``split(qkv, 3, -1)``, which equals the
    block's ``reshape(b, t, 3, H, hd)``."""
    h = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    return fully_connected(h, lp["qkv_w"], lp["qkv_b"],
                           flatten=False).chunk(3, dim=-1)


def _layer_tail(lp, x, attn_flat):
    """Residual + projection + pre-norm MLP. Shapes (..., d)."""
    y = x + fully_connected(attn_flat, lp["proj_w"], lp["proj_b"],
                            flatten=False)
    h = layer_norm(y, lp["ln2_g"], lp["ln2_b"])
    z = activation(fully_connected(h, lp["ff1_w"], lp["ff1_b"],
                                   flatten=False), "relu")
    return y + fully_connected(z, lp["ff2_w"], lp["ff2_b"], flatten=False)


def _final_logits(params, x):
    h = layer_norm(x, params["lnf_g"], params["lnf_b"])
    return fully_connected(h, params["head_w"], None, no_bias=True,
                           flatten=False)


def _heads(y, num_heads):
    """(B, T, d) -> (B, H, T, hd) view."""
    b, t, d = y.shape
    return y.view(b, t, num_heads, d // num_heads).transpose(1, 2)


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
        params = dec.param_tree()
        x = embedding(tok, params["embed_w"])                # (1, T, d)
        for li, lp in enumerate(params["layers"]):
            q, k, v = _qkv(lp, x)                            # (1, T, d) each
            # in the pool's type (JAX's .at[].set casts; index_put_ does not)
            pool.k[li][blk] = k.reshape(nblk, bt, dec.num_heads,
                                        hd).to(pool.dtype)
            pool.v[li][blk] = v.reshape(nblk, bt, dec.num_heads,
                                        hd).to(pool.dtype)
            a = flash_attention(_heads(q, dec.num_heads),
                                _heads(k, dec.num_heads),
                                _heads(v, dec.num_heads), causal=True)
            x = _layer_tail(lp, x, a.transpose(1, 2).reshape(1, t, d))
        self.prefills += 1
        # only the last prompt row's logits are read: the head runs on it
        # alone
        return torch.argmax(_final_logits(params, x[0, int(n_valid) - 1]))

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
        params = dec.param_tree()
        x = embedding(tok, params["embed_w"])                # (B, d)
        for li, lp in enumerate(params["layers"]):
            q, k, v = _qkv(lp, x)                            # (B, d) each
            # the token's own K/V lands in the cache BEFORE attention:
            # position p attends over [0, p] including itself
            pool.k[li][blk, slot] = k.view(bsz, dec.num_heads,
                                           hd).to(pool.dtype)
            pool.v[li][blk, slot] = v.view(bsz, dec.num_heads,
                                           hd).to(pool.dtype)
            a = paged_attention(q.view(bsz, dec.num_heads, hd), pool.k[li],
                                pool.v[li], tab, seq_lens)   # (B, H, hd)
            x = _layer_tail(lp, x, a.reshape(bsz, dec.d_model))
        self.decodes += 1
        return torch.argmax(_final_logits(params, x), dim=-1)


def _hidden_plain(params, tokens, num_heads):
    """Full causal forward through the plain attention: int tokens
    (B, T) -> final hidden states (B, T, d)."""
    x = embedding(tokens, params["embed_w"])
    b, t, d = x.shape
    for lp in params["layers"]:
        q, k, v = (_heads(y, num_heads) for y in _qkv(lp, x))
        a = flash_attention_plain(q, k, v, causal=True)
        x = _layer_tail(lp, x, a.transpose(1, 2).reshape(b, t, d))
    return x


def reference_generate(decoder, prompt, max_new_tokens):
    """Unpaged single-request greedy oracle: re-run the full causal
    forward (plain attention, no cache, no paging, no batching) for
    every emitted token — what the decode plane must match token for
    token."""
    toks = [int(t) for t in np.asarray(prompt).ravel()]
    out = []
    with torch.inference_mode():
        params = decoder.param_tree()
        for _ in range(int(max_new_tokens)):
            x = _hidden_plain(params, torch.tensor([toks],
                                                   device=decoder.device),
                              decoder.num_heads)
            nxt = int(torch.argmax(_final_logits(params, x[0, -1])))
            out.append(nxt)
            toks.append(nxt)
            if decoder.eos_id is not None and nxt == decoder.eos_id:
                break
    return out
