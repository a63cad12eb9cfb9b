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

A tensor-parallel lane runs the same steps as one
:func:`~mxnet_tpu_torch.parallel.mesh.shard_map` over the lane's slice,
each shard on its heads.

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
from ...parallel.collectives import allgather, allreduce, axis_index
from ...parallel.layout import SpecLayout
from ...parallel.mesh import P, shard_map
from ...profiling import memory as _mem
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


def _layer_tail(lp, x, attn_flat, reduce=None):
    """Residual + projection + pre-norm MLP. Shapes (..., d). On a
    tensor-parallel shard ``reduce`` (its allreduce) sums the
    row-parallel products of the projection and ``ff2`` before their
    bias."""
    y = x + _row_dense(attn_flat, lp["proj_w"], lp["proj_b"], reduce)
    h = layer_norm(y, lp["ln2_g"], lp["ln2_b"])
    z = activation(fully_connected(h, lp["ff1_w"], lp["ff1_b"],
                                   flatten=False), "relu")
    return y + _row_dense(z, lp["ff2_w"], lp["ff2_b"], reduce)


def _row_dense(x, w, b, reduce):
    if reduce is None:
        return fully_connected(x, w, b, flatten=False)
    return reduce(fully_connected(x, w, None, no_bias=True,
                                  flatten=False)) + b


def _final_logits(params, x):
    h = layer_norm(x, params["lnf_g"], params["lnf_b"])
    return fully_connected(h, params["head_w"], None, no_bias=True,
                           flatten=False)


def _heads(y, num_heads):
    """(B, T, d) -> (B, H, T, hd) view."""
    b, t, d = y.shape
    return y.view(b, t, num_heads, d // num_heads).transpose(1, 2)


class DecodeSteps:
    """One lane's prefill/decode steps over a decoder and the lane's
    :class:`~.kvcache.BlockPool` (the JAX ``CompiledDecodeSteps``).
    ``prefills`` and ``decodes`` count the calls (warmup included): each
    launches one attention kernel per layer and shard on a CUDA device.

    Lanes on the decoder's device share its parameters (read at every
    call, so training after registration is served). A lane on another
    device serves a copy of the weights taken when its steps were built,
    as the JAX package places each lane's parameters on its device.

    A pool over a ``tp``-device slice (a device tuple) makes a
    tensor-parallel lane (JAX ``model.py:216-233``): each step runs as
    one :func:`~mxnet_tpu_torch.parallel.mesh.shard_map` over the pool's
    ``{"tp": tp}`` mesh, one shard thread a device, and each shard's
    weights follow the layout table (``layout``, by default
    :meth:`SpecLayout.default`), copied from the decoder's
    ``param_tree()`` when the steps are built:

    - ``attention-qkv`` column-parallel: a shard takes *its heads'* rows
      of q, k and v (and of the bias), so the prefill runs K3 and the
      decode K4 on the shard's ``heads / tp`` heads, over its pool shard
      (a contiguous block of ``qkv_w``'s rows would split heads across
      shards: GSPMD reshards that, an explicit program cannot);
    - ``attention-out`` and ``mlp-out`` row-parallel, one ``allreduce``
      each, their bias added after it; ``mlp-in`` column-parallel;
    - the embedding vocab-sharded (a masked lookup, then an
      ``allreduce``) and the head column-parallel (logits gathered
      before the argmax), or each replicated where the table's fit
      drops the axis (vocab % tp != 0); norms replicated.

    Greedy tokens equal the single-device lane's up to the row-parallel
    sums' reassociation."""

    def __init__(self, decoder, pool, layout=None):
        self.decoder = decoder
        self.pool = pool
        self._copy = None
        self._split = {"embed_w": False, "head_w": False}
        self._prefill, self._decode = self._prefill_body, self._decode_body
        if pool.tp > 1:
            layout = layout if layout is not None else SpecLayout.default()
            self._split = _slice_plan(decoder, layout, pool.mesh)
            self._shards = [_shard_tree(decoder, self._split, s, pool.tp, d)
                            for s, d in enumerate(pool.devices)]
            self._prefill = shard_map(self._prefill_body, pool.mesh,
                                      in_specs=(P(), P(), None),
                                      out_specs=P())
            self._decode = shard_map(self._decode_body, pool.mesh,
                                     in_specs=(P(), None, None),
                                     out_specs=P())
        elif decoder.device != pool.device:
            self._copy = _tree_to(decoder.param_tree(), pool.device)
        # the lane's own weights (a copy or the tp shards) are parameters
        # in the census; the pool's tensors carry kv_cache
        # (kvcache.BlockPool tags them where it allocates them)
        _mem.tag_tree((self._copy, getattr(self, "_shards", None)),
                      "parameter")
        _mem.tag_tree((pool.k, pool.v), "kv_cache")
        self.prefills = 0
        self.decodes = 0

    def _local(self):
        """``(params, k, v, heads, reduce)`` of the calling shard: the
        whole lane at tp 1; on a shard thread, its weights, its pool
        tensors, its ``heads / tp`` heads and the allreduce that sums
        its row-parallel products."""
        pool = self.pool
        if pool.tp == 1:
            params = self._copy if self._copy is not None \
                else self.decoder.param_tree()
            return params, pool.k, pool.v, self.decoder.num_heads, None
        s = axis_index("tp")
        return (self._shards[s], pool.k[s], pool.v[s],
                self.decoder.num_heads // pool.tp, _allreduce_tp)

    # -- the layer math (one shard's, or the whole lane's) -------------------
    def _embed(self, p, tok):
        w = p["embed_w"]
        if not self._split["embed_w"]:
            return embedding(tok, w)
        # the reference clips ids into the vocabulary; then each shard
        # looks up the ids its rows hold and the allreduce adds the one
        # non-zero row a token has
        local = tok.long().clamp(0, self.decoder.vocab_size - 1) - p["lo"]
        hit = (local >= 0) & (local < w.shape[0])
        return _allreduce_tp(embedding(local, w) * hit[..., None].to(w.dtype))

    def _next_token(self, p, x):
        logits = _final_logits(p, x)
        if self._split["head_w"]:
            logits = allgather(logits, "tp", axis=logits.ndim - 1)
        return torch.argmax(logits, dim=-1)

    def _prefill_body(self, tok, blk, n_valid):
        p, ks, vs, heads, reduce = self._local()
        pool, hd = self.pool, self.decoder.head_dim
        t, bt = tok.shape[1], pool.block_tokens
        nblk = t // bt
        x = self._embed(p, tok)                              # (1, T, d)
        for li, lp in enumerate(p["layers"]):
            q, k, v = _qkv(lp, x)                    # (1, T, heads * hd) each
            # in the pool's type (JAX's .at[].set casts; index_put_ does not)
            # (columns past hd, a pool padded to the kernel's size, stay 0)
            ks[li][blk, ..., :hd] = k.reshape(nblk, bt, heads,
                                              hd).to(pool.dtype)
            vs[li][blk, ..., :hd] = v.reshape(nblk, bt, heads,
                                              hd).to(pool.dtype)
            a = flash_attention(_heads(q, heads), _heads(k, heads),
                                _heads(v, heads), causal=True)
            x = _layer_tail(lp, x, a.transpose(1, 2).reshape(1, t, heads * hd),
                            reduce)
        # only the last prompt row's logits are read: the head runs on it
        # alone
        return self._next_token(p, x[0, n_valid - 1])

    def _decode_body(self, packed, bsz, width):
        p, ks, vs, heads, reduce = self._local()
        pool, hd = self.pool, self.decoder.head_dim
        tok, blk, slot, seq_lens = packed[:4 * bsz].view(4, bsz)
        blk, slot = blk.long(), slot.long()
        tab = packed[4 * bsz:].view(bsz, width)
        x = self._embed(p, tok)                              # (B, d)
        for li, lp in enumerate(p["layers"]):
            q, k, v = _qkv(lp, x)                    # (B, heads * hd) each
            # the token's own K/V lands in the cache BEFORE attention:
            # position p attends over [0, p] including itself
            ks[li][blk, slot, :, :hd] = k.view(bsz, heads, hd).to(pool.dtype)
            vs[li][blk, slot, :, :hd] = v.view(bsz, heads, hd).to(pool.dtype)
            a = paged_attention(q.view(bsz, heads, hd), ks[li], vs[li], tab,
                                seq_lens)                    # (B, heads, hd)
            x = _layer_tail(lp, x, a.reshape(bsz, heads * hd), reduce)
        return self._next_token(p, x)

    # -- the steps ----------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens, n_valid, blocks):
        """tokens (Tpad,) int, n_valid int, blocks (Tpad // BT,) int (tail
        entries = pad sink). Returns the first greedy token (a device
        scalar; the caller's reply transfer reads it)."""
        dev = self.pool.device
        tok = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=dev).view(1, len(tokens))
        blk = torch.as_tensor(np.asarray(blocks, np.int64), device=dev)
        out = self._prefill(tok, blk, int(n_valid))
        self.prefills += 1
        return out

    @torch.inference_mode()
    def decode(self, tokens, positions, tables):
        """One iteration-level decode step. tokens/positions (B,) int,
        tables (B, W) int. Padding rows carry position 0 and an
        all-pad-sink table; their output is discarded by the caller.
        Returns next-token ids (device tensor (B,))."""
        bt = self.pool.block_tokens
        tokens = np.asarray(tokens, np.int32)
        positions = np.asarray(positions, np.int32)
        tables = np.asarray(tables, np.int32)
        bsz, width = tables.shape
        blk = tables[np.arange(bsz), positions // bt]
        # one host->device copy carries every per-step input
        packed = torch.from_numpy(np.concatenate(
            [tokens, blk, positions % bt, positions + 1, tables.ravel()]))
        out = self._decode(packed.to(self.pool.device), bsz, width)
        self.decodes += 1
        return out


def _allreduce_tp(x):
    return allreduce(x, "tp")


# the decoder's weights, by role, as a tp lane splits them: (param_tree
# key, the fitted spec the split needs; None: sharded or replicated)
_COLUMN, _ROW = ("tp",), (None, "tp")
_SLICE_SPECS = {"qkv_w": _COLUMN, "ff1_w": _COLUMN, "proj_w": _ROW,
                "ff2_w": _ROW, "embed_w": None, "head_w": None}


def _slice_plan(decoder, layout, mesh):
    """``{key: sharded}`` for the embedding and the head, checking that
    the layout places the attention and MLP weights as the tp lane
    splits them (column- or row-parallel over ``tp``)."""
    tree = decoder.param_tree()
    specs = layout.resolve_specs(tree, mesh)
    plan = {}
    for key, want in _SLICE_SPECS.items():
        got = [specs[key]] if key in specs else \
            [lp[key] for lp in specs["layers"]]
        for spec in got:
            if want is None:
                if tuple(spec) not in ((), _COLUMN):
                    raise MXNetError(
                        f"generate: the tp lane splits {key} over the "
                        f"vocabulary or replicates it; the layout gives "
                        f"{spec}")
                plan[key] = tuple(spec) == _COLUMN
            elif tuple(spec) != want:
                raise MXNetError(
                    f"generate: the tp lane splits {key} as P{want}; the "
                    f"layout gives {spec}")
    return plan


def _shard_tree(decoder, plan, s, tp, device):
    """Shard ``s`` of ``tp``'s weights on ``device`` (copies that own
    their bytes)."""
    hs = decoder.num_heads // tp
    cols = slice(s * hs * decoder.head_dim, (s + 1) * hs * decoder.head_dim)
    d = decoder.d_model
    qkv_rows = torch.cat([torch.arange(cols.start, cols.stop) + j * d
                          for j in range(3)])

    def own(t):
        return t.detach().to(device, copy=True)

    def rows(t, n):
        c = t.shape[0] // n
        return own(t[s * c:(s + 1) * c])

    tree = decoder.param_tree()
    out = {"layers": []}
    for key in ("lnf_g", "lnf_b"):
        out[key] = own(tree[key])
    for key in ("embed_w", "head_w"):
        out[key] = rows(tree[key], tp) if plan[key] else own(tree[key])
    out["lo"] = s * (decoder.vocab_size // tp) if plan["embed_w"] else 0
    for lp in tree["layers"]:
        mine = {k: own(lp[k]) for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b",
                                        "proj_b", "ff2_b")}
        mine["qkv_w"] = own(lp["qkv_w"][qkv_rows])
        mine["qkv_b"] = own(lp["qkv_b"][qkv_rows])
        mine["proj_w"] = own(lp["proj_w"][:, cols])
        mine["ff1_w"] = rows(lp["ff1_w"], tp)
        mine["ff1_b"] = rows(lp["ff1_b"], tp)
        c = lp["ff2_w"].shape[1] // tp
        mine["ff2_w"] = own(lp["ff2_w"][:, s * c:(s + 1) * c])
        out["layers"].append(mine)
    return out


def _tree_to(tree, device):
    """A detached copy of a :meth:`GenerativeDecoder.param_tree` on
    ``device``."""
    with torch.no_grad():
        return {k: ([{n: t.detach().to(device) for n, t in lp.items()}
                     for lp in v] if k == "layers"
                    else v.detach().to(device)) for k, v in tree.items()}


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
