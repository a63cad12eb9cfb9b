"""Model checkpoints (the port of ``mxnet_tpu/model.py``'s checkpoint
helpers): ``prefix-symbol.json`` plus ``prefix-####.params``, an NDArray
map whose keys carry ``arg:`` / ``aux:`` prefixes. Either package reads
the other's checkpoints."""
from __future__ import annotations

import numpy as np

from . import ndarray as nd
from . import symbol as sym_mod


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """(ref: model.py:383 save_checkpoint)"""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch, ctx=None):
    """(arg_params, aux_params) of ``prefix-####.params``, on ``ctx``
    (the current context when None)."""
    save_dict = nd.load(f"{prefix}-{epoch:04d}.params", ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "aux":
            aux_params[name] = v
        else:
            arg_params[name if tp == "arg" else k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    """(ref: model.py:413 load_checkpoint) -> (symbol, arg_params,
    aux_params)."""
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch, ctx=ctx)
    return symbol, arg_params, aux_params


def params_from_jax(arg, aux, ctx=None):
    """The JAX package's parameter dicts (values convertible with
    ``np.asarray``: its NDArrays' ``asnumpy()``, numpy arrays) as the
    port's NDArray dicts on ``ctx``:
    ``params_from_jax({k: v.asnumpy() ...}, {...})``."""
    def conv(d):
        return {k: nd.array(np.asarray(v), ctx=ctx) for k, v in d.items()}
    return conv(arg), conv(aux)
