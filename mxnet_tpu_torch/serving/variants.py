"""Per-model precision variants (the port of
``mxnet_tpu/serving/variants.py``): one executable per (variant, shape
bucket), sharing one weight load, all on one device. A
:class:`VariantSet` holds one lane's executables:

- ``fp32``: the checkpoint as loaded, the gateway's reference;
- ``bf16``: float parameters cast to bfloat16 once, float inputs cast at
  the graph edge, outputs cast back to float32 (on the card, cuDNN's
  and cuBLAS's bf16 kernels);
- ``int8``: ``contrib.quantization.quantize_model`` (BatchNorm folding,
  calibration, offline weight quantization) run once at registration,
  then lowered per backend: ``native`` runs the quantized graph itself
  (the port's int8 ops: im2col and ``torch._int_mm``, and the plain
  ``requantize``; the graph is not partitioned, so the hand-written
  requantize epilogue is not reached here), ``dequant`` serves the
  weight-only realization (the int8 weights folded back through their
  scales into float32 constants on the BatchNorm-folded graph).
  ``auto`` picks ``native`` on a chip backend (a CUDA card, as the JAX
  package counts ``gpu`` among its chip backends) and ``dequant`` on the
  CPU.

``warmup`` runs every (variant, bucket) once, so cuDNN and cuBLAS have
chosen their algorithms before the first request. Several replicas of a
model on one device share one set of executables and weights through
:meth:`VariantSet.replica`.
"""
from __future__ import annotations

import copy
import logging

import numpy as np

from ..base import MXNetError
from ..context import Context, resolve_device

VARIANTS = ("fp32", "bf16", "int8")


def default_buckets(max_batch):
    """Powers of two up to ``max_batch`` (which is always included):
    8 -> (1, 2, 4, 8), 12 -> (1, 2, 4, 8, 12). Padding waste is
    bounded at <2x rows while the bucket count stays O(log n)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise MXNetError("serving: max_batch must be >= 1")
    out = set()
    b = 1
    while b < max_batch:
        out.add(b)
        b *= 2
    out.add(max_batch)
    return tuple(sorted(out))


def pick_bucket(buckets, rows):
    """Smallest bucket >= rows (buckets is the sorted tuple)."""
    for b in buckets:
        if b >= rows:
            return b
    raise MXNetError(
        f"serving: batch of {rows} rows exceeds the largest bucket "
        f"{buckets[-1]} (admission should have rejected it)")


class VariantSet:
    """One lane's compiled forwards: ``run(variant, batch)`` where
    ``batch`` is a numpy array padded to a warmed bucket. Parameters
    follow :class:`~mxnet_tpu_torch.predictor.Predictor` plus the
    variants; ``device`` (``cuda:0`` when None; raises without CUDA
    unless the CPU is asked for) holds the parameters and runs the
    compute."""

    def __init__(self, symbol, arg_params, aux_params, input_name,
                 feature_shape, variants=("fp32",), device=None,
                 calib_data=None, calib_mode="naive",
                 excluded_sym_names=None, input_dtype="float32",
                 int8_lowering="auto", logger=logging):
        self.input_name = input_name
        self.feature_shape = tuple(int(s) for s in feature_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.device = resolve_device(device)
        self.variants = tuple(variants)
        self.num_outputs = len(symbol.list_outputs())
        self.int8_lowering = None
        self.int8_symbol = None       # the quantized graph, with int8
        self._fns = {}
        for v in self.variants:
            if v not in VARIANTS:
                raise MXNetError(
                    f"serving: unknown variant {v!r} (have {VARIANTS})")
        if int8_lowering not in ("auto", "native", "dequant"):
            raise MXNetError(
                f"serving: int8_lowering {int8_lowering!r} not in "
                "('auto', 'native', 'dequant')")
        if "fp32" in self.variants:
            self._fns["fp32"] = self._compile(symbol, arg_params,
                                              aux_params)
        if "bf16" in self.variants:
            self._fns["bf16"] = self._compile(symbol, arg_params,
                                              aux_params, cast="bfloat16")
        if "int8" in self.variants:
            qsym, qarg, qaux = self._quantize(
                symbol, arg_params, aux_params, calib_data, calib_mode,
                excluded_sym_names, logger)
            if int8_lowering == "auto":
                int8_lowering = "native" if self._chip_backend() \
                    else "dequant"
            if int8_lowering == "native":
                self._fns["int8"] = self._compile(qsym, qarg, qaux)
            else:
                self._fns["int8"] = self._compile(*self._dequant_lowered(
                    symbol, arg_params, aux_params, qarg))
            self.int8_lowering = int8_lowering
            self.int8_symbol = qsym

    # -- build -------------------------------------------------------------
    def _chip_backend(self):
        return self.device.type == "cuda"

    def _dequant_lowered(self, symbol, arg_params, aux_params, qarg):
        """The weight-only realization: every parameter the
        QuantizeGraph pass quantized offline, folded back to float32
        through its calibrated scale and bound to the BatchNorm-folded
        graph."""
        from ..contrib.quantization import (dequantize_offline_params,
                                            fold_batch_norm)

        fsym, farg = fold_batch_norm(symbol, arg_params, aux_params)
        out = dict(farg)
        for base, w in dequantize_offline_params(qarg).items():
            if base in out:
                out[base] = w
        return fsym, out, aux_params

    def _quantize(self, symbol, arg_params, aux_params, calib_data,
                  calib_mode, excluded_sym_names, logger):
        from ..contrib.quantization import quantize_model
        from ..io import NDArrayIter

        ctx = Context(self.device)
        it = None
        if calib_mode != "none":
            if calib_data is None:
                raise MXNetError(
                    "serving: int8 variant needs calib_data (numpy "
                    "batch of representative inputs) unless "
                    "calib_mode='none'")
            calib = np.asarray(calib_data, self.input_dtype)
            it = NDArrayIter(data={self.input_name: calib},
                             batch_size=min(len(calib), 8))
        with ctx:     # the calibration batches go where the weights are
            return quantize_model(
                symbol, arg_params, aux_params, ctx=ctx,
                calib_mode=calib_mode, calib_data=it,
                num_calib_examples=None if it is None else len(calib),
                excluded_sym_names=excluded_sym_names, logger=logger)

    def _compile(self, symbol, arg_params, aux_params, cast=None):
        from ..predictor import compile_symbol_forward

        bindings = dict(arg_params)
        bindings.update(aux_params)
        return compile_symbol_forward(symbol, bindings, device=self.device,
                                      cast=cast)

    def replica(self):
        """Another ``VariantSet`` over the same compiled forwards and
        weights: the replicas of one model on one device share them,
        while each replica holds its own object, so a probe of one, or
        a fault injected into its ``run``, touches that replica
        alone."""
        twin = copy.copy(self)
        twin._fns = dict(self._fns)
        return twin

    # -- dispatch ----------------------------------------------------------
    def run(self, variant, batch):
        """Execute one padded batch: numpy in, a list of numpy out (the
        copy to the host is the reply's sync)."""
        fn, pvals = self._fns[variant]
        outs = fn(pvals, {self.input_name: np.ascontiguousarray(batch)})
        return [o.cpu().numpy() for o in outs]

    def warmup(self, buckets):
        """Run every (variant, bucket) once on a zeros batch; returns
        the number of executables warmed."""
        n = 0
        for variant in self.variants:
            for b in buckets:
                self.run(variant, np.zeros((b,) + self.feature_shape,
                                           self.input_dtype))
                n += 1
        return n
