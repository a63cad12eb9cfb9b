"""2-bit gradient compression with an error-feedback residual (the port
of ``mxnet_tpu/kvstore/gradient_compression.py``; ref:
src/kvstore/gradient_compression.h:37-121, the quantize_2bit kernel).

Each element of ``grad + residual`` maps to one of three codes, +threshold
if >= threshold, -threshold if <= -threshold, else 0, and the
quantization error stays in ``residual`` for the next round. 16 two-bit
codes pack into one little-endian u32 word (code 1 -> +threshold, 2 ->
-threshold), the format ``accumulate_2bit`` in ``_native/comm.cc``
unpacks on the server, so a compressed push stays compressed on the
wire. The quantizer runs in float32 on the gradient's device, where the
residual lives; only the packed words (1/16 of the gradient's bytes)
cross to the host. The words, the decoded values and the residual are
bit-identical to the JAX package's on the same gradients.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError


class GradientCompression:
    def __init__(self, type="2bit", threshold=0.5):
        if type != "2bit":
            raise MXNetError(f"unsupported compression type {type!r}")
        if threshold <= 0:
            raise MXNetError("threshold must be positive")
        self.type = type
        self.threshold = float(threshold)
        self._residual = {}

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}

    def quantize(self, key, grad):
        """``grad`` (a float32 tensor, or a numpy array) -> (the packed
        u32 words as numpy, the decoded values as a float32 tensor on
        the gradient's device); updates the key's residual."""
        g = torch.as_tensor(grad).detach().to(torch.float32)
        res = self._residual.get(key)
        if res is None or res.shape != g.shape or res.device != g.device:
            res = torch.zeros_like(g)
        g = g + res
        t = torch.tensor(self.threshold, dtype=torch.float32,
                         device=g.device)
        codes = torch.zeros(g.shape, dtype=torch.int64, device=g.device)
        codes[g >= t] = 1
        codes[g <= -t] = 2
        zero = torch.zeros((), dtype=torch.float32, device=g.device)
        decoded = torch.where(codes == 1, t, torch.where(codes == 2, -t,
                                                         zero))
        self._residual[key] = g - decoded
        return self._pack(codes.reshape(-1)), decoded

    @staticmethod
    def _pack(codes):
        """int64 codes (0, 1, 2) -> little-endian u32 words of 16, as
        numpy; the packing runs where the codes are."""
        n = codes.numel()
        nwords = (n + 15) // 16
        padded = torch.zeros(nwords * 16, dtype=torch.int64,
                             device=codes.device)
        padded[:n] = codes
        shifts = 2 * torch.arange(16, dtype=torch.int64, device=codes.device)
        words = (padded.reshape(nwords, 16) << shifts).sum(dim=1)
        return words.cpu().numpy().astype(np.uint32)

    @staticmethod
    def unpack(words, n, threshold):
        """Inverse of ``_pack`` and the decode (the server's
        ``accumulate_2bit``): float32 numpy of ``n`` values."""
        words = np.asarray(words, dtype=np.uint32)
        shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
        codes = ((words[:, None] >> shifts) & 0x3).ravel()[:n]
        return np.where(codes == 1, threshold,
                        np.where(codes == 2, -threshold, 0.0)
                        ).astype(np.float32)

    def wire_payload(self, key, grad):
        """The whole payload of a PUSH_2BIT message: f32 threshold, u64
        element count, the packed words."""
        words, _ = self.quantize(key, grad)
        n = torch.as_tensor(grad).numel()
        return (np.float32(self.threshold).tobytes()
                + np.uint64(n).tobytes() + words.tobytes())
