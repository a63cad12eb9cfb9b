"""Bucket ladder helpers (the subset of ``mxnet_tpu/serving/variants.py``
the generative path uses)."""
from __future__ import annotations

from ..base import MXNetError


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
