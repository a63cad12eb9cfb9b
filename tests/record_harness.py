"""Shared set-up of the record pipeline's CPU tests
(``test_torch_image_record.py``, ``test_torch_record_pipeline.py``,
``test_torch_record_fit.py``): seeded .rec files, a per-test deadline,
ring segments named apart from the default ``psm_`` ones (which
``test_io_pipeline.py`` counts in /dev/shm while it runs beside these
files), and batch comparison."""
import contextlib
import io as _io
import os
import secrets
import signal
from multiprocessing import shared_memory

import numpy as np

from mxnet_tpu import recordio as jrec

N_REC, HW, CROP, BATCH = 64, 40, 32, 8
# every ring wait of a port pipeline in these tests, in seconds
WAIT_S = 10
MEAN, STD = (123.68, 116.28, 103.53), (58.395, 57.12, 57.375)
# ImageRecordIter's spelling of the augments AUG_PIPELINE gives
AUG = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=5,
           mean_r=MEAN[0], mean_g=MEAN[1], mean_b=MEAN[2], std_r=STD[0],
           std_g=STD[1], std_b=STD[2])
AUG_PIPELINE = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=5,
                    mean=MEAN, std=STD)


def pack(path, n, hw=HW, seed=0):
    """A seeded .rec / .idx of ``n`` JPEGs of ``hw`` x ``hw`` (labels
    i % 10), written by the JAX package."""
    from PIL import Image
    rec = os.path.join(path, f"r{n}.rec")
    w = jrec.MXIndexedRecordIO(os.path.join(path, f"r{n}.idx"), rec, "w")
    rng = np.random.default_rng(seed)
    for i in range(n):
        buf = _io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (hw, hw, 3), dtype=np.uint8)) \
            .save(buf, format="JPEG", quality=90)
        w.write_idx(i, jrec.pack(jrec.IRHeader(0, float(i % 10), i, 0),
                                 buf.getvalue()))
    w.close()
    return rec


class OwnNamedSegment(shared_memory.SharedMemory):
    """A SharedMemory whose new segments are named mxtorch_test_*."""

    def __init__(self, name=None, create=False, size=0):
        if create and name is None:
            name = "mxtorch_test_" + secrets.token_hex(8)
        super().__init__(name, create, size)


@contextlib.contextmanager
def own_segment_names():
    """Rings made inside (by either package) take OwnNamedSegment names."""
    saved = shared_memory.SharedMemory
    shared_memory.SharedMemory = OwnNamedSegment
    try:
        yield
    finally:
        shared_memory.SharedMemory = saved


@contextlib.contextmanager
def deadline(seconds=30):
    """SIGALRM raises in the main thread after ``seconds``, whatever it
    waits on."""
    def expire(*_):
        raise TimeoutError(f"test deadline ({seconds} s) passed")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def segment_exists(name):
    return os.path.exists(os.path.join("/dev/shm", name))


def drain(it, n=None):
    """(data, label) numpy of up to ``n`` batches."""
    out = []
    for b in it:
        out.append((b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy()))
        if n is not None and len(out) == n:
            break
    return out


def same(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.dtype == wd.dtype == np.float32
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
