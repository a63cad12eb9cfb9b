"""The port's record pipeline (mxnet_tpu_torch.io.pipeline) beyond
parity: the ring rule (no batch aliases a ring slot), a corrupt JPEG
raising as in the JAX package, a stall raising within its timeout, rings
that do not fit in /dev/shm, teardown (no process or shared-memory
segment left after close or del), the in-process fallback for records
that do not divide, and the device feeder on the CPU. Every test runs
under a 30 s alarm and every ring wait under the pipeline's own 10 s
timeout (record_harness.py)."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import errno
import gc
import os
import signal
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.io import ShardedRecordPipeline as JPipeline
from mxnet_tpu_torch.io import ShardedRecordPipeline, pipeline as tpipe
from record_harness import (AUG_PIPELINE, BATCH, CROP, N_REC, WAIT_S,
                            deadline, drain, own_segment_names, pack, same,
                            segment_exists)


@pytest.fixture(scope="module", autouse=True)
def own_names():
    with own_segment_names():
        yield


@pytest.fixture(autouse=True)
def per_test_deadline():
    with deadline(30):
        yield


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return pack(str(tmp_path_factory.mktemp("irec")), N_REC)


def _port(rec_path, **kw):
    return ShardedRecordPipeline(rec_path, (3, CROP, CROP), BATCH,
                                 timeout=WAIT_S, **kw)


@pytest.fixture(scope="module")
def jax_stream(rec):
    """Two epochs of the JAX pipeline at 2 workers with every augment,
    and the decoder its workers were handed."""
    p = JPipeline(rec, (3, CROP, CROP), BATCH, num_workers=2,
                  **AUG_PIPELINE)
    try:
        out = drain(p)
        p.reset()
        out += drain(p)
        lib = p._spec_base["imgdec_lib"]
    finally:
        p.close()
    return out, lib


def test_a_batch_never_aliases_its_ring_slot(rec):
    """Rewrite the slot a batch came from after next(): the batch keeps
    its values, and its storage lies outside every ring."""
    with tmx.cpu():
        p = _port(rec, num_workers=2)
        try:
            for _ in range(3):
                b = p.next()
            kept = b.data[0].asnumpy().copy()
            w = p._workers[(p._cursor - 1) % 2]
            slot = ((p._cursor - 1) // 2) % p._nslots
            w.views["data"][slot][:] = np.nan
            w.views["label"][slot][:] = -1.0
            np.testing.assert_array_equal(b.data[0].asnumpy(), kept)
            assert (b.label[0].asnumpy() >= 0).all()
            for wk in p._workers:
                lo = wk.views["data"].ctypes.data
                hi = lo + wk.views["data"].nbytes
                for a in (b.data[0], b.label[0]):
                    assert not lo <= a._data.data_ptr() < hi
        finally:
            p.close()


def test_corrupt_jpeg_raises_as_in_the_jax_package(tmp_path):
    rec = os.path.join(str(tmp_path), "bad.rec")
    w = jrec.MXIndexedRecordIO(os.path.join(str(tmp_path), "bad.idx"),
                               rec, "w")
    for i in range(16):
        w.write_idx(i, jrec.pack(jrec.IRHeader(0, float(i), i, 0),
                                 b"\xff\xd8not really a jpeg"))
    w.close()
    j = JPipeline(rec, (3, 8, 8), 8, num_workers=2)
    try:
        with pytest.raises(mx.MXNetError, match="decode worker failed"):
            j.next()
    finally:
        j.close()
    with tmx.cpu():
        p = ShardedRecordPipeline(rec, (3, 8, 8), 8, num_workers=2,
                                  timeout=WAIT_S)
        try:
            with pytest.raises(tmx.MXNetError,
                               match="decode worker failed.*native decode"):
                p.next()
        finally:
            p.close()
        # in process: the native batch decoder's error, in both packages
        kw = dict(path_imgrec=rec, data_shape=(3, 8, 8), batch_size=8)
        t = tmx.io.ImageRecordIter(**kw)
        with pytest.raises(tmx.MXNetError, match="native decode failed"):
            t.next()
        t.close()
    j = mx.io.ImageRecordIter(**kw)
    with pytest.raises(mx.MXNetError, match="native decode failed"):
        j.next()
    j.close()


def test_a_stall_raises_within_the_timeout(rec):
    """A worker stopped (SIGSTOP) while alive: ``io pipeline stalled``
    in about the timeout, not at the 120 s default."""
    with tmx.cpu():
        p = ShardedRecordPipeline(rec, (3, CROP, CROP), BATCH,
                                  num_workers=1, ring_batches=2,
                                  timeout=0.5)
        pid = p._workers[0].proc.pid
        os.kill(pid, signal.SIGSTOP)
        try:
            t0 = time.perf_counter()
            with pytest.raises(tmx.MXNetError, match="io pipeline stalled"):
                for _ in range(3):      # it filled at most its two slots
                    p.next()
            assert time.perf_counter() - t0 < 5.0
        finally:
            os.kill(pid, signal.SIGCONT)
            p.close()


def test_rings_that_do_not_fit_raise_with_their_sizes(rec, monkeypatch):
    """/dev/shm without room for a ring: raised as the ring is made,
    naming the sizes, never a hang or a worker's SIGBUS; no segment and
    no worker is left behind."""
    made = []

    def full(fd, offset, size):
        made.append(os.readlink(f"/proc/self/fd/{fd}"))
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(tpipe.os, "posix_fallocate", full)
    with pytest.raises(tmx.MXNetError, match=r"ring of \d+ B \(3 slots x "
                       r"batch 8 x 3 x 32 x 32 float32 .* B free"):
        _port(rec, num_workers=2, ring_batches=3)
    assert made and not any(os.path.exists(m) for m in made)


def test_close_and_del_leave_no_process_or_segment(rec):
    with tmx.cpu():
        p = _port(rec, num_workers=2)
        p.next()
        names = {w.shm.name for w in p._workers}
        # a ring a worker
        assert len(names) == 2 and all(map(segment_exists, names))
        procs = [w.proc for w in p._workers]
        p.close()
        p.close()                                  # idempotent
        assert not any(map(segment_exists, names))
        assert all(proc.poll() is not None for proc in procs)
        q = _port(rec, num_workers=2)
        q.next()
        names = {w.shm.name for w in q._workers}
        procs = [w.proc for w in q._workers]
        del q
        gc.collect()
    assert not any(map(segment_exists, names))
    for proc in procs:
        assert proc.wait(timeout=WAIT_S) is not None


def test_records_that_do_not_divide_take_the_in_process_iterator(rec):
    with pytest.warns(UserWarning, match="do not divide"):
        with tmx.cpu():
            it = tmx.io.ImageRecordIter(path_imgrec=rec,
                                        data_shape=(3, CROP, CROP),
                                        batch_size=24, num_workers=2)
    assert isinstance(it, tmx.io.ImageRecordIter)
    it.close()


def test_device_feeder_on_the_cpu(rec, jax_stream):
    """DeviceFeeder over the pipeline: the same batches, the consumer's
    blocked time counted; with a sharding, each array laid out over the
    mesh (the same values), as ``to_device(sharding=)`` lays it."""
    want = jax_stream[0][:N_REC // BATCH]
    assert jax_stream[1] is not None
    with tmx.cpu():
        p = _port(rec, num_workers=2, **AUG_PIPELINE)
        feeder = tmx.io.DeviceFeeder(p)
        try:
            got = drain(feeder)
            assert p.decoders() == ["libjpeg"]
        finally:
            feeder.close()
            p.close()
        assert feeder.items == len(want) and feeder.wait_seconds > 0
        par = tmx.parallel
        sharding = par.NamedSharding(
            par.create_mesh({"dp": 2}, devices=["cpu", "cpu"]),
            par.PartitionSpec("dp"))
        one = tmx.io.DataBatch(data=[tmx.nd.array(want[0][0])],
                               label=[tmx.nd.array(want[0][1])])
        fed = tmx.io.DeviceFeeder(iter([one]), sharding=sharding)
        try:
            b, = list(fed)
        finally:
            fed.close()
        assert isinstance(b.data[0], par.Sharded)
        assert b.data[0].shards[0].shape[0] == BATCH // 2
        same([(np.asarray(b.data[0]), np.asarray(b.label[0]))], want[:1])
        moved = tpipe.to_device(tmx.io.DataBatch(
            data=[np.ones((2, 3), np.float32)], label=[]))
        assert moved.data[0].context == tmx.cpu()
        assert moved.data[0].asnumpy().sum() == 6.0
        laid = tpipe.to_device([np.arange(6.0).reshape(2, 3)], sharding)
        assert [s.tolist() for s in laid[0].shards] == [[[0, 1, 2]],
                                                        [[3, 4, 5]]]
    same(got, want)
