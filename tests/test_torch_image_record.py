"""The port's ImageRecordIter and its sharded decode pipeline
(mxnet_tpu_torch.io, io/pipeline.py) against the JAX package's on one
seeded .rec: the in-process iterator bitwise without random augments
(its crops are drawn per decode thread), the sharded pipeline at 2
workers bitwise with shuffle, random crops and mirrors over two epochs,
after a worker's SIGKILL and respawn, after a state_dict resume, with
streaming shards and on the PIL route, and equal to the port's
in-process order. Each test states the decoder both sides ran. Every
test runs under a 30 s alarm and every ring wait under the pipeline's
own 10 s timeout (record_harness.py)."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import signal

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.io import ShardedRecordPipeline as JPipeline
from mxnet_tpu_torch.io import ShardedRecordPipeline, pipeline as tpipe
from record_harness import (AUG, AUG_PIPELINE, BATCH, CROP, N_REC, WAIT_S,
                            deadline, drain, own_segment_names, pack, same)


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


def test_in_process_iterator_equals_jax(rec):
    """num_workers=0, shuffled by the iterator's seed, normalized, two
    epochs and a state_dict resume mid-epoch; libjpeg on both sides."""
    kw = dict(path_imgrec=rec, data_shape=(3, CROP, CROP), batch_size=BATCH,
              shuffle=True, seed=3, mean_r=10.0, std_b=3.0, num_workers=0)
    j = mx.io.ImageRecordIter(**kw)
    with tmx.cpu():
        t = tmx.io.ImageRecordIter(**kw)
        assert isinstance(t, tmx.io.ImageRecordIter)
        assert t.decoders() == ["libjpeg"] and j._native is not None
        want, got = drain(j), drain(t)
        j.reset()
        t.reset()
        want += drain(j, 3)
        got += drain(t, 3)
        state = t.state_dict()
        want += drain(j)
        got += drain(t)
        t2 = tmx.io.ImageRecordIter(**kw)
        t2.load_state_dict(state)
        resumed = drain(t2)
    for it in (j, t, t2):
        it.close()
    assert len(got) == 2 * N_REC // BATCH
    same(got, want)
    same(resumed, want[N_REC // BATCH + 3:])


def test_sharded_pipeline_equals_jax_over_two_epochs(rec, jax_stream):
    want, jlib = jax_stream
    assert jlib is not None                    # the JAX workers' libjpeg
    with tmx.cpu():
        p = tmx.io.ImageRecordIter(path_imgrec=rec,
                                   data_shape=(3, CROP, CROP),
                                   batch_size=BATCH, num_workers=2,
                                   timeout=WAIT_S, **AUG)
        assert isinstance(p, ShardedRecordPipeline)
        try:
            got = drain(p)
            p.reset()
            got += drain(p)
            assert p.decoders() == ["libjpeg"]
        finally:
            p.close()
    assert len(got) == 2 * N_REC // BATCH
    same(got, want)
    labels = np.concatenate([lb for _, lb in got[:N_REC // BATCH]])
    assert sorted(labels.tolist()) == sorted(float(i % 10)
                                             for i in range(N_REC))


def test_sharded_order_matches_the_in_process_iterator(rec):
    """The JAX package's test_order_matches_single_process, bitwise:
    batch-striped shards delivered round robin give the in-process
    iterator's batches."""
    kw = dict(path_imgrec=rec, data_shape=(3, CROP, CROP),
              batch_size=BATCH, shuffle=True, seed=9, mean_g=50.0)
    with tmx.cpu():
        it0 = tmx.io.ImageRecordIter(num_workers=0, **kw)
        ref = drain(it0)
        it0.close()
        p = tmx.io.ImageRecordIter(num_workers=2, timeout=WAIT_S, **kw)
        try:
            got = drain(p)
            assert p.decoders() == ["libjpeg"]
        finally:
            p.close()
    same(got, ref)


def test_respawn_after_sigkill_is_bitwise(rec, jax_stream):
    """SIGKILL a worker after its first batch: with two ring slots it
    cannot have decoded the rest of its epoch, so its shard resumes at
    its last acknowledged batch, and the two epochs equal the JAX
    pipeline's undisturbed stream."""
    assert jax_stream[1] is not None           # the JAX workers' libjpeg
    with tmx.cpu():
        p = _port(rec, num_workers=2, ring_batches=2, **AUG_PIPELINE)
        try:
            got = drain(p, 1)
            p._workers[0].proc.send_signal(signal.SIGKILL)
            p._workers[0].proc.wait(timeout=WAIT_S)
            got += drain(p)
            assert p.respawns == 1
            p.reset()
            got += drain(p)
            assert p.decoders() == ["libjpeg"]
        finally:
            p.close()
    same(got, jax_stream[0])


def test_state_dict_resume_mid_epoch_is_bitwise(rec, jax_stream):
    """A state taken after 3 batches of the second epoch resumes, in a
    new pipeline, on the JAX stream's next batch."""
    want, jlib = jax_stream
    assert jlib is not None
    epoch = N_REC // BATCH
    with tmx.cpu():
        p = _port(rec, num_workers=2, **AUG_PIPELINE)
        try:
            drain(p)
            p.reset()
            drain(p, 3)
            state = p.state_dict()
        finally:
            p.close()
        assert state["epoch"] == 1 and state["cursor"] == 3
        q = _port(rec, num_workers=2, **AUG_PIPELINE)
        try:
            q.load_state_dict(state)
            got = drain(q)
            assert q.decoders() == ["libjpeg"]
        finally:
            q.close()
    same(got, want[epoch + 3:])


def test_streaming_shards_equal_jax(rec):
    """streaming=True: contiguous byte ranges read ahead in chunks,
    shuffled inside the readahead window by the per-batch RNG; one
    epoch bitwise the JAX pipeline's, covering every record."""
    kw = dict(num_workers=2, streaming=True, readahead_mb=1,
              **AUG_PIPELINE)
    j = JPipeline(rec, (3, CROP, CROP), BATCH, **kw)
    try:
        assert j._spec_base["imgdec_lib"] is not None
        want = drain(j)
    finally:
        j.close()
    with tmx.cpu():
        p = _port(rec, **kw)
        try:
            got = drain(p)
            assert p.decoders() == ["libjpeg"]
        finally:
            p.close()
    same(got, want)
    labels = np.concatenate([lb for _, lb in got])
    assert sorted(labels.tolist()) == sorted(float(i % 10)
                                             for i in range(N_REC))


def test_pil_route_equals_jax(rec, monkeypatch):
    """Where a host has no libjpeg (the card's host, for one) both
    packages' workers decode with PIL, and still agree bitwise."""
    monkeypatch.setattr(tpipe, "_imgdec_lib_path", lambda: None)
    from mxnet_tpu.io import pipeline as jpipe
    monkeypatch.setattr(jpipe, "_imgdec_lib_path", lambda: None)
    j = JPipeline(rec, (3, CROP, CROP), BATCH, num_workers=2,
                  **AUG_PIPELINE)
    try:
        assert j._spec_base["imgdec_lib"] is None
        want = drain(j, 2)
    finally:
        j.close()
    with tmx.cpu():
        p = _port(rec, num_workers=2, **AUG_PIPELINE)
        try:
            got = drain(p, 2)
            assert p.decoders() == ["pil"]
        finally:
            p.close()
    same(got, want)
