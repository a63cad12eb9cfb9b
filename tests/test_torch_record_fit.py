"""The record pipeline's training path on the CPU: Module.fit of a small
convnet fed by the port's ImageRecordIter(num_workers=2) through the
device feeder (PrefetchingIter(prefetch_to_device=True)) against the
same Module fed the JAX package's pipeline batches as NDArrays. The
test runs under a 30 s alarm, every ring wait under a 10 s timeout
(record_harness.py)."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import numpy as np

import mxnet_tpu_torch as tmx
from mxnet_tpu.io import ShardedRecordPipeline as JPipeline
from record_harness import (AUG, AUG_PIPELINE, BATCH, CROP, WAIT_S, deadline,
                            drain, own_segment_names, pack)


def _convnet(sym):
    d = sym.var("data")
    d = sym.Activation(sym.Convolution(d, name="c1", kernel=(3, 3),
                                       num_filter=4), act_type="relu")
    d = sym.Pooling(d, pool_type="max", kernel=(2, 2), stride=(2, 2))
    d = sym.FullyConnected(sym.Flatten(d), name="fc", num_hidden=10)
    return sym.SoftmaxOutput(d, name="softmax")


def _fit(train, arg_p):
    mod = tmx.mod.Module(_convnet(tmx.sym), context=tmx.cpu())
    mod.fit(train, optimizer="sgd", num_epoch=1, arg_params=arg_p,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_fed_by_the_sharded_pipeline(tmp_path):
    """Two SGD steps (one epoch of 16 records at batch 8); the fit's
    reset before its first batch reads nothing ahead, so the port trains
    on the pipeline's first epoch, as the JAX batches are."""
    with deadline(30), own_segment_names():
        rec = pack(str(tmp_path), 2 * BATCH, seed=1)
        j = JPipeline(rec, (3, CROP, CROP), BATCH, num_workers=2,
                      **AUG_PIPELINE)
        try:
            jb = drain(j)
            assert j._spec_base["imgdec_lib"] is not None   # libjpeg
        finally:
            j.close()
        assert len(jb) == 2
        rng = np.random.default_rng(0)
        arg_p = {"c1_weight": rng.normal(0, 0.1, (4, 3, 3, 3)),
                 "c1_bias": np.zeros(4), "fc_bias": np.zeros(10),
                 "fc_weight": rng.normal(0, 0.02, (10, 4 * 15 * 15))}
        with tmx.cpu():
            arg_p = {k: tmx.nd.array(v.astype(np.float32))
                     for k, v in arg_p.items()}
            want = _fit(tmx.io.NDArrayIter(
                np.concatenate([x for x, _ in jb]),
                np.concatenate([y for _, y in jb]), batch_size=BATCH), arg_p)
            p = tmx.io.ImageRecordIter(
                path_imgrec=rec, data_shape=(3, CROP, CROP),
                batch_size=BATCH, num_workers=2, timeout=WAIT_S, **AUG)
            feed = tmx.io.PrefetchingIter(p, prefetch_to_device=True)
            try:
                got = _fit(feed, arg_p)
                assert feed.feeder.items == 2
                assert p.decoders() == ["libjpeg"]
            finally:
                feed.feeder.close()
                p.close()
    assert set(got) == set(want)
    for k in want:
        assert not np.array_equal(want[k], arg_p[k].asnumpy())
        np.testing.assert_array_equal(got[k], want[k])
