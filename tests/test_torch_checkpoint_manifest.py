"""The port's file writers keep the checkpoint manifest the JAX package
keeps, and its reader checks it: ``nd.save`` / ``nd.save_reference`` /
``Symbol.save`` write through ``checkpoint.atomic_write`` (size and
CRC32 in the directory's ``MANIFEST.json``), and ``nd.load`` runs
``checkpoint.verify`` before it decodes. A file either package writes in
a directory the other wrote into stays loadable by both, and a
manifest-listed file with a flipped byte is refused by both before any
decoder reads it."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError


def _manifest(d):
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return json.load(f)["files"]


def _flip(path, at=-5):
    raw = bytearray(open(path, "rb").read())
    raw[at] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_save_over_the_other_package_then_both_load(tmp_path, first):
    """One package saves, the other overwrites the same file: both
    packages' ``nd.load`` read the second file's values (the manifest
    entry follows the overwrite)."""
    f = str(tmp_path / "w.params")
    ones = np.ones(4, np.float32)
    zeros = np.zeros(4, np.float32)
    jsave = lambda v: jmx.nd.save(f, {"a": jmx.nd.array(v)})  # noqa: E731
    tsave = lambda v: tmx.nd.save(  # noqa: E731
        f, {"a": tmx.nd.array(v, ctx=tmx.cpu())})
    (jsave if first == "jax" else tsave)(ones)
    (tsave if first == "jax" else jsave)(zeros)
    assert "w.params" in _manifest(str(tmp_path))
    np.testing.assert_array_equal(jmx.nd.load(f)["a"].asnumpy(), zeros)
    np.testing.assert_array_equal(
        tmx.nd.load(f, ctx=tmx.cpu())["a"].asnumpy(), zeros)


@pytest.mark.parametrize("writer", ["save", "save_reference"])
def test_flipped_byte_refused_before_decoding(tmp_path, writer):
    """A byte flipped in a manifest-listed file: the port's ``nd.load``
    raises the integrity error, as the JAX package's does, not a decode
    error or wrong values."""
    f = str(tmp_path / "p.params")
    getattr(tmx.nd, writer)(f, {"w": tmx.nd.array(
        np.arange(64, dtype=np.float32), ctx=tmx.cpu())})
    entry = _manifest(str(tmp_path))["p.params"]
    assert entry["size"] == os.path.getsize(f)
    _flip(f)
    with pytest.raises(MXNetError, match="failed integrity check"):
        tmx.nd.load(f, ctx=tmx.cpu())
    with pytest.raises(jmx.base.MXNetError, match="failed integrity check"):
        jmx.nd.load(f)


def test_unlisted_file_still_loads(tmp_path):
    """A file with no manifest entry (written by hand) loads as before."""
    f = str(tmp_path / "hand.npz")
    np.savez(f, a=np.arange(3, dtype=np.float32))
    np.testing.assert_array_equal(
        tmx.nd.load(f, ctx=tmx.cpu())["a"].asnumpy(), [0, 1, 2])


def test_symbol_save_records_a_manifest_entry(tmp_path):
    """``Symbol.save`` writes through ``atomic_write``: its JSON has a
    manifest entry, both packages load it, and a flipped byte fails the
    JAX package's check of it."""
    from mxnet_tpu_torch import checkpoint as tckpt
    f = str(tmp_path / "net-symbol.json")
    data = tmx.sym.var("data")
    net = tmx.sym.FullyConnected(data, num_hidden=3, name="fc")
    net.save(f)
    entry = _manifest(str(tmp_path))["net-symbol.json"]
    assert entry["size"] == os.path.getsize(f)
    assert tckpt.verify(f) is True
    assert tmx.sym.load(f).list_arguments() == \
        jmx.sym.load(f).list_arguments() == ["data", "fc_weight", "fc_bias"]
    _flip(f, at=10)
    with pytest.raises(MXNetError, match="failed integrity check"):
        tckpt.verify(f)
