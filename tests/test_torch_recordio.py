"""The port's RecordIO (mxnet_tpu_torch.recordio) and its libjpeg decoder
(mxnet_tpu_torch._native imgdec) against the JAX package's: the same
records give the same .rec and .idx bytes, each package reads the
other's files, offsets and the streaming reader agree, the three payload
routes decode alike, and the port's native decoder (its own copy of
imgdec.cc, built under build/native/) gives the JAX build's bits. The
loader returns None only where the host has no jpeglib.h; a failed
build raises."""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import io as _io
import os
import subprocess

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu._native as jnative
import mxnet_tpu_torch as tmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch import recordio as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_REC = 24


def _jpeg(arr, quality=90):
    from PIL import Image
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _records():
    """(key, header, payload): JPEG payloads with scalar labels, then a
    few with vector labels and odd lengths (padding)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(N_REC):
        img = rng.integers(0, 255, (24 + i % 3, 40, 3), dtype=np.uint8)
        label = float(i % 5) if i % 4 else \
            rng.random(3).astype(np.float32)
        out.append((i, (0, label, i, 7), _jpeg(img)))
    out.append((N_REC, (0, 1.0, N_REC, 0), b"odd-length payload"))
    return out


def _write(pkg, d):
    rec, idx = os.path.join(d, "r.rec"), os.path.join(d, "r.idx")
    w = pkg.MXIndexedRecordIO(idx, rec, "w")
    for key, hdr, payload in _records():
        w.write_idx(key, pkg.pack(pkg.IRHeader(*hdr), payload))
    w.close()
    return rec, idx


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    jd = str(tmp_path_factory.mktemp("jax_rec"))
    td = str(tmp_path_factory.mktemp("port_rec"))
    return _write(jrec, jd), _write(trec, td)


def _read_all(pkg, rec):
    r = pkg.MXRecordIO(rec, "r")
    out = []
    while True:
        item = r.read()
        if item is None:
            break
        out.append(item)
    r.close()
    return out


def test_records_are_the_same_bytes_both_ways(files):
    (jr, ji), (tr, ti) = files
    for a, b in ((jr, tr), (ji, ti)):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), b
    # each package reads the other's file, sequentially and by key
    assert _read_all(trec, jr) == _read_all(jrec, tr) == _read_all(jrec, jr)
    j = jrec.MXIndexedRecordIO(ti, tr, "r")
    t = trec.MXIndexedRecordIO(ji, jr, "r")
    assert t.keys == j.keys == list(range(N_REC + 1))
    for key in (0, 5, N_REC):
        assert t.read_idx(key) == j.read_idx(key)
    j.close()
    t.close()


def test_pack_and_unpack_equal_the_jax_packages(files):
    for _, hdr, payload in _records():
        jb = jrec.pack(jrec.IRHeader(*hdr), payload)
        assert trec.pack(trec.IRHeader(*hdr), payload) == jb
        (jh, jp), (th, tp) = jrec.unpack(jb), trec.unpack(jb)
        assert tp == jp and th.flag == jh.flag and th.id == jh.id
        np.testing.assert_array_equal(np.asarray(th.label),
                                      np.asarray(jh.label))


def test_offsets_from_the_index_and_from_a_scan(files, tmp_path):
    (jr, _), (tr, _) = files
    want = jrec.load_record_offsets(jr)
    assert trec.load_record_offsets(tr) == want
    # no .idx beside the file: one framing scan finds the same offsets
    bare = tmp_path / "bare.rec"
    bare.write_bytes(open(tr, "rb").read())
    assert trec.load_record_offsets(str(bare)) == want
    assert jrec.load_record_offsets(str(bare)) == want


@pytest.mark.parametrize("chunk", [97, 4096])
def test_stream_reader_equals_the_jax_packages(files, chunk):
    """Small chunks make records straddle chunk boundaries; a byte range
    starts and stops on record boundaries."""
    (jr, _), _ = files
    offs = jrec.load_record_offsets(jr)
    for start, stop in ((0, None), (offs[3], offs[11])):
        got = list(trec.RecordIOStreamReader(jr, start, stop,
                                             chunk_bytes=chunk))
        want = list(jrec.RecordIOStreamReader(jr, start, stop,
                                              chunk_bytes=chunk))
        assert got == want and len(got) == (N_REC + 1 if stop is None
                                            else 8)


def test_payload_routes_decode_alike(tmp_path):
    """JPEG, PNG and raw .npy payloads through pack_img / unpack_img and
    decode_payload: both packages take the same route (cv2 where it is
    installed, else PIL)."""
    assert trec.cv2_present() == jrec.cv2_present()
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (12, 10, 3), dtype=np.uint8)
    hdr = (0, 3.0, 1, 0)
    for fmt in (".jpg", ".png"):
        jb = jrec.pack_img(jrec.IRHeader(*hdr), img, img_fmt=fmt)
        assert trec.pack_img(trec.IRHeader(*hdr), img, img_fmt=fmt) == jb
        np.testing.assert_array_equal(trec.unpack_img(jb)[1],
                                      jrec.unpack_img(jb)[1])
    buf = _io.BytesIO()
    np.save(buf, img.astype(np.float32))
    npy = buf.getvalue()
    np.testing.assert_array_equal(trec.decode_payload(npy),
                                  jrec.decode_payload(npy))


def test_native_decoder_gives_the_jax_builds_bits():
    """decode_jpeg (one image) and decode_batch (crop, mirror,
    normalize on the thread pool) against the JAX package's build, and
    a corrupt JPEG refused by both."""
    assert tnative.load_imgdec() is not None
    assert jnative.load_imgdec() is not None
    rng = np.random.default_rng(2)
    payloads = [_jpeg(rng.integers(0, 255, (36, 44, 3), dtype=np.uint8))
                for _ in range(6)]
    for p in payloads[:2]:
        np.testing.assert_array_equal(tnative.decode_jpeg(p),
                                      jnative.decode_jpeg(p))
    uv = rng.random((6, 2)).astype(np.float32)
    uv[0] = -1.0                         # a center crop
    mirror = np.array([0, 1, 0, 1, 1, 0], np.uint8)
    mean = np.array([123.68, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    got = tnative.decode_batch(payloads, 32, 30, uv, mirror, mean, std,
                               nthreads=3)
    want = jnative.decode_batch(payloads, 32, 30, uv, mirror, mean, std,
                                nthreads=2)
    assert got.shape == (6, 3, 32, 30)
    np.testing.assert_array_equal(got, want)
    bad = b"\xff\xd8not really a jpeg"
    assert tnative.decode_jpeg(bad) is None is jnative.decode_jpeg(bad)
    assert tnative.decode_jpeg(b"\x93NUMPY") is None
    with pytest.raises(tmx.MXNetError, match="native decode failed"):
        tnative.decode_batch([bad], 8, 8, np.full((1, 2), -1, np.float32),
                             np.zeros(1, np.uint8), mean, std)
    with pytest.raises(mx.MXNetError, match="native decode failed"):
        jnative.decode_batch([bad], 8, 8, np.full((1, 2), -1, np.float32),
                             np.zeros(1, np.uint8), mean, std)


def test_imgdec_builds_under_build_with_link_flags_after_the_source(
        monkeypatch, tmp_path):
    lib = tnative.load_imgdec()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(str(tnative.imgdec_library_path()))
    assert path.startswith(os.path.join(os.path.realpath(REPO), "build",
                                        "native") + os.sep)
    assert not [f for f in os.listdir(os.path.join(
        REPO, "mxnet_tpu_torch", "_native")) if f.endswith(".so")]
    # the same -O2 flags as the JAX loader, -ljpeg after the source
    cmds = []

    def run(cmd, **kw):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(tnative.subprocess, "run", run)
    out = tmp_path / "lib.so"
    tnative._build(tnative.SRC_DIR / "imgdec.cc", out, tnative.IMGDEC_LINK)
    cmd = cmds[0]
    assert cmd[:5] == ["g++", "-O2", "-shared", "-fPIC", "-pthread"]
    assert cmd.index("-ljpeg") > cmd.index(
        str(tnative.SRC_DIR / "imgdec.cc"))
    assert out.exists()


def test_loader_returns_none_only_without_the_header(monkeypatch):
    monkeypatch.setattr(tnative, "_imgdec_lib", None)
    monkeypatch.setattr(tnative, "_jpeg_header", False)
    assert tnative.load_imgdec() is None
    assert tnative.decode_jpeg(_jpeg(np.zeros((8, 8, 3), np.uint8))) \
        is None
    # the header present but the compile failing: raised, with its output
    monkeypatch.setattr(tnative, "_jpeg_header", True)

    def broken(src, out, extra_flags=()):
        raise subprocess.CalledProcessError(1, ["g++"], stderr="boom")

    monkeypatch.setattr(tnative, "_build", broken)
    with pytest.raises(tmx.MXNetError, match="boom"):
        tnative.load_imgdec()
