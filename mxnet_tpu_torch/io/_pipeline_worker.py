"""Decode-worker process for the port's sharded input pipeline
(``io/pipeline.py``; the port of ``mxnet_tpu/io/_pipeline_worker.py``).

Runs as a plain script (``python _pipeline_worker.py spec.json``) so a
worker never imports torch or either package: it pays no torch import,
inherits no CUDA context (forking one is unsafe; these workers are
decode-only), and starts in a fraction of a second. Imports are stdlib
+ numpy + the port's libjpeg decoder (``_native/imgdec.cc``, built into
``build/native/``) loaded by path through ctypes, else PIL where the
host has no libjpeg.

One worker owns a disjoint shard of the record index and a private
ring of batch slots inside the parent's shared-memory segment
(layout below — the parent imports this module for the same layout
functions). Protocol per slot is single-producer/single-consumer:

    worker:  wait state==EMPTY -> decode batch into the slot payload
             -> meta=(gidx, nsamples) -> state=READY  (or ERROR)
    parent:  wait state==READY and gidx match -> device-copy views
             -> state=EMPTY, acked+=1

The worker's batch counter ``g`` is GLOBAL across epochs (epoch
``g // batches_per_epoch``), so "respawn resumed from the last-acked
batch" is just ``start_batch=<acked>`` in the spec: epoch permutations
and per-batch augmentation RNG derive from ``(seed, epoch)`` /
``(seed, worker, g)``, never from process state. The reference's
analogue is one OMP decode+augment+batch pipeline
(src/io/iter_image_recordio_2.cc); here the OMP team is a process per
shard, each driving its own libjpeg pool.
"""
from __future__ import annotations

import ctypes
import io as _io
import json
import mmap
import os
import queue
import struct
import sys
import threading
import time

import numpy as np

# ---------------------------------------------------------------- layout

MAGIC = 0x4D585250          # "MXRP"
HDR_I64 = 8                 # header int64 slots (3 spare)
# H_STOP: parent->worker shutdown; H_PRODUCED/H_HEARTBEAT:
# worker->parent progress, read by the parent's stall diagnostics;
# H_DECODERS: the DEC_* bits of every decoder the worker has run
H_MAGIC, H_STOP, H_PRODUCED, H_HEARTBEAT, H_DECODERS = range(5)
DEC_LIBJPEG, DEC_PIL, DEC_NPY = 1, 2, 4
DECODER_NAMES = {DEC_LIBJPEG: "libjpeg", DEC_PIL: "pil", DEC_NPY: "npy"}
META_I64 = 4                # per-slot meta int64 slots
M_STATE, M_GIDX, M_NSAMPLES, M_ERRLEN = range(4)
EMPTY, READY, ERROR = 0, 1, 2

REC_MAGIC = 0xCED7230A      # RecordIO framing (recordio.py _MAGIC)
LFLAG_MASK = (1 << 29) - 1
IR_FORMAT = "IfQQ"          # IRHeader: flag, label, id, id2
IR_SIZE = struct.calcsize(IR_FORMAT)


def ring_layout(nslots, batch, th, tw, label_width):
    """Byte offsets of every region in one worker's shm segment:
    {header, meta, data, label, total} — the single source of truth
    both the parent and the worker map their numpy views from."""
    off = 0
    header = (off, (HDR_I64,))
    off += HDR_I64 * 8
    meta = (off, (nslots, META_I64))
    off += nslots * META_I64 * 8
    data = (off, (nslots, batch, 3, th, tw))
    off += nslots * batch * 3 * th * tw * 4
    label = (off, (nslots, batch, label_width))
    off += nslots * batch * label_width * 4
    return {"header": header, "meta": meta, "data": data,
            "label": label, "total": off}


def map_views(buf, layout):
    """Numpy views over a ring segment (shared-memory buffer or mmap)."""
    def view(key, dtype):
        off, shape = layout[key]
        count = int(np.prod(shape))
        return np.frombuffer(buf, dtype=dtype, count=count,
                             offset=off).reshape(shape)
    views = {
        "header": view("header", np.int64),
        "meta": view("meta", np.int64),
        "data": view("data", np.float32),
        "label": view("label", np.float32),
    }
    for v in views.values():
        v.flags.writeable = True
    return views


def batch_rng(seed, worker_id, gidx):
    """Augmentation RNG for one (worker, global batch): derived, never
    carried — a respawned worker reproduces the exact crops/mirrors of
    the batch it redecodes."""
    return np.random.RandomState(
        (int(seed) * 1_000_003 + worker_id * 9_973 + gidx) % (2 ** 31))


def epoch_permutation(seed, epoch, num_records, shuffle):
    if not shuffle:
        return np.arange(num_records)
    return np.random.RandomState((int(seed) + epoch) % (2 ** 31)) \
        .permutation(num_records)


# ------------------------------------------------------------- record io

def read_record_at(f, offset):
    f.seek(offset)
    magic, lrec = struct.unpack("<II", f.read(8))
    if magic != REC_MAGIC:
        raise IOError(f"invalid RecordIO magic at {offset}")
    return f.read(lrec & LFLAG_MASK)


def unpack_record(raw, label_width):
    """(payload bytes, label float32[label_width]) from one record."""
    flag, label, _id, _id2 = struct.unpack(IR_FORMAT, raw[:IR_SIZE])
    payload = raw[IR_SIZE:]
    if flag > 0:
        lab = np.frombuffer(payload[:flag * 4], np.float32)
        payload = payload[flag * 4:]
    else:
        lab = np.array([label], np.float32)
    out = np.zeros(label_width, np.float32)
    out[:min(label_width, len(lab))] = lab[:label_width]
    return payload, out


def stream_records(path, start_byte, stop_byte, readahead_mb,
                   chunk_bytes=4 << 20, stop_evt=None):
    """Worker-local streaming reader: a thread chunk-reads
    ``[start_byte, stop_byte)`` ahead of the consumer; yields raw
    records, carrying frames across chunk boundaries. (The package-side
    twin is recordio.RecordIOStreamReader; this copy keeps the worker
    importable without the package.)"""
    depth = max(1, (int(readahead_mb) << 20) // chunk_bytes)
    q = queue.Queue(maxsize=depth)

    def reader():
        try:
            with open(path, "rb") as f:
                f.seek(start_byte)
                pos = start_byte
                while pos < stop_byte:
                    if stop_evt is not None and stop_evt.is_set():
                        return
                    chunk = f.read(min(chunk_bytes, stop_byte - pos))
                    if not chunk:
                        break
                    pos += len(chunk)
                    while True:
                        try:
                            q.put(chunk, timeout=0.1)
                            break
                        except queue.Full:
                            if stop_evt is not None and stop_evt.is_set():
                                return
        except Exception as e:  # noqa: BLE001
            q.put(e)
            return
        q.put(None)

    threading.Thread(target=reader, daemon=True).start()
    buf = b""
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, Exception):
            raise item
        buf = buf + item if buf else item
        off = 0
        while len(buf) - off >= 8:
            magic, lrec = struct.unpack_from("<II", buf, off)
            if magic != REC_MAGIC:
                raise IOError("invalid RecordIO magic in stream")
            length = lrec & LFLAG_MASK
            framed = 8 + length + (4 - length % 4) % 4
            if len(buf) - off < framed:
                break
            yield buf[off + 8:off + 8 + length]
            off += framed
        buf = buf[off:]


# ----------------------------------------------------------------- decode

def load_native(lib_path):
    """The libjpeg batch decoder by path (no package import); None when
    the parent passed no path (its host has no libjpeg: PIL decodes).
    A path that does not load raises: the parent built that library, so
    a failure here is a fault to surface, not a reason to decode
    another way."""
    if not lib_path:
        return None
    lib = ctypes.CDLL(lib_path)
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.mxtpu_decode_batch.restype = ctypes.c_int
    lib.mxtpu_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # n, th, tw
        fptr, ctypes.POINTER(ctypes.c_uint8),       # rand_uv, mirror
        fptr, fptr, fptr,                           # mean, std, out
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    return lib


def decode_batch_pil(payloads, th, tw, uv, mirror, mean, std, out):
    """Per-record Python path mirroring the native decoder's semantics
    exactly: decode -> crop(th,tw) -> mirror -> normalize raw 0..255
    pixels with (mean, std). Returns the DEC_* bits of the decoders it
    ran."""
    used = 0
    for i, payload in enumerate(payloads):
        if payload[:6] == b"\x93NUMPY":
            arr = np.load(_io.BytesIO(payload))
            used |= DEC_NPY
        else:
            from PIL import Image
            arr = np.asarray(Image.open(_io.BytesIO(payload))
                             .convert("RGB"))
            used |= DEC_PIL
        if arr.ndim == 3 and arr.shape[0] == 3 and arr.dtype == np.float32:
            img = arr  # CHW float payload (already pixel-valued)
        else:
            if arr.ndim == 2:
                arr = arr[:, :, None].repeat(3, axis=2)
            img = arr.astype(np.float32).transpose(2, 0, 1)
        _, ih, iw = img.shape
        if ih < th or iw < tw:
            raise ValueError(
                f"image {ih}x{iw} smaller than target {th}x{tw}")
        u, v = float(uv[i, 0]), float(uv[i, 1])
        top = (ih - th) // 2 if u < 0 else min(int(u * (ih - th + 1)),
                                               ih - th)
        left = (iw - tw) // 2 if v < 0 else min(int(v * (iw - tw + 1)),
                                                iw - tw)
        img = img[:, top:top + th, left:left + tw]
        if mirror[i]:
            img = img[:, :, ::-1]
        out[i] = (img - mean.reshape(3, 1, 1)) / std.reshape(3, 1, 1)
    return used


class BatchDecoder:
    """Decode a list of payloads into a float32 (n,3,th,tw) view:
    whole-batch native libjpeg pool when every payload is a JPEG, else
    the PIL/npy per-record path."""

    def __init__(self, spec):
        self.th, self.tw = int(spec["th"]), int(spec["tw"])
        self.mean = np.asarray(spec["mean"], np.float32)
        self.std = np.asarray(spec["std"], np.float32)
        self.nthreads = int(spec.get("nthreads", 1))
        self.native = load_native(spec.get("imgdec_lib"))

    def decode(self, payloads, uv, mirror, out):
        """Decode into ``out``; returns the DEC_* bits of the decoders
        that ran."""
        n = len(payloads)
        use_native = self.native is not None and all(
            p[:2] == b"\xff\xd8" for p in payloads)
        if not use_native:
            return decode_batch_pil(payloads, self.th, self.tw, uv, mirror,
                                    self.mean, self.std, out)
        bufs = (ctypes.c_char_p * n)(*payloads)
        lens = (ctypes.c_int64 * n)(*[len(p) for p in payloads])
        errbuf = ctypes.create_string_buffer(512)
        fptr = ctypes.POINTER(ctypes.c_float)
        rc = self.native.mxtpu_decode_batch(
            ctypes.cast(bufs, ctypes.POINTER(ctypes.c_char_p)),
            ctypes.cast(lens, ctypes.POINTER(ctypes.c_int64)),
            n, self.th, self.tw,
            np.ascontiguousarray(uv, np.float32).ctypes.data_as(fptr),
            np.ascontiguousarray(mirror, np.uint8).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            self.mean.ctypes.data_as(fptr),
            self.std.ctypes.data_as(fptr),
            out.ctypes.data_as(fptr),
            self.nthreads, errbuf, len(errbuf))
        if rc != 0:
            raise IOError("native decode failed: %s"
                          % errbuf.value.decode(errors="replace"))
        return DEC_LIBJPEG


# ------------------------------------------------------------ worker main

class _Shard:
    """Record selection for one worker — BATCH-striped: the epoch's
    batch sequence is contiguous slices of the shared permutation, and
    worker ``w`` owns batches ``{w, w+W, w+2W, ...}``. Round-robin
    delivery in the parent therefore reproduces the EXACT batch order
    a single-process iterator would emit (shards stay disjoint, and
    together cover the first ``bw*W*B`` records of the permutation).
    Streaming mode shards by contiguous FILE byte ranges instead
    (chunked sequential reads; shuffle applies within the readahead
    window, and the delivered order is per-shard file order)."""

    def __init__(self, spec, offsets):
        self.offsets = offsets
        self.w = int(spec["worker_id"])
        self.W = int(spec["num_workers"])
        self.B = int(spec["batch_size"])
        self.seed = int(spec["seed"])
        self.shuffle = bool(spec["shuffle"])
        self.streaming = bool(spec.get("streaming"))
        n = len(offsets)
        if self.streaming:
            self.shard = n // self.W            # contiguous records
            self.bw = self.shard // self.B
        else:
            self.bw = (n // self.B) // self.W   # batches per epoch
            self.shard = self.bw * self.B

    def batch_records(self, perm, local_j):
        """Record ids of this worker's local batch ``local_j``: epoch
        batch ``local_j * W + w`` of the shared order."""
        ge = local_j * self.W + self.w
        return perm[ge * self.B:(ge + 1) * self.B]

    def stream_bounds(self, rec_path):
        """[start_byte, stop_byte) covering this worker's contiguous
        record range."""
        lo = self.w * self.shard
        hi = (self.w + 1) * self.shard
        start = self.offsets[lo]
        if hi < len(self.offsets):
            stop = self.offsets[hi]
        else:
            stop = os.path.getsize(rec_path)
        return int(start), int(stop)


def run(spec):
    import signal
    stop_evt = threading.Event()

    def on_term(*_):
        # the parent stops a worker by H_STOP, then SIGTERM: leave at
        # once, even from a sleep or a wait, through the finally below
        stop_evt.set()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, on_term)

    offsets = np.load(spec["offsets_path"])
    shard = _Shard(spec, offsets)
    B, bw = shard.B, shard.bw
    th, tw = int(spec["th"]), int(spec["tw"])
    label_width = int(spec["label_width"])
    nslots = int(spec["ring_batches"])
    rand_crop = bool(spec["rand_crop"])
    rand_mirror = bool(spec["rand_mirror"])
    parent_pid = int(spec["parent_pid"])
    layout = ring_layout(nslots, B, th, tw, label_width)

    shm_file = os.path.join("/dev/shm", spec["shm_name"])
    fd = os.open(shm_file, os.O_RDWR)
    try:
        mm = mmap.mmap(fd, layout["total"])
    finally:
        os.close(fd)
    views = map_views(mm, layout)
    header, meta = views["header"], views["meta"]
    decoder = BatchDecoder(spec)
    rec_file = open(spec["rec_path"], "rb")

    def alive():
        if stop_evt.is_set() or header[H_STOP]:
            return False
        try:
            os.kill(parent_pid, 0)   # parent gone -> no zombies
        except OSError:
            return False
        return True

    def wait_empty(slot):
        while alive():
            if meta[slot, M_STATE] == EMPTY:
                return True
            header[H_HEARTBEAT] = time.monotonic_ns()
            time.sleep(0.0005)
        return False

    def stream_epoch(epoch, skip_batches):
        """Streaming-mode batch source for one epoch: sequential
        chunked reads over this worker's byte range, with shuffle
        applied inside a readahead window of records (the classic
        streaming-shuffle tradeoff — global order needs random access).
        Every draw derives from ``batch_rng(seed, w, g)``, so resuming
        at batch ``skip_batches`` replays the prefix WITHOUT decoding
        (frame reads only) and lands on identical batches."""
        evt = threading.Event()
        lo, hi = shard.stream_bounds(spec["rec_path"])
        stream = stream_records(
            spec["rec_path"], lo, hi,
            float(spec.get("readahead_mb", 64)), stop_evt=evt)
        window = B * 8 if shard.shuffle else B
        buf = []

        def next_batch(g):
            while len(buf) < window:
                try:
                    buf.append(next(stream))
                except StopIteration:
                    break
            if shard.shuffle:
                rng = batch_rng(shard.seed, shard.w, g)
                take = np.sort(rng.choice(len(buf), B,
                                          replace=False))[::-1]
                return [buf.pop(int(i)) for i in take]
            batch, buf[:B] = buf[:B], []
            return batch

        for gg in range(epoch * bw, epoch * bw + skip_batches):
            next_batch(gg)
        return evt, next_batch

    g = int(spec["start_batch"])
    epoch = -1
    perm = None
    stream_next = None
    stream_evt = threading.Event()
    try:
        while alive():
            e, j = g // bw, g % bw
            if e != epoch:
                epoch = e
                if shard.streaming:
                    stream_evt.set()
                    stream_evt, stream_next = stream_epoch(e, j)
                else:
                    perm = epoch_permutation(shard.seed, e,
                                             len(offsets), shard.shuffle)
            if shard.streaming:
                raws = stream_next(g)
            else:
                raws = [read_record_at(rec_file, offsets[i])
                        for i in shard.batch_records(perm, j)]
            payloads, labels = [], []
            for raw in raws:
                payload, lab = unpack_record(raw, label_width)
                payloads.append(payload)
                labels.append(lab)
            rng = batch_rng(shard.seed, shard.w, g)
            uv = (rng.rand(B, 2).astype(np.float32) if rand_crop
                  else np.full((B, 2), -1.0, np.float32))
            mirror = ((rng.rand(B) < 0.5) if rand_mirror
                      else np.zeros(B)).astype(np.uint8)
            slot = g % nslots
            if not wait_empty(slot):
                break
            try:
                header[H_DECODERS] |= decoder.decode(
                    payloads, uv, mirror, views["data"][slot])
                views["label"][slot][:] = np.stack(labels)
            except Exception as exc:  # noqa: BLE001 — ship to parent
                msg = ("worker %d batch %d: %s"
                       % (shard.w, g, exc)).encode()[:1024]
                flat = views["data"][slot].reshape(-1)
                flat.view(np.uint8)[:len(msg)] = np.frombuffer(
                    msg, np.uint8)
                meta[slot, M_GIDX] = g
                meta[slot, M_ERRLEN] = len(msg)
                meta[slot, M_STATE] = ERROR
                return 1
            meta[slot, M_GIDX] = g
            meta[slot, M_NSAMPLES] = B
            meta[slot, M_ERRLEN] = 0
            meta[slot, M_STATE] = READY
            header[H_PRODUCED] += 1
            header[H_HEARTBEAT] = time.monotonic_ns()
            g += 1
    finally:
        # leaving: a SIGTERM from here on must not raise inside the
        # cleanup or the interpreter's shutdown
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        stream_evt.set()
        rec_file.close()
        try:
            os.kill(parent_pid, 0)
        except OSError:
            # orphaned (parent SIGKILLed before its teardown ran): the
            # parent can no longer unlink the ring — reap our own
            # segment so /dev/shm never accumulates dead rings
            try:
                os.unlink(shm_file)
            except OSError:
                pass
        try:
            mm.close()
        except BufferError:
            pass  # closure-held views pin the map; process exit frees it
    return 0


def main(argv):
    with open(argv[1]) as f:
        spec = json.load(f)
    return run(spec)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
