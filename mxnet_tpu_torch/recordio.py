"""RecordIO file format (the port of ``mxnet_tpu/recordio.py``; ref:
python/mxnet/recordio.py + dmlc-core recordio + src/io/image_recordio.h).

Byte-compatible with the reference's format, and so with the JAX
package's files both ways: records framed by kMagic (0xced7230a) + length
word (upper 3 bits = continuation flag), payloads padded to 4 bytes;
IRHeader packs (flag, label, id, id2) ahead of image payloads; .idx files
map integer keys to byte offsets for random access. Payloads encode and
decode through cv2 when it is installed, else PIL, else raw ``.npy``.
This module is host-side numpy: records never touch a device.
"""
from __future__ import annotations

import io
import os
import queue
import struct
import threading
from collections import namedtuple

import numpy as np

from .base import MXNetError, get_env

_MAGIC = 0xCED7230A
_LFLAG_BITS = 29
_LFLAG_MASK = (1 << _LFLAG_BITS) - 1

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential reader/writer (ref: recordio.py MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.fid = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.fid = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fid = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag!r}")
        self.pid = os.getpid()

    def close(self):
        if self.fid is not None and not self.fid.closed:
            self.fid.close()

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["fid"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fid.tell()

    def write(self, buf):
        assert self.writable
        length = len(buf)
        upper = 0  # single-record framing (no continuation chunks needed)
        self.fid.write(struct.pack("<II", _MAGIC,
                                   (upper << _LFLAG_BITS) | length))
        self.fid.write(buf)
        pad = (4 - length % 4) % 4
        if pad:
            self.fid.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        hdr = self.fid.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _MAGIC:
            raise MXNetError("invalid RecordIO magic")
        length = lrec & _LFLAG_MASK
        buf = self.fid.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fid.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer with .idx sidecar
    (ref: recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def close(self):
        if self.writable and self.fid is not None and not self.fid.closed:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.fid.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


def pack(header, s):
    """Pack IRHeader + payload (ref: recordio.py pack). Scalar labels go in
    the header (flag=0); vector labels set flag=len and follow the header."""
    header = IRHeader(*header)
    label = header.label
    if np.isscalar(label):
        return struct.pack(_IR_FORMAT, int(header.flag), float(label),
                           header.id, header.id2) + s
    label = np.asarray(label, np.float32).ravel()
    hdr = struct.pack(_IR_FORMAT, len(label), 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """Unpack a record into (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode image + pack (cv2, then PIL, then raw npy; decoded arrays
    are RGB HWC in the PIL path)."""
    try:
        import cv2
        ret, buf = cv2.imencode(img_fmt, img,
                                [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ret
        return pack(header, buf.tobytes())
    except ImportError:
        pass
    try:
        from PIL import Image
        bio = io.BytesIO()
        fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}.get(
            img_fmt.lstrip("."), "JPEG")
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(bio, fmt, quality=quality)
        return pack(header, bio.getvalue())
    except ImportError:
        bio = io.BytesIO()
        np.save(bio, np.asarray(img))
        return pack(header, bio.getvalue())


def cv2_present():
    """Whether unpack_img/decode_payload would decode through cv2
    (which yields BGR) — the one place callers consult to decide
    channel normalization."""
    import importlib.util
    return importlib.util.find_spec("cv2") is not None


def decode_payload(payload, iscolor=-1):
    """Decode one record payload to an array: raw .npy passthrough,
    else cv2 (BGR, the reference's convention) or PIL (RGB)."""
    if payload[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(payload))
    try:
        import cv2
        return cv2.imdecode(np.frombuffer(payload, np.uint8), iscolor)
    except ImportError:
        try:
            from PIL import Image
            return np.asarray(Image.open(io.BytesIO(payload))
                              .convert("RGB"))
        except ImportError:
            raise MXNetError(
                "cannot decode image without cv2 or PIL; pack with "
                "raw npy payloads in this environment")


def unpack_img(s, iscolor=-1):
    header, payload = unpack(s)
    return header, decode_payload(payload, iscolor)


def load_record_offsets(path):
    """Byte offsets of every record in a .rec file: from the ``.idx``
    sidecar when present, else one framing scan (seeks only — payloads
    are never retained). The shared index the random-access iterators
    and the sharded pipeline both build on."""
    idx_path = os.path.splitext(path)[0] + ".idx"
    if os.path.isfile(idx_path):
        offs = []
        with open(idx_path) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) >= 2:
                    offs.append(int(parts[1]))
        if offs:
            return offs
    offs = []
    with open(path, "rb") as f:
        f.seek(0, 2)
        end = f.tell()
        pos = 0
        while pos + 8 <= end:
            f.seek(pos)
            magic, lrec = struct.unpack("<II", f.read(8))
            if magic != _MAGIC:
                raise MXNetError(f"invalid RecordIO magic at {pos}")
            offs.append(pos)
            length = lrec & _LFLAG_MASK
            pos += 8 + length + (4 - length % 4) % 4
    return offs


class RecordIOStreamReader:
    """Streaming shard reader: a background thread reads ahead
    ``readahead_mb`` of raw bytes in large chunks while the caller
    consumes parsed records — so epoch-scale datasets stream from
    disk/remote mounts without local materialization, and read I/O
    overlaps decode (the io pipeline's decode workers sit downstream).

    Records are framed on the wire (kMagic + length word), so a record
    may straddle a chunk boundary; the parser carries the partial tail
    into the next chunk. Iterating yields ``(byte_offset, record)``
    pairs for the byte range ``[start, stop)`` of ``uri`` (``stop=None``
    = end of file). ``start`` must sit on a record boundary.
    """

    #: one read() granularity; readahead_mb bounds how many of these
    #: may sit parsed-ahead in the queue
    CHUNK_BYTES = 4 << 20

    def __init__(self, uri, start=0, stop=None, readahead_mb=None,
                 chunk_bytes=None):
        if readahead_mb is None:
            readahead_mb = get_env("MXTPU_IO_READAHEAD_MB", 64, int)
        self._chunk = int(chunk_bytes or self.CHUNK_BYTES)
        depth = max(1, (int(readahead_mb) << 20) // self._chunk)
        self._uri = uri
        self._start = int(start)
        self._stop = stop
        self._queue = queue.Queue(maxsize=depth)
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._read_loop,
                                        daemon=True)
        self._thread.start()

    def _read_loop(self):
        try:
            with open(self._uri, "rb") as f:
                if self._stop is None:
                    f.seek(0, 2)
                    stop = f.tell()
                else:
                    stop = int(self._stop)
                f.seek(self._start)
                pos = self._start
                while pos < stop and not self._stop_evt.is_set():
                    chunk = f.read(min(self._chunk, stop - pos))
                    if not chunk:
                        break
                    pos += len(chunk)
                    self._put(chunk)
        except Exception as e:  # noqa: BLE001 — surface at the consumer
            self._put(e)
            return
        self._put(None)

    def _put(self, item):
        while not self._stop_evt.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        buf = b""
        pos = self._start
        while True:
            item = self._queue.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            buf = buf + item if buf else item
            # drain complete frames by cursor (no per-record buffer
            # reslicing); a partial frame tail carries into the next
            # chunk (chunk-boundary records)
            off = 0
            while len(buf) - off >= 8:
                magic, lrec = struct.unpack_from("<II", buf, off)
                if magic != _MAGIC:
                    raise MXNetError(
                        f"invalid RecordIO magic at {pos}")
                length = lrec & _LFLAG_MASK
                framed = 8 + length + (4 - length % 4) % 4
                if len(buf) - off < framed:
                    break
                yield pos, buf[off + 8:off + 8 + length]
                off += framed
                pos += framed
            buf = buf[off:]
        if buf:
            raise MXNetError(
                f"truncated record at byte {pos} (stream ended inside "
                "a frame)")

    def close(self):
        self._stop_evt.set()
        # unblock a producer stuck on put()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
