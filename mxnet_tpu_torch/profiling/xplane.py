"""The measured side: per-op time from a capture (the port of
``mxnet_tpu/profiling/xplane.py``, keeping its names).

:func:`load_xspace` reads the port's capture format, the Kineto chrome
trace ``torch.profiler`` exports (``*.pt.trace.json``), into the same
plane / line / event structure the JAX reader gives, so
:func:`measure_ops` (self time, interval unions) is the JAX package's.
A JAX ``.xplane.pb`` still loads, through this module's own copy of the
stdlib protobuf reader (:func:`parse_xspace`).

From a Kineto trace:

- **On a card** the device plane (``/device:GPU:<n>``, a line a stream)
  holds the kernel, memcpy and memset events; their union is the
  device window. A kernel is named by where it was launched: the
  runtime launch event that carries its correlation id, on the
  launching thread (a ``ctypes`` launch too), lies inside the op scope
  ranges of :mod:`.optrace` (``mx.<op>#<k>`` and a hand kernel's
  ``mx:<kernel>``); the innermost scope, with the hand kernel's region
  inside it, is its name (``<op>#<k>/<kernel>``). Launched outside any
  scope, it takes the aten op that launched it (the innermost CPU op
  around the launch), else its own kernel name.
- **On the CPU** the device plane (``/device:CPU:0``, a line a thread)
  holds the CPU op events of the threads that ran the step, named the
  same way; their union is the window.
"""
from __future__ import annotations

import bisect
import glob
import json
import os

def _varint(buf, i):
    r = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _fields(buf):
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        else:
            raise ValueError("unsupported protobuf wire type %d" % wt)
        yield fn, wt, v


def _parse_event_metadata(buf):
    key = None
    name = None
    for fn, wt, v in _fields(buf):
        if fn == 1 and wt == 0:
            key = v
        elif fn == 2 and wt == 2:
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0 and key is None:
                    key = v2
                elif f2 == 2 and w2 == 2:
                    name = v2.decode("utf-8", "replace")
    return key, name


def _parse_line(buf):
    line = {"name": None, "timestamp_ns": 0, "events": []}
    for fn, wt, v in _fields(buf):
        if fn == 2 and wt == 2 and line["name"] is None:
            line["name"] = v.decode("utf-8", "replace")
        elif fn == 11 and wt == 2:
            line["name"] = v.decode("utf-8", "replace")
        elif fn == 3 and wt == 0:
            line["timestamp_ns"] = v
        elif fn == 4 and wt == 2:
            mid = None
            off_ps = 0
            dur_ps = 0
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0:
                    mid = v2
                elif f2 == 2 and w2 == 0:
                    off_ps = v2
                elif f2 == 3 and w2 == 0:
                    dur_ps = v2
            line["events"].append((mid, off_ps, dur_ps))
    return line


def parse_xspace(data):
    """bytes -> [{"name", "event_metadata": {id: name},
    "lines": [{"name", "timestamp_ns", "events": [(mid, off_ps,
    dur_ps)]}]}]."""
    planes = []
    for fn, wt, v in _fields(data):
        if fn != 1 or wt != 2:
            continue
        plane = {"name": None, "event_metadata": {}, "lines": []}
        for f2, w2, v2 in _fields(v):
            if f2 == 2 and w2 == 2:
                plane["name"] = v2.decode("utf-8", "replace")
            elif f2 == 4 and w2 == 2:
                key, name = _parse_event_metadata(v2)
                if key is not None:
                    plane["event_metadata"][key] = name
            elif f2 == 3 and w2 == 2:
                plane["lines"].append(_parse_line(v2))
        planes.append(plane)
    return planes


def find_xplane_files(profile_dir):
    """The capture files under ``profile_dir``, newest first: Kineto
    traces (``*.pt.trace.json``) and JAX ``*.xplane.pb`` artifacts
    (``<dir>/plugins/profile/<run>/<host>.xplane.pb``)."""
    pats = (os.path.join(profile_dir, "*.pt.trace.json"),
            os.path.join(profile_dir, "plugins", "profile", "*",
                         "*.xplane.pb"),
            os.path.join(profile_dir, "*.xplane.pb"))
    found = []
    for p in pats:
        found.extend(glob.glob(p))
    return sorted(found, key=lambda p: os.path.getmtime(p),
                  reverse=True)


def load_xspace(profile_dir_or_file):
    """Planes of a capture directory's newest file, or of one file."""
    path = profile_dir_or_file
    if os.path.isdir(path):
        files = find_xplane_files(path)
        if not files:
            raise FileNotFoundError(
                "no capture (*.pt.trace.json or .xplane.pb) under %s "
                "(did the capture succeed?)" % path)
        path = files[0]
    if path.endswith(".json"):
        with open(path, "r", encoding="utf-8") as f:
            return parse_kineto(json.load(f))
    with open(path, "rb") as f:
        return parse_xspace(f.read())


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _ns(ts):
    return int(round(float(ts) * 1000))


class _Enclosing:
    """Innermost enclosing ranges on one thread (scope annotations, CPU
    ops: ranges that nest), looked up by an interval."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < e:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, s, e):
        """Ranges enclosing [s, e], innermost first."""
        out = []
        i = bisect.bisect_right(self.starts, s) - 1
        while i >= 0:
            r = self.ranges[i]
            if r[1] >= e:
                out.append(r)
            i = self.parent[i]
        return out


def scope_name(chain):
    """The event name the scope chain gives (innermost first), or None:
    ``<scope>/<kernel>``, ``<scope>``, ``<kernel>``."""
    scope = kernel = None
    for _, _, name in chain:
        if name.startswith("mx.") and scope is None:
            scope = name[3:]
            break
        if name.startswith("mx:") and kernel is None:
            kernel = name[3:]
    if scope and kernel:
        return "%s/%s" % (scope, kernel)
    return scope or kernel


def _aten(name):
    return name[6:] if name.startswith("aten::") else name


def parse_kineto(doc):
    """Kineto chrome-trace document -> planes (see the module
    docstring)."""
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    annots, cpu_ops, launches, device = {}, {}, {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = _ns(ev.get("ts", 0))
        e = s + _ns(ev.get("dur", 0))
        thread = (ev.get("pid"), ev.get("tid"))
        name = ev.get("name", "")
        args = ev.get("args") or {}
        if cat == "user_annotation" and name.startswith(("mx.", "mx:")):
            annots.setdefault(thread, []).append((s, e, name))
        elif cat == "cpu_op":
            cpu_ops.setdefault(thread, []).append((s, e, name))
        elif cat in _LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (thread, s, e)
        elif cat in _DEVICE_CATS:
            device.append((args.get("device", ev.get("pid")),
                           args.get("stream", ev.get("tid")), s, e, name,
                           args.get("correlation")))
    scopes = {t: _Enclosing(r) for t, r in annots.items()}
    ops = {t: _Enclosing(r) for t, r in cpu_ops.items()}

    def name_at(thread, s, e, own):
        sc = scopes.get(thread)
        got = scope_name(sc.chain(s, e)) if sc is not None else None
        if got:
            return got
        if own is not None:
            return _aten(own)
        oc = ops.get(thread)
        inner = oc.chain(s, e) if oc is not None else []
        return _aten(inner[0][2]) if inner else None

    planes = []
    if device:
        by_dev, raw = {}, {}
        for dev, stream, s, e, name, corr in device:
            la = launches.get(corr)
            label = name_at(la[0], la[1], la[2], None) if la else None
            by_dev.setdefault(dev, {}).setdefault(stream, []).append(
                (s, e, label or name))
            counts = raw.setdefault(dev, {})
            counts[name] = counts.get(name, 0) + 1
        for dev in sorted(by_dev, key=str):
            plane = _plane("/device:GPU:%s" % dev, {
                "stream %s" % st: evs
                for st, evs in sorted(by_dev[dev].items(), key=str)})
            # the device's own event names, counted (what ran, whatever
            # scope it ran in)
            plane["device_event_counts"] = raw[dev]
            planes.append(plane)
    else:
        lines = {}
        for thread, evs in cpu_ops.items():
            lines["thread %s" % (thread[1],)] = [
                (s, e, name_at(thread, s, e, name)) for s, e, name in evs]
        planes.append(_plane("/device:CPU:0", lines))
    return planes


def _plane(name, lines):
    """A plane in the JAX reader's structure from {line: [(s_ns, e_ns,
    name)]}."""
    metas = {}
    ids = {}
    out = {"name": name, "event_metadata": metas, "lines": []}
    for lname, evs in lines.items():
        line = {"name": lname, "timestamp_ns": 0, "events": []}
        for s, e, ename in evs:
            mid = ids.get(ename)
            if mid is None:
                mid = ids[ename] = len(ids) + 1
                metas[mid] = ename
            line["events"].append((mid, s * 1000, (e - s) * 1000))
        out["lines"].append(line)
    return out


def normalize_event_name(name):
    """Thunk-split suffixes back to the HLO instruction name."""
    if not name:
        return name
    for suffix in (".clone", ".remat", ".remat2"):
        while name.endswith(suffix):
            name = name[:-len(suffix)]
    return name


def _union_ps(intervals):
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _is_device_line(plane_name, line_name):
    """Lines carrying XLA execution: on TPU the ``/device:TPU:N``
    planes ("XLA Ops"/"Steps"); on CPU the ``tf_XLA*`` thunk-executor
    lines of ``/host:CPU`` (both the per-thunk Eigen lines and the
    client line whose 'wait for completion' event covers the
    pool-offloaded work that carries no per-op name)."""
    if (plane_name or "").startswith("/device:"):
        return True
    return (line_name or "").startswith("tf_XLA")


def measure_ops(planes, instr_names):
    """Join captured events against HLO instruction names.

    Per-op attribution uses SELF time: a ``call.N`` thunk event wraps
    the fused computation's own event on the same line, and a
    ``while`` body re-emits its inner thunks every trip — nested
    matched intervals are subtracted from their enclosing event so one
    nanosecond of device time lands on exactly one row.

    The reconciliation quantity is ``window_s``: the interval union of
    every event on device/executor lines (timestamp-rebased so lines
    share one axis). On TPU those events are all named per-op; on the
    CPU backend Eigen offloads convolutions to pool threads that emit
    no per-op traceme, so ``window_s > covered_s`` and the difference
    is reported as unattributed executor time rather than silently
    dropped.

    Returns ``{"ops": {instr_name: {"count", "total_s", "self_s"}},
    "covered_s", "window_s", "matched_events"}`` (times in seconds,
    per capture — divide by step count for per-step numbers).
    """
    names = set(instr_names)
    ops = {}
    covered = []
    window = []
    matched_events = 0
    for plane in planes:
        metas = plane["event_metadata"]
        for line in plane["lines"]:
            base_ps = line["timestamp_ns"] * 1000
            device_line = _is_device_line(plane["name"], line["name"])
            evs = []
            for mid, off_ps, dur_ps in line["events"]:
                s, e = base_ps + off_ps, base_ps + off_ps + dur_ps
                if device_line:
                    window.append((s, e))
                name = normalize_event_name(metas.get(mid))
                if name in names:
                    evs.append((s, e, name))
            if not evs:
                continue
            matched_events += len(evs)
            covered.extend((s, e) for s, e, _ in evs)
            evs.sort(key=lambda t: (t[0], -t[1]))
            # nesting sweep: [start, end, name, child_ps]
            stack = []

            def close(frame):
                s, e, name, child = frame
                rec = ops.setdefault(
                    name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
                rec["count"] += 1
                rec["total_s"] += (e - s) / 1e12
                rec["self_s"] += max(e - s - child, 0) / 1e12
                if stack:
                    stack[-1][3] += e - s

            for s, e, name in evs:
                while stack and s >= stack[-1][1]:
                    close(stack.pop())
                stack.append([s, e, name, 0])
            while stack:
                close(stack.pop())
    return {
        "ops": ops,
        "covered_s": _union_ps(covered) / 1e12,
        "window_s": _union_ps(window) / 1e12,
        "matched_events": matched_events,
    }
