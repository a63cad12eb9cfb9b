"""Hang flight recorder: the last-N and in-flight span view, dumped with
thread stacks when the process wedges (the port of
``mxnet_tpu/tracing/flight.py``).

- :func:`dump` — JSON of every thread's open (unclosed) spans, its
  recent closed spans and the formatted Python stacks of all threads;
  written atomically to a file, or to stderr.
- :func:`install` — arms the exits: ``faulthandler.enable()`` for C-level
  crashes, a SIGTERM handler and a ``sys.excepthook`` that write the dump
  first and then chain to the handler they replaced (a kvstore server's
  snapshot handler, or the JAX package's recorder where both packages
  are loaded in one process). Not installed at import: signal handlers
  are process policy, so the entry points that own the process opt in.
  :func:`uninstall` puts back what :func:`install` replaced, where this
  module's handler is still the one installed.
- :class:`Watchdog` / :func:`arm` — a daemon thread that dumps when no
  span opens or closes for ``MXTPU_HANG_TIMEOUT_SEC`` seconds (a healthy
  training loop closes spans constantly; a wedged one goes silent). One
  dump a stall: it re-arms when activity resumes.

The dump is bounded (``max_spans`` a thread) so it can be embedded in a
failure artifact.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback

from ..base import get_env
from . import clock


def default_dump_path():
    """MXTPU_FLIGHT_PATH, else None (dump to stderr)."""
    return os.environ.get("MXTPU_FLIGHT_PATH") or None


def hang_timeout_sec():
    return get_env("MXTPU_HANG_TIMEOUT_SEC", 0.0, float)


def _attrs_view(attrs):
    """Bounded copy of a span attrs dict. Open spans belong to LIVE
    threads that may resize the dict mid-iteration — retry, then give
    up rather than raise out of a dump."""
    for _ in range(3):
        try:
            return {k: str(v)[:80] for k, v in list(attrs.items())}
        except RuntimeError:       # dict changed size during iteration
            continue
    return {"_torn": "attrs mutating during dump"}


def _fmt_span(s, now_ns):
    """Bounded view of one span dict / open Span object."""
    if isinstance(s, dict):
        return {"name": s["name"], "cat": s.get("cat"),
                "trace": "%016x" % (s.get("trace") or 0),
                "span": "%016x" % (s.get("span") or 0),
                "dur_ms": round(s["dur_ns"] / 1e6, 3),
                "attrs": _attrs_view(s.get("attrs") or {})}
    return {"name": s.name, "cat": s.cat,
            "trace": "%016x" % s.trace_id, "span": "%016x" % s.span_id,
            "open_ms": round((now_ns - s.start_ns) / 1e6, 3),
            "attrs": _attrs_view(s.attrs)}


def snapshot(max_spans=10):
    """Bounded dict of the rings: per thread, the in-flight (unclosed)
    span stack outermost-first and the most recent closed spans."""
    from . import rings, last_activity_ns
    now = clock.now_ns()
    threads = []
    for name, ident, closed, open_spans in rings():
        if not closed and not open_spans:
            continue
        threads.append({
            "thread": name, "tid": ident,
            "in_flight": [_fmt_span(s, now) for s in open_spans],
            "recent": [_fmt_span(s, now) for s in closed[-max_spans:]],
        })
    return {
        "ts": time.time(),
        "monotonic_ns": now,
        "idle_ms": round((now - last_activity_ns()) / 1e6, 1),
        "pid": os.getpid(),
        "role": os.environ.get("DMLC_ROLE"),
        "threads": threads,
    }


def thread_stacks(limit=40):
    """{thread_name_or_id: formatted stack} for every live thread —
    the pure-Python half of faulthandler (string-valued, embeddable)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = "%s (%d)" % (names.get(ident, "?"), ident)
        out[label] = "".join(traceback.format_stack(frame, limit=limit))
    return out


def dump(reason, path=None, max_spans=10, file=None):
    """Assemble and emit one flight-recorder dump. Returns the dict.

    ``path`` (or MXTPU_FLIGHT_PATH) writes atomically; otherwise the
    dump goes to ``file`` (default stderr) as indented JSON between
    marker lines so log scrapers can cut it out."""
    doc = snapshot(max_spans=max_spans)
    doc["reason"] = str(reason)[:300]
    doc["stacks"] = thread_stacks()
    path = path or default_dump_path()
    text = json.dumps(doc, indent=1, sort_keys=True)
    if path:
        try:
            tmp = "%s.tmp.%d" % (path, os.getpid())
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(text)
            os.replace(tmp, path)
            return doc
        except OSError:
            pass               # fall through to stderr: never lose it
    f = file or sys.stderr
    print("=== MXTPU FLIGHT RECORDER (%s) ===" % doc["reason"], file=f)
    print(text, file=f)
    print("=== END FLIGHT RECORDER ===", file=f, flush=True)
    return doc


# -- exit hooks --------------------------------------------------------------
_installed = [False]
_prev_sigterm = [None]
_prev_excepthook = [None]
# which of this module's handlers sit in their chain now
_chained = {"sigterm": False, "excepthook": False}


def _on_sigterm(signum, frame):
    try:
        dump("SIGTERM")
    except Exception:  # noqa: BLE001 — the dump must never mask the exit
        pass
    prev = _prev_sigterm[0]
    if callable(prev):
        prev(signum, frame)    # e.g. the kvstore server's snapshot
    elif prev == signal.SIG_DFL:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _on_excepthook(exc_type, exc, tb):
    try:
        if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
            dump("unhandled %s: %s" % (exc_type.__name__,
                                       str(exc)[:200]))
    except Exception:  # noqa: BLE001
        pass
    (_prev_excepthook[0] or sys.__excepthook__)(exc_type, exc, tb)


def install(signals=True, excepthook=True, watchdog=None):
    """Arm the flight recorder's exits (idempotent). ``watchdog``:
    None honors MXTPU_HANG_TIMEOUT_SEC (> 0 arms), a number arms with
    that timeout, False skips. Call from process entry points that own
    signal policy."""
    if not _installed[0]:
        _installed[0] = True
        import faulthandler
        if not faulthandler.is_enabled():
            try:
                faulthandler.enable()   # SIGSEGV/SIGABRT/SIGBUS stacks
            except (RuntimeError, OSError, ValueError):
                pass                    # no usable stderr fd
        if signals:
            try:
                _prev_sigterm[0] = signal.getsignal(signal.SIGTERM)
                signal.signal(signal.SIGTERM, _on_sigterm)
                _chained["sigterm"] = True
            except (ValueError, OSError):   # not the main thread
                pass
        if excepthook:
            _prev_excepthook[0] = sys.excepthook
            sys.excepthook = _on_excepthook
            _chained["excepthook"] = True
    if watchdog is None:
        t = hang_timeout_sec()
        if t > 0:
            arm(t)
    elif watchdog:
        arm(float(watchdog))


def uninstall():
    """Undo :func:`install`: put back the SIGTERM handler and excepthook
    it replaced where this module's are still the installed ones. A
    handler installed after ours keeps its place, and ours stays in its
    chain (so its exit still reaches the handler ours replaced): then
    the recorder stays installed."""
    if not _installed[0]:
        return
    if _chained["sigterm"]:
        try:
            if signal.getsignal(signal.SIGTERM) is _on_sigterm:
                prev = _prev_sigterm[0]
                signal.signal(signal.SIGTERM,
                              prev if prev is not None else signal.SIG_DFL)
                _chained["sigterm"] = False
                _prev_sigterm[0] = None
        except (ValueError, OSError):   # not the main thread
            pass
    if _chained["excepthook"] and sys.excepthook is _on_excepthook:
        sys.excepthook = _prev_excepthook[0] or sys.__excepthook__
        _chained["excepthook"] = False
        _prev_excepthook[0] = None
    _installed[0] = any(_chained.values())


# -- watchdog ----------------------------------------------------------------
class Watchdog(threading.Thread):
    """Daemon thread firing one dump per stall: no span open/close (and
    no :func:`heartbeat`) for ``timeout`` seconds."""

    def __init__(self, timeout, path=None, on_fire=None):
        super().__init__(name="mxtpu-hang-watchdog", daemon=True)
        self.timeout = float(timeout)
        self.path = path
        self.on_fire = on_fire
        self.fired = 0
        self._stop = threading.Event()

    def run(self):
        from . import last_activity_ns
        fired_at = None            # activity watermark of the last dump
        poll = min(max(self.timeout / 4.0, 0.05), 1.0)
        while not self._stop.wait(poll):
            last = last_activity_ns()
            idle = (clock.now_ns() - last) / 1e9
            if idle < self.timeout:
                continue
            if fired_at == last:
                continue           # same stall, already dumped
            fired_at = last
            self.fired += 1
            try:
                doc = dump("hang: no span activity for %.1fs "
                           "(MXTPU_HANG_TIMEOUT_SEC=%g)"
                           % (idle, self.timeout), path=self.path)
            except Exception:  # noqa: BLE001 — a racing/failing dump
                continue       # must never kill the watchdog thread
            if self.on_fire is not None:
                try:
                    self.on_fire(doc)
                except Exception:  # noqa: BLE001 — observer only
                    pass

    def stop(self):
        self._stop.set()


_watchdog = [None]


def heartbeat():
    """Mark forward progress without opening a span (long stretches of
    work that open none)."""
    from . import _touch
    _touch()


def arm(timeout=None, path=None, on_fire=None):
    """Start (or restart) the process hang watchdog. ``timeout``
    defaults to MXTPU_HANG_TIMEOUT_SEC; <= 0 only disarms. Refuses
    (with a warning) when tracing is disabled — no span ever touches
    the activity clock then, so the watchdog would cry hang on every
    healthy stretch longer than the timeout."""
    disarm()
    if timeout is None:
        timeout = hang_timeout_sec()
    if timeout <= 0:
        return None
    from . import enabled
    if not enabled():
        print("mxtpu: hang watchdog NOT armed: tracing is disabled "
              "(MXTPU_TRACE_SAMPLE=0), so no span activity would ever "
              "reset it", file=sys.stderr)
        return None
    heartbeat()                   # arming is progress: time from NOW
    w = Watchdog(timeout, path=path, on_fire=on_fire)
    w.start()
    _watchdog[0] = w
    return w


def disarm():
    w, _watchdog[0] = _watchdog[0], None
    if w is not None:
        w.stop()
    return w
