"""Bounded in-process time series over the metric registry (the port of
``mxnet_tpu/telemetry/timeline.py``).

The registry is snapshot-only; consumers that want windowed statistics
(a p99 between ticks, an SLO burn rate, a rate) read them here:

- :class:`Timeline` — a ring of at most ``MXTPU_TIMELINE_WINDOW``
  snapshot frames, advanced by :meth:`Timeline.tick` (explicitly, or
  periodically through :func:`start_ticker` / ``MXTPU_TIMELINE_SEC``);
- windowed queries over the ring: :meth:`Timeline.rate` (counter delta /
  elapsed), :meth:`Timeline.quantile` (histogram bucket deltas),
  :meth:`Timeline.mean` (gauge average), each reading recorded frames
  only, never the card;
- :func:`delta_quantile` — the bucket-delta quantile math over
  ``HistogramSeries.stats()``-shaped tuples;
- a versioned ``timeline/v1`` JSON document (:meth:`Timeline.to_doc` /
  :func:`dump`) and counter tracks in the chrome-trace merge
  (``telemetry.export.merge_chrome_trace(timeline=...)``).

Frames hold plain snapshot dicts, so :meth:`MetricRegistry.reset` (which
zeroes series in place) never invalidates a recorded frame: history
survives a reset; only later deltas restart from zero.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..base import get_env
from . import metrics as _metrics

TIMELINE_VERSION = 1
TIMELINE_KIND = "timeline/v1"
DEFAULT_WINDOW = 128


# ----------------------------------------------------------------------
# the shared bucket-delta math
# ----------------------------------------------------------------------
def delta_quantile(prev_stats, cur_stats, q=0.99):
    """Quantile estimate over the observations BETWEEN two cumulative
    histogram reads (``HistogramSeries.stats()`` tuples — ``(count,
    sum, [(le, cumulative), ..., ("+Inf", count)])``). Both bucket
    lists are CUMULATIVE, so the window's cumulative count at each
    edge is simply ``cur_cum - prev_cum`` — summing those deltas
    again would double-count every bucket below the edge and pull the
    estimate toward zero. Linear interpolation inside the winning bucket; the
    +Inf bucket reports the last finite edge (a ceiling estimate).
    None when the window saw no observations."""
    if prev_stats is None or cur_stats is None:
        return None
    (c0, _, b0), (c1, _, b1) = prev_stats, cur_stats
    n = c1 - c0
    if n <= 0 or len(b0) != len(b1):
        return None
    target = q * n
    prev_le = 0.0
    prev_win = 0.0
    for i, ((le, cur_cum), (_, old_cum)) in enumerate(zip(b1, b0)):
        win_cum = cur_cum - old_cum   # window obs <= this edge
        if le == "+Inf":
            # beyond every finite edge: report the last finite edge
            return float(b1[i - 1][0]) if i else None
        le = float(le)
        if win_cum >= target:
            density = win_cum - prev_win
            frac = (target - prev_win) / density if density > 0 \
                else 1.0
            return prev_le + frac * (le - prev_le)
        prev_le, prev_win = le, win_cum
    return prev_le if prev_win > 0 else None


def delta_over(prev_stats, cur_stats, threshold):
    """Fraction of the window's observations ABOVE ``threshold``
    (bucket-delta CDF complement, interpolated inside the straddling
    bucket) — the error fraction an SLO burn rate is built from.
    None when the window saw no observations."""
    if prev_stats is None or cur_stats is None:
        return None
    (c0, _, b0), (c1, _, b1) = prev_stats, cur_stats
    n = c1 - c0
    if n <= 0 or len(b0) != len(b1):
        return None
    prev_le = 0.0
    prev_win = 0.0
    for (le, cur_cum), (_, old_cum) in zip(b1, b0):
        win_cum = cur_cum - old_cum
        if le == "+Inf":
            return max(n - prev_win, 0.0) / n
        le = float(le)
        if le >= threshold:
            density = win_cum - prev_win
            width = le - prev_le
            frac_in = (threshold - prev_le) / width if width > 0 \
                else 1.0
            below = prev_win + density * min(max(frac_in, 0.0), 1.0)
            return max(n - below, 0.0) / n
        prev_le, prev_win = le, win_cum
    return max(n - prev_win, 0.0) / n


def stats_of(series):
    """A snapshot histogram series dict -> the ``stats()`` tuple shape
    ``(count, sum, [(le, cumulative), ...])`` the delta math takes."""
    if series is None:
        return None
    return (series["count"], series["sum"],
            [(le, c) for le, c in series["buckets"]])


# ----------------------------------------------------------------------
# the frame ring
# ----------------------------------------------------------------------
def _find_series(frame, name, labels):
    fam = frame["metrics"].get(name)
    if fam is None:
        return None
    for s in fam["series"]:
        if s.get("labels", {}) == labels:
            return s
    return None


class Timeline:
    """A bounded ring of registry snapshot frames + windowed queries.

    ``window`` caps the number of RETAINED frames (oldest evicted);
    ``clock`` stamps frame timestamps (injectable for tests).
    Thread-safe: tick() may run
    from a daemon while queries run from policy loops.
    """

    def __init__(self, window=None, registry=None, clock=time.time):
        if window is None:
            window = int(get_env("MXTPU_TIMELINE_WINDOW",
                                 DEFAULT_WINDOW, int))
        if window < 2:
            raise ValueError(
                "timeline: need window >= 2 frames (deltas need a "
                "prev and a cur), got %r" % (window,))
        self.window = int(window)
        self._registry = registry
        self._lock = threading.Lock()
        self._frames = deque(maxlen=self.window)
        self._clock = clock
        self._ticks_total = 0

    # -- recording (snapshot reads only, no device sync) --
    def tick(self, now=None):
        """Record one frame: a full registry snapshot stamped at
        ``now`` (defaults to this timeline's clock). Returns the
        frame dict. The ring evicts the oldest frame past
        ``window``."""
        reg = self._registry or _metrics.registry()
        snap = reg.snapshot()
        from ..tracing import clock as _clock
        frame = {
            "ts": self._clock() if now is None else now,
            "wall_ts": snap["ts"],
            "ts_ns": _clock.now_ns(),
            "metrics": snap["metrics"],
        }
        with self._lock:
            self._frames.append(frame)
            self._ticks_total += 1
        return frame

    def __len__(self):
        with self._lock:
            return len(self._frames)

    @property
    def ticks_total(self):
        return self._ticks_total

    def frames(self):
        with self._lock:
            return list(self._frames)

    def reset(self):
        """Drop recorded frames (the ring's capacity survives)."""
        with self._lock:
            self._frames.clear()

    # -- window selection ----------------------------------------------
    def bounds(self, window_s=None, now=None):
        """(prev_frame, cur_frame) spanning the query window, or
        (None, None) when fewer than two frames exist. ``window_s``
        None means the most recent delta (the last two frames, the
        between-ticks window); otherwise ``prev`` is
        the newest frame at or before ``now - window_s`` (falling
        back to the oldest retained frame), so the measured window is
        at least the requested one where history allows."""
        frames = self.frames()
        if len(frames) < 2:
            return None, None
        cur = frames[-1]
        if window_s is None:
            return frames[-2], cur
        now = cur["ts"] if now is None else now
        cutoff = now - float(window_s)
        prev = frames[0]
        for f in frames[:-1]:
            if f["ts"] <= cutoff:
                prev = f
            else:
                break
        return prev, cur

    # -- queries (read frames only) ------------------------------------
    def rate(self, name, window_s=None, now=None, **labels):
        """Per-second increase of a counter over the window. None
        when the window has no two frames or no elapsed time."""
        prev, cur = self.bounds(window_s, now)
        if prev is None:
            return None
        sp = _find_series(prev, name, labels)
        sc = _find_series(cur, name, labels)
        dt = cur["ts"] - prev["ts"]
        if sc is None or dt <= 0:
            return None
        v0 = sp["value"] if sp is not None else 0.0
        return (sc["value"] - v0) / dt

    def mean(self, name, window_s=None, now=None, **labels):
        """Arithmetic mean of a gauge's samples across the window's
        frames (endpoints included). None when no frame in the window
        carries the series."""
        frames = self.frames()
        if not frames:
            return None
        if window_s is None:
            picked = frames[-2:]
        else:
            now = frames[-1]["ts"] if now is None else now
            cutoff = now - float(window_s)
            picked = [f for f in frames if f["ts"] >= cutoff] \
                or frames[-1:]
        vals = []
        for f in picked:
            s = _find_series(f, name, labels)
            if s is not None and "value" in s:
                vals.append(float(s["value"]))
        if not vals:
            return None
        return sum(vals) / len(vals)

    def quantile(self, name, q=0.99, window_s=None, now=None,
                 **labels):
        """Windowed quantile of a histogram family via bucket deltas
        (:func:`delta_quantile`). None when the window saw no
        observations. A series absent from the prev frame (registered
        mid-window) deltas against zero."""
        prev, cur = self.bounds(window_s, now)
        if prev is None:
            return None
        sc = _find_series(cur, name, labels)
        if sc is None:
            return None
        sp = _find_series(prev, name, labels)
        cur_stats = stats_of(sc)
        prev_stats = stats_of(sp) if sp is not None else \
            (0, 0.0, [(le, 0) for le, _ in cur_stats[2]])
        return delta_quantile(prev_stats, cur_stats, q)

    def over_fraction(self, name, threshold, window_s=None, now=None,
                      **labels):
        """Fraction of the window's histogram observations above
        ``threshold`` (:func:`delta_over`) — the SLO error input."""
        prev, cur = self.bounds(window_s, now)
        if prev is None:
            return None
        sc = _find_series(cur, name, labels)
        if sc is None:
            return None
        sp = _find_series(prev, name, labels)
        cur_stats = stats_of(sc)
        prev_stats = stats_of(sp) if sp is not None else \
            (0, 0.0, [(le, 0) for le, _ in cur_stats[2]])
        return delta_over(prev_stats, cur_stats, threshold)

    def delta(self, name, window_s=None, now=None, **labels):
        """Raw counter increase over the window (rate without the
        divide — burn-rate ratios want both numerators)."""
        prev, cur = self.bounds(window_s, now)
        if prev is None:
            return None
        sc = _find_series(cur, name, labels)
        if sc is None:
            return None
        sp = _find_series(prev, name, labels)
        v0 = sp["value"] if sp is not None else 0.0
        return sc["value"] - v0

    # -- export ---------------------------------------------------------
    def to_doc(self, max_frames=None):
        """The versioned ``timeline/v1`` artifact: bounded frame list
        (newest last), ring metadata, schema version."""
        frames = self.frames()
        if max_frames is not None:
            frames = frames[-int(max_frames):]
        return {
            "kind": TIMELINE_KIND,
            "version": TIMELINE_VERSION,
            "created": time.time(),
            "window": self.window,
            "ticks_total": self._ticks_total,
            "frames": frames,
        }


def from_doc(doc):
    """Validate + return a ``timeline/v1`` document (report/CLI read
    path)."""
    if not isinstance(doc, dict) or doc.get("kind") != TIMELINE_KIND:
        raise ValueError("not a timeline/v1 document")
    return doc


def dump(path, timeline=None, max_frames=None):
    """Write the ``timeline/v1`` artifact atomically (tmp+rename —
    an observability artifact, not a checkpoint)."""
    tl = timeline if timeline is not None else process_timeline()
    doc = tl.to_doc(max_frames=max_frames)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps(doc, sort_keys=True))
    os.replace(tmp, path)
    return doc


# ----------------------------------------------------------------------
# the process timeline + periodic ticker
# ----------------------------------------------------------------------
_process = [None]


def process_timeline():
    """The shared per-process timeline (window from
    ``MXTPU_TIMELINE_WINDOW``), created on first use."""
    if _process[0] is None:
        _process[0] = Timeline()
    return _process[0]


def tick(now=None):
    """Advance the process timeline by one frame."""
    return process_timeline().tick(now=now)


class _Ticker(threading.Thread):
    def __init__(self, period, timeline):
        super().__init__(name="mxtpu-timeline-ticker", daemon=True)
        self._period = period
        self._timeline = timeline
        self._stop_ev = threading.Event()

    def run(self):
        while not self._stop_ev.wait(self._period):
            try:
                self._timeline.tick()
            except Exception:  # noqa: BLE001 — a broken snapshot must
                pass           # never kill the recorder daemon

    def stop(self):
        self._stop_ev.set()


_ticker = [None]


def start_ticker(period=None, timeline=None):
    """Start the periodic frame recorder (``MXTPU_TIMELINE_SEC``
    default; <= 0 disables). Idempotent."""
    if _ticker[0] is not None:
        return _ticker[0]
    if period is None:
        period = get_env("MXTPU_TIMELINE_SEC", 0.0, float)
    period = float(period)
    if period <= 0:
        return None
    t = _Ticker(period, timeline or process_timeline())
    _ticker[0] = t
    t.start()
    return t


def stop_ticker():
    t = _ticker[0]
    if t is not None:
        t.stop()
        t.join(timeout=5.0)
        _ticker[0] = None
