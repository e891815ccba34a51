"""Runtime telemetry of the port: a process-wide registry of counters,
gauges and histograms (counterpart of ``incubator_mxnet_tpu/
telemetry.py``, with the same names and semantics).

It records *counts and levels* on the host: op dispatches, live NDArray
bytes, kvstore pushes and pulls, data batches and prefetch hits, train
steps and the bytes they move, and the serving and generation metrics
(``serving.*``, ``gen.*``) that ``ModelServer.stats()`` and
``GenerationServer.stats()`` return.

Three metric kinds, one process-wide registry:

* ``Counter``   — monotonically increasing count.
* ``Gauge``     — a level that goes up and down (``add_async`` is the
  lock-free form finalizers use).
* ``Histogram`` — count/mean/p50/p95/max over a bounded reservoir of
  recent observations.

Hot-path contract: every instrumented call site guards with
``if telemetry.enabled:`` so ``MXNET_TELEMETRY=0`` costs one branch per
call, and a subsystem registers its metrics at its first use, so an
unused or disabled one adds no registry entry.  The metric methods check
the flag themselves too.

Where it differs from the JAX module: the window sampler records the
registry only (the JAX sampler also refreshes the ``resources``,
``goodput``, ``commprof`` and ``fleet`` gauges, which the port does not
have yet), and the Prometheus exposition carries no fleet identity
labels.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import re
import threading
import time

from .base import MXNetError, get_env

__all__ = ["Counter", "Gauge", "Histogram",
           "counter", "gauge", "histogram", "get", "metrics",
           "snapshot", "report", "reset",
           "record_window", "windows", "window_deltas", "rates",
           "prometheus", "start_sampler", "stop_sampler", "sampler_running",
           "enable", "disable", "is_enabled", "enabled"]

_logger = logging.getLogger(__name__)


def _default_enabled():
    """MXNET_TELEMETRY=0 disables all collection (default: on)."""
    return os.environ.get("MXNET_TELEMETRY", "1").lower() not in (
        "0", "false", "off", "no")


#: module-level fast-path flag — hot paths read this directly so the
#: disabled cost is a single branch per dispatch
enabled = _default_enabled()

_lock = threading.Lock()
_metrics = {}            # name -> metric (process-wide)


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("name", "_lock", "_value")
    kind = "counter"

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        if not enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset(self):
        with self._lock:
            self._value = 0

    def _snapshot(self):
        return self._value

    def __repr__(self):
        return f"<Counter {self.name}={self._value}>"


class Gauge:
    """A level that can move both ways (thread-safe).

    ``add_async`` exists for finalizer/GC contexts (NDArray.__del__):
    it must never wait on ``_lock`` — a cyclic-GC pass can fire *inside*
    ``add()`` while the lock is held (the ``+=`` allocates), and a
    finalizer re-entering the non-reentrant lock on the same thread
    would deadlock. Async deltas go through a lock-free deque and are
    folded in on the next locked operation or read, or by ``add_async``
    itself once ``_FOLD_AT`` are pending and the lock is free at once
    (a try, never a wait), so a gauge nobody reads stays bounded.  The
    port's hot paths (``NDArray`` creation) use it too: a deque append
    costs less than the lock.
    """

    __slots__ = ("name", "_lock", "_value", "_pending")
    kind = "gauge"
    _FOLD_AT = 4096

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0
        self._pending = collections.deque()   # deltas from finalizers

    def _drain(self):
        # caller holds self._lock, so this is the only consumer of the
        # deque: a non-empty deque stays non-empty until its popleft.
        # Deque ops stay lock-free so a GC pass during the += below can
        # still add_async() without deadlock.  (Testing for emptiness
        # first spares the raised IndexError on every call.)
        pending = self._pending
        while pending:
            self._value += pending.popleft()

    def set(self, v):
        if not enabled:
            return
        with self._lock:
            self._pending.clear()
            self._value = v

    def add(self, n=1):
        # NOT gated on `enabled`: paired add/subtract sites (live-byte
        # accounting) must stay balanced even if telemetry is toggled
        # between the two halves; creation sites gate on `enabled`.
        with self._lock:
            self._drain()
            self._value += n

    def add_async(self, n=1):
        """Lock-free delta — the only gauge method safe to call from
        __del__/GC finalizers."""
        pending = self._pending
        pending.append(n)
        if len(pending) >= self._FOLD_AT and \
                self._lock.acquire(blocking=False):
            try:
                self._drain()
            finally:
                self._lock.release()

    @property
    def value(self):
        with self._lock:
            self._drain()
            return self._value

    def _reset(self):
        with self._lock:
            self._pending.clear()
            self._value = 0

    def _snapshot(self):
        return self.value

    def __repr__(self):
        return f"<Gauge {self.name}={self.value}>"


class Histogram:
    """Distribution over a bounded reservoir of recent observations.

    Keeps exact count/sum/max plus a ring buffer of the last ``_CAP``
    values for percentiles — hot paths never allocate unboundedly.
    """

    __slots__ = ("name", "_lock", "_count", "_sum", "_max", "_buf", "_idx")
    kind = "histogram"
    _CAP = 2048

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._buf = []
        self._idx = 0

    def observe(self, v):
        if not enabled:
            return
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v
            if len(self._buf) < self._CAP:
                self._buf.append(v)
            else:
                self._buf[self._idx % self._CAP] = v
            self._idx += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def max(self):
        return self._max

    @property
    def mean(self):
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q):
        """q in [0, 100], computed over the retained reservoir."""
        with self._lock:
            buf = sorted(self._buf)
        if not buf:
            return 0.0
        idx = min(len(buf) - 1, int(round(q / 100.0 * (len(buf) - 1))))
        return buf[idx]

    def _reset(self):
        with self._lock:
            self._count = 0
            self._sum = 0.0
            self._max = 0.0
            self._buf = []
            self._idx = 0

    def _snapshot(self):
        return {"count": self._count, "mean": round(self.mean, 3),
                "p50": round(self.percentile(50), 3),
                "p95": round(self.percentile(95), 3),
                "max": round(self._max, 3)}

    def __repr__(self):
        return f"<Histogram {self.name} n={self._count}>"


# ------------------------------------------------------------- registry
def _get_or_create(name, cls):
    m = _metrics.get(name)
    if m is None:
        with _lock:
            m = _metrics.get(name)
            if m is None:
                m = cls(name)
                _metrics[name] = m
    if type(m) is not cls:
        raise MXNetError(
            f"telemetry metric {name!r} already registered as {m.kind}, "
            f"not {cls.kind}")
    return m


def counter(name) -> Counter:
    """Get-or-create the Counter named ``name``."""
    return _get_or_create(name, Counter)


def gauge(name) -> Gauge:
    """Get-or-create the Gauge named ``name``."""
    return _get_or_create(name, Gauge)


def histogram(name) -> Histogram:
    """Get-or-create the Histogram named ``name``."""
    return _get_or_create(name, Histogram)


def get(name):
    """The metric named ``name``, or None."""
    return _metrics.get(name)


def metrics():
    """Snapshot copy of the name -> metric map."""
    return dict(_metrics)


def reset():
    """Zero every registered metric (metrics stay registered).

    Live-level gauges are rebased to zero: objects created before the
    reset that release afterwards can drive them slightly negative —
    the price of a raceless reset, fine for diagnostics.
    """
    for m in list(_metrics.values()):
        m._reset()


def enable():
    global enabled
    enabled = True


def disable():
    global enabled
    enabled = False


def is_enabled():
    return enabled


# -------------------------------------------------------------- reports
def snapshot():
    """{name: value} for every metric — scalars for counters/gauges,
    {count, mean, p50, p95, max} dicts for histograms."""
    return {name: m._snapshot() for name, m in sorted(_metrics.items())}


def report(as_dict=False):
    """Diagnostics report over every registered metric.

    ``as_dict=True`` returns the machine-readable form (== snapshot());
    otherwise a human-readable table sorted by metric name.
    """
    snap = snapshot()
    if as_dict:
        return snap
    lines = [f"Telemetry ({'enabled' if enabled else 'DISABLED'}, "
             f"{len(snap)} metrics)",
             f"{'Metric':<42}{'Kind':<11}{'Value'}",
             "-" * 78]
    for name, val in snap.items():
        kind = _metrics[name].kind
        if isinstance(val, dict):
            shown = (f"n={val['count']} mean={val['mean']} "
                     f"p50={val['p50']} p95={val['p95']} max={val['max']}")
        else:
            shown = str(val)
        lines.append(f"{name:<42}{kind:<11}{shown}")
    return "\n".join(lines)


# ================================================= windowed time-series
# A bounded ring of periodic registry snapshots.  Cumulative-since-start
# counters answer "how many ever"; the window ring answers "how many
# RIGHT NOW": per-window deltas and derived rates, the difference
# between a healthy steady state and a live incident.  The background
# sampler (``start_sampler``) records on a MXNET_TELEMETRY_WINDOW_S
# cadence; each sample can also be appended to a JSONL file
# (MXNET_METRICS_LOG) for offline time-series tooling.

def _window_cap():
    return max(2, get_env("MXNET_TELEMETRY_WINDOWS", 120, int))


def _window_period():
    return max(0.01, get_env("MXNET_TELEMETRY_WINDOW_S", 60.0, float))


_window_lock = threading.Lock()
_windows = collections.deque(maxlen=_window_cap())
_sampler = None
_sampler_stop = None


def record_window(now=None):
    """Append one snapshot to the window ring (and to the
    ``MXNET_METRICS_LOG`` JSONL file when set).  Returns the entry."""
    entry = {"t": time.time() if now is None else now,
             "pt": time.perf_counter(),
             "metrics": snapshot()}
    with _window_lock:
        _windows.append(entry)
    path = os.environ.get("MXNET_METRICS_LOG")
    if path:
        try:
            with open(path, "a") as f:
                f.write(json.dumps({"t": entry["t"],
                                    "metrics": entry["metrics"]}) + "\n")
        except OSError as e:
            # the ring holds the sample; a log file that cannot be
            # written is reported, not raised into the sampled program
            _logger.warning("MXNET_METRICS_LOG=%s not written: %s", path, e)
    return entry


def windows():
    """The retained window snapshots, oldest first."""
    with _window_lock:
        return list(_windows)


def window_deltas():
    """Per-window deltas and rates between consecutive snapshots:
    ``[{t0, t1, dt_s, deltas, rates, gauges}]`` where ``deltas`` holds
    counter increments (histograms contribute ``<name>.count``),
    ``rates`` the same per second, and ``gauges`` the level at the end
    of the window.  Counter resets clamp to zero instead of going
    negative."""
    snaps = windows()
    out = []
    for prev, cur in zip(snaps, snaps[1:]):
        dt = max(1e-9, cur["t"] - prev["t"])
        deltas, gauges = {}, {}
        for name, val in cur["metrics"].items():
            m = _metrics.get(name)
            kind = m.kind if m is not None else (
                "histogram" if isinstance(val, dict) else "counter")
            old = prev["metrics"].get(name)
            if kind == "gauge":
                gauges[name] = val
            elif kind == "histogram":
                oc = old["count"] if isinstance(old, dict) else 0
                deltas[name + ".count"] = max(0, val["count"] - oc)
            else:
                deltas[name] = max(0, val - (old if old is not None else 0))
        out.append({"t0": prev["t"], "t1": cur["t"],
                    "dt_s": round(dt, 3), "deltas": deltas,
                    "rates": {k: round(v / dt, 3)
                              for k, v in deltas.items()},
                    "gauges": gauges})
    return out


def rates():
    """The most recent window's per-second rates ({} with <2 windows)."""
    d = window_deltas()
    return d[-1]["rates"] if d else {}


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name):
    n = _PROM_BAD.sub("_", name)
    if not n or not (n[0].isalpha() or n[0] in "_:"):
        n = "_" + n
    return "mxnet_" + n


def _identity_labels():
    """Prometheus label body of a configured fleet identity: None, the
    port has no fleet plane yet, so the exposition stays label-free."""
    return None


def prometheus():
    """The current registry as Prometheus text exposition (version
    0.0.4): counters and gauges as scalars, histograms as summaries
    (quantile series + ``_sum``/``_count``); each series carries the
    labels ``_identity_labels`` gives (none yet)."""
    lbl = _identity_labels()
    suffix = "{" + lbl + "}" if lbl else ""
    lines = []
    for name, m in sorted(metrics().items()):
        pname = _prom_name(name)
        if m.kind == "histogram":
            lines.append(f"# TYPE {pname} summary")
            for q, v in (("0.5", m.percentile(50)),
                         ("0.95", m.percentile(95))):
                qlbl = f'quantile="{q}"' + ("," + lbl if lbl else "")
                lines.append(f"{pname}{{{qlbl}}} {v!r}")
            lines.append(f"{pname}_sum{suffix} {m.sum!r}")
            lines.append(f"{pname}_count{suffix} {m.count}")
        else:
            lines.append(f"# TYPE {pname} {m.kind}")
            lines.append(f"{pname}{suffix} {m._snapshot()!r}")
    return "\n".join(lines) + "\n"


def _sample_once():
    record_window()


def start_sampler(period_s=None):
    """Start the background window sampler (idempotent), recording every
    ``period_s`` (default ``MXNET_TELEMETRY_WINDOW_S``, 60 s)."""
    global _sampler, _sampler_stop
    if period_s is None:
        period_s = _window_period()
    with _window_lock:
        if _sampler is not None and _sampler.is_alive():
            return _sampler
        stop = threading.Event()

        def loop():
            while not stop.wait(period_s):
                _sample_once()

        t = threading.Thread(target=loop, name="mxnet-telemetry-sampler",
                             daemon=True)
        _sampler, _sampler_stop = t, stop
    record_window()                   # baseline so the first tick deltas
    t.start()
    return t


def stop_sampler():
    """Stop the background sampler (idempotent)."""
    global _sampler, _sampler_stop
    with _window_lock:
        t, stop = _sampler, _sampler_stop
        _sampler = _sampler_stop = None
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive():
        t.join(timeout=2.0)


def sampler_running():
    with _window_lock:
        return _sampler is not None and _sampler.is_alive()


def _reset_windows():
    """Test hook: stop the sampler and clear the ring, re-reading the
    env-var ring size."""
    global _windows
    stop_sampler()
    with _window_lock:
        _windows = collections.deque(maxlen=_window_cap())
