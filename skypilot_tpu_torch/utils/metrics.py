"""Dependency-free metrics plane: counters, gauges, fixed-bucket
histograms with Prometheus text exposition.

The replica's side of ``skypilot_tpu/utils/metrics.py``: the same
registry, instruments and ``skytpu_*`` names, so the serve controller
scrapes a PyTorch replica as it scrapes a JAX one. Of the scrape side,
the exposition parser that the serve benchmark reads a replica with
(``parse_text``, ``sample_value``, ``histogram_cumulative``) is copied;
the load balancer's fleet roll-ups are not.

The serve path computes TTFT estimates, queue depths, and per-step
timings and (before this module) threw them away as ad-hoc dict
counters; here they become scrapeable series so batching/autoscaling
tuning happens against production signals, not only bench runs. No
prometheus_client dependency: the container bakes a fixed toolchain, so
the registry + text format live in-tree (~the same architecture as
vLLM's metrics.py, minus the client library).

Cost model: instruments are plain attribute updates under a per-metric
lock (uncontended ~100ns); nothing is allocated per observation and
nothing happens at all unless a scraper hits ``render()``. Call sites
that want a strictly-zero disabled path hold ``None`` instead of a
metric container when ``enabled()`` is false, so disabled
instrumentation is one branch.

Naming convention (enforced at registration AND by
``scripts/check_metric_names.py``): ``skytpu_<subsystem>_<name>_<unit>``
with the unit drawn from :data:`UNITS` (counters end ``_total`` per
Prometheus convention).
"""
from __future__ import annotations

import bisect
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Latency buckets in MILLISECONDS: spans sub-ms decode steps through
# multi-second queue waits (TTFT p99 ~10s at the r05 knee).
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000, 30000)

# Allowed trailing unit tokens for skytpu_* metric names. 'total' is the
# Prometheus counter suffix; 'info' is the Prometheus info-metric idiom
# (constant 1 with identifying labels); 'token' denotes a per-token
# denominator (e.g. bytes_per_token); the rest are the units this
# codebase actually measures in.
UNITS = ('total', 'ms', 'seconds', 'tokens', 'requests', 'slots',
         'bytes', 'ratio', 'count', 'rps', 'info', 'token', 'flops')

_NAME_RE = re.compile(r'^skytpu_[a-z0-9]+(_[a-z0-9]+)+$')


def enabled() -> bool:
    """Metrics default ON (the plane exists to be on in production);
    $SKYTPU_METRICS=0 disables collection for overhead-sensitive runs."""
    return os.environ.get('SKYTPU_METRICS', '1').lower() not in (
        '0', 'false', 'off')


def validate_name(name: str) -> Optional[str]:
    """Return an error string when ``name`` violates the
    ``skytpu_<subsystem>_<name>_<unit>`` convention, else None. Shared
    with scripts/check_metric_names.py so the lint and the registry
    enforce one rule."""
    if not _NAME_RE.match(name):
        return (f'{name!r}: must match skytpu_<subsystem>_<name>_<unit> '
                '(lowercase, underscores)')
    parts = name.split('_')
    if len(parts) < 4:
        return (f'{name!r}: needs at least skytpu_<subsystem>_<name>_'
                f'<unit> (4 segments, got {len(parts)})')
    if parts[-1] not in UNITS:
        return (f'{name!r}: unit suffix {parts[-1]!r} not in '
                f'{sorted(UNITS)}')
    return None


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers render without the '.0'."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ''
    inner = ','.join(f'{k}="{v}"' for k, v in labels)
    return '{' + inner + '}'


def _fmt_exemplar(exemplar_id: str, value: float) -> str:
    """OpenMetrics exemplar suffix for a bucket sample line:
    ``... # {request_id="<id>"} <observed value>``. Our parser strips
    it; Prometheus pre-OpenMetrics scrapers skip unknown suffixes."""
    return f' # {{request_id="{exemplar_id}"}} {_fmt(value)}'


class Counter:
    """Monotonic counter."""

    kind = 'counter'

    def __init__(self, name: str, help_text: str,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help_text
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...],
                                    float]]:
        with self._lock:
            return [(self.name, self.labels, self._value)]


class Gauge:
    """Instantaneous value."""

    kind = 'gauge'

    def __init__(self, name: str, help_text: str,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help_text
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...],
                                    float]]:
        with self._lock:
            return [(self.name, self.labels, self._value)]


class Histogram:
    """Fixed-bucket histogram (cumulative buckets + sum + count).

    Buckets are chosen at registration; ``observe`` is a bisect + two
    adds under the lock — no per-observation allocation.
    """

    kind = 'histogram'

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help_text
        self.labels = labels
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f'{name}: histogram needs >= 1 bucket')
        self._lock = threading.Lock()
        # Non-cumulative per-bucket counts; +Inf is the final slot.
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        # Last exemplar per bucket: (id, observed value) or None. An
        # exemplar names the request that landed in the bucket, so a
        # tail-quantile cell can link straight to that request's trace.
        self._exemplars: List[Optional[Tuple[str, float]]] = (
            [None] * (len(self.buckets) + 1))

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), float(value))

    def exemplars(self) -> Dict[str, Tuple[str, float]]:
        """{le-label: (exemplar_id, observed value)} for buckets that
        hold one. Keys use the same le formatting as samples() ('+Inf'
        for the final bucket), so exposition and lookup agree."""
        with self._lock:
            snap = list(self._exemplars)
        out: Dict[str, Tuple[str, float]] = {}
        for le, ex in zip(self.buckets, snap):
            if ex is not None:
                out[_fmt(le)] = ex
        if snap[-1] is not None:
            out['+Inf'] = snap[-1]
        return out

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _snapshot(self) -> Tuple[List[int], float, int]:
        """Consistent (counts, sum, count) under one lock hold, so a
        scrape mid-observe can never show count != the +Inf bucket."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count)] including the +Inf bucket."""
        counts, _, _ = self._snapshot()
        out: List[Tuple[float, int]] = []
        running = 0
        for le, c in zip(self.buckets, counts):
            running += c
            out.append((le, running))
        out.append((float('inf'), running + counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0..1) by linear interpolation inside
        the containing bucket — the scraper-side promql
        histogram_quantile, usable locally (dashboard, bench summary).
        None when empty; the top bucket clamps to its lower edge."""
        return histogram_quantile(self.cumulative(), q)

    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...],
                                    float]]:
        counts, total, n = self._snapshot()
        out = []
        running = 0
        for le, c in zip(self.buckets, counts):
            running += c
            out.append((f'{self.name}_bucket',
                        self.labels + (('le', _fmt(le)),),
                        float(running)))
        out.append((f'{self.name}_bucket',
                    self.labels + (('le', '+Inf'),), float(n)))
        out.append((f'{self.name}_sum', self.labels, total))
        out.append((f'{self.name}_count', self.labels, float(n)))
        return out


def histogram_quantile(cumulative: Sequence[Tuple[float, float]],
                       q: float) -> Optional[float]:
    """Quantile estimate from [(le, cumulative_count)] pairs (the last
    pair being +Inf). Mirrors PromQL histogram_quantile: linear
    interpolation within the bucket, top (+Inf) bucket clamped to the
    highest finite edge.

    Degenerate inputs are deterministic, never arithmetic errors: an
    empty list or zero total observations -> None; a single-bucket
    histogram (only +Inf, no finite edge to interpolate toward) ->
    0.0; q outside [0, 1] is clamped so a caller typo can never walk
    off the bucket list and return +Inf."""
    if not cumulative:
        return None
    total = cumulative[-1][1]
    if total <= 0:
        return None
    rank = min(1.0, max(0.0, q)) * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in cumulative:
        if cum >= rank:
            if le == float('inf'):
                return prev_le  # clamp: no upper edge to interpolate to
            if cum == prev_cum:
                return le
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    # Unreachable with monotone cumulative input (the +Inf pair holds
    # the total); a non-monotone scrape still gets a finite answer.
    return 0.0 if prev_le == float('inf') else prev_le


# Rendering an EMPTY registry must not allocate: the no-metrics case is
# every non-serving process that still mounts /metrics.
_EMPTY = ''


class Registry:
    """Ordered collection of metrics with idempotent registration.

    Re-registering a name returns the existing metric (multiple
    scheduler instances in one process — tests — share series); a kind
    mismatch is a programming error and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            Any] = {}

    def _register(self, cls, name: str, help_text: str,
                  labels: Optional[Dict[str, str]] = None,
                  **kwargs) -> Any:
        err = validate_name(name)
        if err:
            raise ValueError(f'bad metric name {err}')
        lbl = tuple(sorted((labels or {}).items()))
        key = (name, lbl)
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f'{name} already registered as '
                        f'{existing.kind}, not {cls.kind}')
                return existing
            metric = cls(name, help_text, labels=lbl, **kwargs)
            self._metrics[key] = metric
            return metric

    def counter(self, name: str, help_text: str = '',
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._register(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str = '',
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._register(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str = '',
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._register(Histogram, name, help_text, labels,
                              buckets=buckets)

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None) -> Optional[Any]:
        with self._lock:
            return self._metrics.get(
                (name, tuple(sorted((labels or {}).items()))))

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
        if not metrics:
            return _EMPTY
        lines: List[str] = []
        seen_headers = set()
        for m in metrics:
            if m.name not in seen_headers:
                seen_headers.add(m.name)
                if m.help:
                    lines.append(f'# HELP {m.name} {m.help}')
                lines.append(f'# TYPE {m.name} {m.kind}')
            exemplars = (m.exemplars()
                         if isinstance(m, Histogram) else {})
            for sample_name, labels, value in m.samples():
                line = f'{sample_name}{_fmt_labels(labels)} {_fmt(value)}'
                if exemplars and sample_name.endswith('_bucket'):
                    ex = exemplars.get(dict(labels).get('le', ''))
                    if ex is not None:
                        line += _fmt_exemplar(*ex)
                lines.append(line)
        return '\n'.join(lines) + '\n'


# Default process-wide registry; serving subsystems register here so one
# /metrics endpoint exposes scheduler + engine series together.
REGISTRY = Registry()

CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'


def counter(name: str, help_text: str = '',
            labels: Optional[Dict[str, str]] = None) -> Counter:
    return REGISTRY.counter(name, help_text, labels)


def gauge(name: str, help_text: str = '',
          labels: Optional[Dict[str, str]] = None) -> Gauge:
    return REGISTRY.gauge(name, help_text, labels)


def histogram(name: str, help_text: str = '',
              buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
              labels: Optional[Dict[str, str]] = None) -> Histogram:
    return REGISTRY.histogram(name, help_text, buckets, labels)


# ---- scrape-side helpers ----------------------------------------------------
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

Sample = Tuple[str, Tuple[Tuple[str, str], ...], float]


def parse_text(text: str) -> List[Sample]:
    """Parse Prometheus text exposition into (name, labels, value)
    samples. Tolerant: comment/blank/malformed lines are skipped — a
    scrape of an arbitrary replica must never crash the scraper."""
    out: List[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        if ' # ' in line:  # OpenMetrics exemplar suffix on a sample
            line = line.split(' # ', 1)[0].rstrip()
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = tuple((k, v) for k, v in
                       _LABEL_RE.findall(raw_labels or ''))
        out.append((name, labels, value))
    return out


def sample_value(samples: Sequence[Sample], name: str,
                 labels: Optional[Dict[str, str]] = None
                 ) -> Optional[float]:
    """First sample value for ``name`` (None if absent). Without
    ``labels`` the first sample of any labeling wins; with ``labels``
    the sample's labels must contain every given pair."""
    want = tuple(sorted((labels or {}).items()))
    for n, lbl, v in samples:
        if n != name:
            continue
        if not want or set(want) <= set(lbl):
            return v
    return None


def histogram_cumulative(samples: Sequence[Sample],
                         name: str) -> List[Tuple[float, float]]:
    """Reconstruct [(le, cumulative)] for histogram ``name`` from parsed
    samples (scrape-side counterpart of Histogram.cumulative)."""
    out: List[Tuple[float, float]] = []
    for n, labels, v in samples:
        if n != f'{name}_bucket':
            continue
        le = dict(labels).get('le')
        if le is None:
            continue
        out.append((float('inf') if le == '+Inf' else float(le), v))
    out.sort(key=lambda p: p[0])
    return out
