"""Serving metrics registry: counters, gauges, and histograms with a
deterministic snapshot API (counterpart of the JAX package's
``obs/metrics.py``, pure host code kept as it is there).

Every
metric is named, typed, and rendered from ``snapshot()`` — a plain nested
dict with sorted keys whose contents depend only on the sequence of
``inc/set/observe`` calls, never on wall-clock time or iteration order of
an unordered container. Two sessions fed the same virtual-step history
produce byte-identical snapshots, which is what lets the observer-effect
oracle extend to the metrics layer.

Histograms use fixed bucket boundaries chosen at registration (upper-bound
inclusive, +inf implicit) and additionally track count/sum/min/max so
quantile-ish summaries stay deterministic without storing samples.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence


class Counter:
    """Monotonically non-decreasing accumulator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        self.value += amount

    def snapshot(self):
        return _num(self.value)


class Gauge:
    """Last-written value plus running extrema (peak queue depth etc.)."""

    __slots__ = ("name", "value", "min", "max", "_seen")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.min = 0.0
        self.max = 0.0
        self._seen = False

    def set(self, value: float) -> None:
        value = float(value)
        self.value = value
        if not self._seen:
            self.min = self.max = value
            self._seen = True
        else:
            self.min = min(self.min, value)
            self.max = max(self.max, value)

    def snapshot(self):
        return {"value": _num(self.value), "min": _num(self.min),
                "max": _num(self.max)}


#: default histogram buckets — powers of two cover token counts, steps,
#: and page counts equally well; energy histograms register their own
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max sidecars."""

    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram {name} buckets must be strictly "
                             f"increasing and non-empty, got {buckets}")
        self.name = name
        self.buckets = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1 for the +inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        i = 0
        while i < len(self.buckets) and value > self.buckets[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> tuple[float, bool]:
        """Deterministic bucket-interpolated quantile estimate.

        Returns ``(estimate, from_overflow)``: linear interpolation
        within the bucket holding the ``q``-th sample, clamped to the
        observed ``[min, max]`` (the sidecars know more than the bucket
        bounds do). ``from_overflow=True`` flags an estimate drawn from
        the +inf bucket — the bounds were outgrown, so the value is only
        bounded by the tracked ``max`` and callers should say so loudly.
        """
        if not self.count:
            return 0.0, False
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c > 0 and cum + c >= target:
                lower = self.buckets[i - 1] if i > 0 else 0.0
                overflow = i >= len(self.buckets)
                upper = self.max if overflow else self.buckets[i]
                upper = max(upper, lower)
                est = lower + (upper - lower) * ((target - cum) / c)
                return min(max(est, self.min), self.max), overflow
            cum += c
        return self.max, self.counts[-1] > 0

    def snapshot(self):
        out = {"count": self.count, "sum": _num(self.sum),
               "mean": _num(self.mean())}
        if self.count:
            out["min"] = _num(self.min)
            out["max"] = _num(self.max)
            out["p50"] = _num(self.quantile(0.50)[0])
            out["p99"] = _num(self.quantile(0.99)[0])
            if self.counts[-1]:
                # loud: samples landed beyond the top bound, so bucket
                # estimates (p50/p99 included) clamp to the tracked max
                out["overflow"] = self.counts[-1]
        out["buckets"] = {_bucket_label(self.buckets, i): c
                          for i, c in enumerate(self.counts) if c}
        return out


def _bucket_label(bounds, i: int) -> str:
    if i >= len(bounds):
        return "+inf"
    b = bounds[i]
    return str(int(b)) if float(b).is_integer() else repr(b)


def _num(x: float):
    """Collapse float-valued integers so snapshots render cleanly."""
    return int(x) if float(x).is_integer() and abs(x) < 2**53 else float(x)


class MetricsRegistry:
    """Named metric namespace with deterministic snapshots.

    ``counter/gauge/histogram`` create-or-fetch by name (re-registering a
    name as a different type is an error — silently returning the wrong
    kind would corrupt whichever caller loses the race)."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, kind, **kwargs):
        metric = self._metrics.get(name)
        if metric is None:
            metric = self._metrics[name] = kind(name, **kwargs)
        elif type(metric) is not kind:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(metric).__name__}, not {kind.__name__}")
        return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """``{name: value-or-dict}`` sorted by name; plain JSON types only."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    @staticmethod
    def render(snapshot: Mapping, indent: str = "  ") -> str:
        """Human-oriented fixed-order table of a snapshot (what
        ``launch/serve.py --obs`` prints)."""
        lines = []
        for name in sorted(snapshot):
            val = snapshot[name]
            if isinstance(val, Mapping):
                if "buckets" in val:  # histogram
                    desc = (f"count={val['count']} mean={val['mean']:.6g}"
                            if val["count"] else "count=0")
                    if val.get("count"):
                        desc += (f" p50={val['p50']:.6g} "
                                 f"p99={val['p99']:.6g} "
                                 f"min={val['min']:.6g} max={val['max']:.6g}")
                    if val.get("overflow"):
                        desc += (f" OVERFLOW={val['overflow']} (beyond top "
                                 f"bucket; estimates clamp to max)")
                else:  # gauge
                    desc = (f"{val['value']:.6g} "
                            f"(min={val['min']:.6g} max={val['max']:.6g})")
            else:
                desc = f"{val:.6g}" if isinstance(val, float) else str(val)
            lines.append(f"{indent}{name:<34} {desc}")
        return "\n".join(lines)
