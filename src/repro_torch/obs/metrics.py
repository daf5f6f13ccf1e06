"""Counters, gauges, histograms, and the re-capture detector.

:class:`MetricsRegistry` is a name -> instrument map with per-tick ring
buffers: the scheduler calls :meth:`MetricsRegistry.sample` once per
tick, which appends ``(tick, t, value)`` to each instrument's bounded
deque, so a finished run carries a time series (pool occupancy over a
faulted run, batch occupancy through an overload burst) without unbounded
growth. ``snapshot()`` gives current values as a plain dict; ``dump()``
gives a Prometheus-flavoured text block for logs.

Naming convention: ``<subsystem>.<what>`` (``pool.in_use``,
``sched.preemptions``, ``prefix.hit_tokens``, ``graph.captures``,
``graph.recompiles_steady_state``, ``quant.saturated``), the JAX
package's names where a metric has a counterpart there.

:class:`CompileWatcher` is the counterpart of the JAX package's watcher of
``jax.monitoring`` compile events. The port's compiled program is the
decode step captured in a CUDA graph (``serve/graphs.py::DecodeStep``),
once per (decode batch, table width); a capture is its compile. Every
capture calls :func:`record_capture`, which reaches every started
watcher; after :meth:`CompileWatcher.arm` (call once warmed up) a
capture is a steady-state recompile, counted in
``steady_state_recompiles`` and ``graph.recompiles_steady_state``. A
serving loop past its warm-up must keep that at zero: preemption,
cancellation and quarantine change slots through the page tables in
place and never re-capture. ``autotune.hit`` / ``autotune.miss`` in
:data:`GLOBAL` count the launch-plan table's lookups
(``kernels/autotune.py``), as the JAX package's count its block table's.

There is also a process-wide :data:`GLOBAL` registry for counters that
belong to no serving loop (fake-quant saturation at weight-load time);
per-scheduler registries stay isolated so two engines in one process do
not count into each other.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "GLOBAL",
           "CompileWatcher", "record_capture"]


class Counter:
    """Monotonically non-decreasing count. ``inc`` with a negative
    amount raises — monotonicity is one of the fuzz invariants."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def get(self) -> float:
        return self.value


class Gauge:
    """Point-in-time value (pool occupancy, batch fill)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def get(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram with sum/count (latency distributions).

    ``buckets`` are upper bounds; an implicit +inf bucket catches the
    rest. ``get()`` reports the count so ring-buffer sampling of a
    histogram still yields a monotone series.
    """

    kind = "histogram"
    DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                       250.0, 500.0, 1000.0, 2500.0)

    def __init__(self, name: str,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def get(self) -> float:
        return float(self.count)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create instrument registry with per-tick ring buffers."""

    def __init__(self, *, ring: int = 4096,
                 now_fn: Optional[Callable[[], float]] = None):
        self.now = now_fn or time.monotonic
        self.ring = ring
        self._instruments: Dict[str, Any] = {}
        self._series: Dict[str, Deque[Tuple[int, float, float]]] = {}

    def _get(self, name: str, cls, *args):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, *args)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} is a {inst.kind}, "
                            f"not a {cls.__name__.lower()}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        if name in self._instruments:
            return self._get(name, Histogram)
        return self._get(name, Histogram, buckets)

    # -- sampling -----------------------------------------------------
    def sample(self, tick: int) -> None:
        """Append every instrument's current value to its ring buffer."""
        t = self.now()
        for name, inst in self._instruments.items():
            series = self._series.get(name)
            if series is None:
                series = self._series[name] = deque(maxlen=self.ring)
            series.append((tick, t, inst.get()))

    def series(self, name: str) -> List[Tuple[int, float, float]]:
        return list(self._series.get(name) or ())

    def snapshot(self) -> Dict[str, float]:
        return {name: inst.get()
                for name, inst in sorted(self._instruments.items())}

    def dump(self) -> str:
        """Prometheus-flavoured text exposition (for logs, not scrape)."""
        lines = []
        for name, inst in sorted(self._instruments.items()):
            lines.append(f"# TYPE {name} {inst.kind}")
            if isinstance(inst, Histogram):
                cum = 0
                for ub, c in zip(inst.buckets, inst.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{ub}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {inst.count}')
                lines.append(f"{name}_sum {inst.sum}")
                lines.append(f"{name}_count {inst.count}")
            else:
                lines.append(f"{name} {inst.get()}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        self._instruments.clear()
        self._series.clear()


#: Process-wide registry for loop-independent counters (fake-quant
#: saturation). Serving loops get their own.
GLOBAL = MetricsRegistry()


# -- re-capture detector ------------------------------------------------

_WATCHERS: List["CompileWatcher"] = []
_LOCK = threading.Lock()


def record_capture(seconds: float) -> None:
    """One CUDA-graph capture of the decode step took ``seconds``: tell
    every started watcher (``serve/graphs.py`` calls this)."""
    with _LOCK:
        watchers = list(_WATCHERS)
    for w in watchers:
        w._on_compile(seconds)


class CompileWatcher:
    """Counts decode-step captures; armed, they become a defect count.

    ``compiles`` counts captures and ``compile_secs`` their time (the
    eager step before each included). After :meth:`arm`, a capture also
    bumps ``steady_state_recompiles``, mirrored into the owning registry
    as ``graph.recompiles_steady_state``. (The JAX package's watcher also
    counts jaxpr retraces; a graph has no such step, so there is no
    ``retraces`` here.)"""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry
        self.compiles = 0
        self.compile_secs = 0.0
        self.armed = False
        self.steady_state_recompiles = 0
        self._started = False

    def start(self) -> "CompileWatcher":
        if not self._started:
            with _LOCK:
                _WATCHERS.append(self)
            self._started = True
        return self

    def stop(self) -> None:
        if self._started:
            with _LOCK:
                if self in _WATCHERS:
                    _WATCHERS.remove(self)
            self._started = False

    def arm(self) -> None:
        self.armed = True
        if self.registry is not None:
            self.registry.counter("graph.recompiles_steady_state")

    def _on_compile(self, seconds: float) -> None:
        self.compiles += 1
        self.compile_secs += seconds
        if self.registry is not None:
            self.registry.counter("graph.captures").inc()
        if self.armed:
            self.steady_state_recompiles += 1
            if self.registry is not None:
                self.registry.counter("graph.recompiles_steady_state").inc()

    def __enter__(self) -> "CompileWatcher":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
