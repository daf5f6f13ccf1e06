"""``repro_torch.obs``: tracing and metrics for the serving stack.

The port's copy of the JAX package's ``repro.obs``, with no dependency
beyond the standard library. Three layers, all off by default and all
token-neutral (observing a run never changes what a request generates;
tests/test_torch_obs.py holds obs on against obs off token for token):

* **Request-lifecycle tracing** (:mod:`repro_torch.obs.trace`): an
  injectable-clock span recorder. The scheduler opens one root span per
  request (``request``) with well-nested phase children (``queued`` ->
  ``prefill`` with per-chunk spans -> ``decode``), and drops instant
  events for the transitions (``prefix_hit``, ``first_token``,
  ``token``, ``preempt``, ``fault``, ``quarantine``, ``terminal``).
  Export as JSONL or Chrome ``trace_event`` JSON that loads in Perfetto
  (:mod:`repro_torch.obs.export`); summarize from the command line
  (``python -m repro_torch.obs.report``).
* **Metrics** (:mod:`repro_torch.obs.metrics`): counters, gauges and
  histograms in a registry, sampled into ring buffers once per scheduler
  tick (pool occupancy and quarantine, prefix hit tokens, preemptions,
  batch occupancy, tokens), and a **re-capture detector**: a CUDA-graph
  capture of the decode step after warm-up is the port's steady-state
  recompile, a counter and a test assertion.
* **Numeric health** (``REPRO_OBS=2``): the pool's NaR-word scan
  (:meth:`repro_torch.serve.paged.PagePool.scan_nar`) and fake-quant
  saturation counters. The scan reads the device (one sync a tick),
  hence the separate level. (The JAX package also reads its
  tensor-parallel residual norms here; the port has no tensor parallelism
  yet.)

Env gate ``REPRO_OBS``: ``0``/unset: off, every hook is a ``None``
check; ``1``: tracing and metrics; ``2``: tracing, metrics and numeric
health. The scheduler builds its bundle with :func:`obs_from_env` at
construction, on its own injectable clock, so traces on a fake clock are
deterministic.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from repro_torch.obs import export, metrics, trace  # noqa: F401 (re-export)
from repro_torch.obs.metrics import GLOBAL, CompileWatcher, MetricsRegistry
from repro_torch.obs.trace import SCHED_TRACK, RequestTiming, Tracer

__all__ = ["OBS_ENV", "level", "enabled", "numeric_enabled", "ServeObs",
           "obs_from_env", "Tracer", "MetricsRegistry", "CompileWatcher",
           "RequestTiming", "SCHED_TRACK", "GLOBAL"]

OBS_ENV = "REPRO_OBS"


def level() -> int:
    """Effective ``REPRO_OBS`` level: 0 (off), 1 (trace and metrics) or
    2 (and numeric health). Anything else raises: a mistyped knob must not
    quietly turn observability off."""
    raw = os.environ.get(OBS_ENV, "0") or "0"
    if raw not in ("0", "1", "2"):
        raise ValueError(f"{OBS_ENV}={raw!r}: expected 0, 1 or 2")
    return int(raw)


def enabled() -> bool:
    return level() >= 1


def numeric_enabled() -> bool:
    return level() >= 2


class ServeObs:
    """One serving loop's bundle: a :class:`Tracer`, a
    :class:`MetricsRegistry` and a started :class:`CompileWatcher`, on one
    clock. The scheduler owns one (``Scheduler.obs``) when ``REPRO_OBS``
    is on; below numeric level it reads no device value."""

    def __init__(self, now_fn: Optional[Callable[[], float]] = None, *,
                 numeric: bool = False, ring: int = 4096):
        self.tracer = Tracer(now_fn)
        self.metrics = MetricsRegistry(ring=ring, now_fn=now_fn)
        self.numeric = numeric
        self.compile_watcher = CompileWatcher(registry=self.metrics)
        self.compile_watcher.start()

    def arm_steady(self) -> None:
        """Declare steady state: from now on every decode-step capture
        counts into ``graph.recompiles_steady_state`` (call after warm-up:
        a serving loop past its first full round never re-captures)."""
        self.compile_watcher.arm()

    @property
    def steady_state_recompiles(self) -> int:
        return self.compile_watcher.steady_state_recompiles

    def close(self) -> None:
        """Detach the capture watcher (idempotent)."""
        self.compile_watcher.stop()


def obs_from_env(now_fn: Optional[Callable[[], float]] = None
                 ) -> Optional[ServeObs]:
    """A :class:`ServeObs` at the ``REPRO_OBS`` level, or ``None`` when
    observability is off (the default; callers guard every hook with
    ``if obs is not None``)."""
    lvl = level()
    if lvl == 0:
        return None
    return ServeObs(now_fn, numeric=lvl >= 2)
