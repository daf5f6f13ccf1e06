"""Heartbeats and the watchdog that reads them.

The port's copy of the JAX package's ``ft/watchdog.py``: ``Heartbeat``,
``Watchdog`` and :func:`plan_elastic_remesh`, the mesh a restart takes
after chips are lost. The loop is host-local and deterministic so tests
can drive it on a fake clock; the serving scheduler feeds it one beat per
tick and reports itself stalled when the beats stop:

* missed heartbeats for longer than ``dead_after``: the host is dead;
* step time above ``straggle_factor`` x the median: a straggler.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

__all__ = ["Heartbeat", "Watchdog", "plan_elastic_remesh"]


@dataclasses.dataclass
class Heartbeat:
    host: int
    step: int
    t: float
    step_time: float


class Watchdog:
    def __init__(self, n_hosts: int, *, dead_after: float = 60.0,
                 straggle_factor: float = 2.0,
                 now_fn: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[int, str], None]] = None):
        self.n_hosts = n_hosts
        self.dead_after = dead_after
        self.straggle_factor = straggle_factor
        self.now = now_fn
        self.last: Dict[int, Heartbeat] = {}
        # called with (host, "dead" | "alive") whenever an evaluation of
        # dead_hosts() flips a host's state: how serving telemetry sees a
        # stall without polling the whole list itself
        self.on_transition = on_transition
        self._was_dead: set = set()

    def beat(self, hb: Heartbeat):
        self.last[hb.host] = hb

    def dead_hosts(self) -> List[int]:
        now = self.now()
        out = []
        for h in range(self.n_hosts):
            hb = self.last.get(h)
            if hb is None or now - hb.t > self.dead_after:
                out.append(h)
        if self.on_transition is not None:
            dead = set(out)
            for h in sorted(dead - self._was_dead):
                self.on_transition(h, "dead")
            for h in sorted(self._was_dead - dead):
                self.on_transition(h, "alive")
            self._was_dead = dead
        return out

    def stragglers(self) -> List[int]:
        times = sorted(hb.step_time for hb in self.last.values())
        if not times:
            return []
        n = len(times)
        # the true median: an even fleet averages the middle pair
        median = (times[n // 2] if n % 2
                  else 0.5 * (times[n // 2 - 1] + times[n // 2]))
        return [h for h, hb in self.last.items()
                if hb.step_time > self.straggle_factor * median]

    def healthy(self) -> bool:
        return not self.dead_hosts()


def plan_elastic_remesh(n_alive_chips: int, *,
                        model_axis: int = 16) -> Optional[dict]:
    """The largest (data, model) mesh the surviving chips hold, the model
    axis kept whole (the TP degree is baked into the weight layout; the
    data degree is elastic), the data axis a power of two so batches
    split evenly; None when fewer chips than ``model_axis`` survive."""
    if n_alive_chips < model_axis:
        return None
    data = n_alive_chips // model_axis
    p2 = 1
    while p2 * 2 <= data:
        p2 *= 2
    return {"mesh_shape": (p2, model_axis), "axes": ("data", "model"),
            "chips": p2 * model_axis,
            "batch_advice": f"global_batch must divide by {p2}"}
