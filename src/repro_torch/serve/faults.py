"""Deterministic wire-page fault injection for the paged serving stack.

The codec's one exception is **NaR**: one reserved word per format
(``FormatSpec.nar_word``, the sign bit alone) that every decode turns
into NaN, poisoning exactly the rows that read it. So a corrupted word in
a wire page is detectable and containable per request: read by the
owning request's attention, it turns that row's logits to NaN, while
every other sequence of the packed batch, reading its own pages, goes on
unchanged. :class:`FaultInjector` corrupts pool pages between scheduler
steps (as HBM or interconnect bit errors would), and the scheduler's
NaN-in-logits check maps the damage back to its owner, fails it with
``status="poisoned"`` and quarantines its pages (``PagePool.quarantine``).

The port's copy of the JAX package's ``serve/faults.py``, with the same
draws: the injector owns a numpy Generator seeded at construction and
makes the reference's calls on it in the reference's order, so a given
(seed, rate, schedule) lands the same faults in both packages. The
reference's cache stacks its layers in one node (``node`` 0, layer
``rep``); the port keeps one dict per layer, and record ``(node, rep)``
is layer ``node * n_layers + rep`` here, so a reference
:class:`FaultRecord` replays into the port's pool (:meth:`replay`). An
integer rate injects that many faults a tick; a fractional remainder one
more with that probability.

Targets: ``"live"`` (default) a position an active sequence has already
written (read, and detected, at the next decode step); ``"in_use"`` any
allocated page, any offset (faults past a sequence's ``pos`` are latent:
the append overwrites them before any read); ``"any"`` any page but the
scratch page.

Kinds: ``"nar"`` (default) writes the format's NaR word (NaN for a float
cache), which the NaN check always catches once read; ``"flip"`` XORs
one random bit of the stored word (of the f32 value for a float cache),
usually a different value and not NaR: silent corruption that the check
does not promise to catch.

The word is written in place (``layers.put_words``): a decode step
replayed from a CUDA graph reads the pool at fixed addresses and sees it.

Env knobs (read by ``Scheduler`` at construction, :func:`injector_from_env`):
``REPRO_FAULT_RATE`` (faults a tick; 0/unset: off), ``REPRO_FAULT_SEED``
(default 0), ``REPRO_FAULT_KIND`` (``nar``/``flip``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bitops import carrier
from repro_torch.models.layers import put_words

__all__ = ["FaultInjector", "FaultRecord", "injector_from_env",
           "FAULT_RATE_ENV", "FAULT_SEED_ENV", "FAULT_KIND_ENV"]

FAULT_RATE_ENV = "REPRO_FAULT_RATE"
FAULT_SEED_ENV = "REPRO_FAULT_SEED"
FAULT_KIND_ENV = "REPRO_FAULT_KIND"


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """One injected fault (``FaultInjector.injected``), field for field
    the JAX package's record."""
    tick: int                       # scheduler tick the fault landed on
    slot: int                       # decode slot targeted (-1: page mode)
    page: int                       # pool page corrupted
    node: int                       # the reference's stacked layer node
    key: str                        # "k" | "v"
    rep: int                        # layer within the node
    offset: Tuple[int, int, int]    # (pos-in-page, kv head, element)
    kind: str                       # "nar" | "flip"


def _carried(word: int, n: int, dtype) -> torch.Tensor:
    """An n-bit word as a 0-d tensor of its carrier dtype (uint16 words
    travel as int16)."""
    if n == 16 and word >= 1 << 15:
        word -= 1 << 16
    return torch.tensor(word, dtype=dtype)


class FaultInjector:
    """Seeded corruption of pool pages between scheduler steps.

    ``rate`` is faults per :meth:`step` (the scheduler calls it once a
    tick); ``max_faults`` caps the total. ``injected`` records every
    fault; ``faulted_pages()`` is the set of pages ever corrupted."""

    def __init__(self, pool, *, rate: float = 1.0, seed: int = 0,
                 kind: str = "nar", target: str = "live",
                 max_faults: Optional[int] = None):
        if kind not in ("nar", "flip"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if target not in ("live", "in_use", "any"):
            raise ValueError(f"unknown fault target {target!r}")
        if rate < 0:
            raise ValueError(f"fault rate must be >= 0, got {rate}")
        self.pool = pool
        self.rate = float(rate)
        self.seed = int(seed)
        self.kind = kind
        self.target = target
        self.max_faults = max_faults
        self._rng = np.random.default_rng(seed)
        self.injected: List[FaultRecord] = []
        # observer(record) fires on every injection (the scheduler wires
        # it to its trace); it never takes part in choosing a target
        self.observer: Optional[Callable[[FaultRecord], None]] = None

    def faulted_pages(self) -> set:
        return {r.page for r in self.injected}

    def _pick_site(self):
        """(slot, page, pos-in-page), or None when there is no target."""
        pool, rng = self.pool, self._rng
        ps = pool.page_size
        if self.target == "live":
            live = [s for s in range(pool.batch) if pool.pos[s] > 0]
            if not live:
                return None
            slot = int(live[rng.integers(len(live))])
            pi = int(rng.integers(int(pool.pos[slot])))
            return slot, int(pool.table[slot, pi // ps]), pi % ps
        if self.target == "in_use":
            pages = sorted(pool._refs)
            if not pages:
                return None
            return -1, int(pages[rng.integers(len(pages))]), \
                int(rng.integers(ps))
        return -1, int(rng.integers(1, pool.num_pages)), \
            int(rng.integers(ps))

    def _layer(self, node: int, rep: int) -> int:
        return node * len(self.pool.cache) + rep

    def _write(self, rec: FaultRecord, word=None) -> None:
        """Write ``rec``'s corruption into the pool, in place: the NaR
        word (NaN for a float cache), or ``word`` (a flip)."""
        arr = self.pool.cache[self._layer(rec.node, rec.rep)][rec.key]
        idx = (rec.page,) + tuple(rec.offset)
        if word is None:
            spec = self.pool.spec
            if spec.is_identity:
                word = torch.tensor(float("nan"), dtype=arr.dtype)
            else:
                word = _carried(spec.nar_word, spec.n, carrier(arr).dtype)
        put_words(arr, idx, word.to(arr.device))

    def _corrupt(self, tick: int, slot: int, page: int, pi: int
                 ) -> FaultRecord:
        pool, rng = self.pool, self._rng
        n_layers = len(pool.cache)
        # the reference's draws, in its order: node (one stacked node),
        # key, layer within the node, head, element
        node = int(rng.integers(1))
        key = "k" if rng.integers(2) == 0 else "v"
        arr = pool.cache[0][key]            # [num_pages, ps, Hkv, hd]
        rep = int(rng.integers(n_layers))
        head = int(rng.integers(arr.shape[2]))
        elem = int(rng.integers(arr.shape[3]))
        rec = FaultRecord(tick=tick, slot=slot, page=page, node=node,
                          key=key, rep=rep, offset=(pi, head, elem),
                          kind=self.kind)
        word = None
        if self.kind == "flip":
            arr = pool.cache[self._layer(node, rep)][key]
            old = carrier(arr)[page, pi, head, elem].cpu()
            if pool.spec.is_identity:
                bits = old.to(torch.float32).view(torch.int32)
                bits = bits ^ (1 << int(rng.integers(32)))
                word = bits.view(torch.float32).to(arr.dtype)
            else:
                n = pool.spec.n
                w = (int(old) & ((1 << n) - 1)) ^ (1 << int(rng.integers(n)))
                word = _carried(w, n, carrier(arr).dtype)
        self._write(rec, word)
        self.injected.append(rec)
        if self.observer is not None:
            self.observer(rec)
        return rec

    def replay(self, rec: FaultRecord) -> None:
        """Write a NaR record (the port's or the JAX package's) into the
        pool: the same page, layer, K or V, and element."""
        if rec.kind != "nar":
            raise ValueError("only NaR records replay (a flip depends on "
                             "the word it found)")
        self._write(rec)

    def step(self, tick: int) -> List[FaultRecord]:
        """Inject this tick's faults into the pool's device pages: the
        integer part of ``rate`` always, the fraction as one more with
        that probability. Returns this call's records."""
        n = int(self.rate)
        frac = self.rate - n
        if frac > 0 and self._rng.random() < frac:
            n += 1
        out: List[FaultRecord] = []
        for _ in range(n):
            if (self.max_faults is not None
                    and len(self.injected) >= self.max_faults):
                break
            site = self._pick_site()
            if site is None:
                continue
            out.append(self._corrupt(tick, *site))
        return out


def injector_from_env(pool) -> Optional[FaultInjector]:
    """An injector from ``REPRO_FAULT_RATE``/``_SEED``/``_KIND``, or
    ``None`` when the rate is unset or 0 (the default)."""
    rate = float(os.environ.get(FAULT_RATE_ENV) or 0.0)
    if rate <= 0:
        return None
    return FaultInjector(
        pool, rate=rate,
        seed=int(os.environ.get(FAULT_SEED_ENV) or 0),
        kind=os.environ.get(FAULT_KIND_ENV) or "nar")
