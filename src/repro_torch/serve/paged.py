"""Paged takum-wire KV pool: free-list allocator and per-slot block tables
over the pooled cache of ``transformer.init_paged_cache``.

The pool owns one ``[num_pages, page_size, Hkv, hd]`` word tensor per
layer for K and for V and hands out *pages* of ``page_size`` positions.
A sequence's pages are glued together by its row of the block table
(``[batch_slots, max_pages]`` int32), which the paged attention kernel
reads. Conventions, as in the JAX package:

* page 0 is the reserved scratch page idle decode slots point at;
* the allocator is host-side, strict and refcounted (``alloc`` at
  refcount 1, ``ref`` adds an owner, ``unref`` drops one; the last unref
  frees). Misuse raises :class:`PagePoolError`;
* a quarantined page (corrupted words, ``quarantine``) never rejoins the
  free list until ``release_quarantined``;
* recycled pages are not zeroed: the causal mask excludes positions past
  a sequence's ``pos``;
* the host mirrors of ``table``/``pos``/``start`` are copied into the
  device cache's tensors by :meth:`push_tables` when the active set
  changes (in place: a captured decode step reads them at fixed
  addresses); the decode step advances the device ``pos`` itself.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import formats
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitops import carrier
from repro_torch.models import model
from repro_torch.models.layers import DTYPES, put_words

__all__ = ["PagePool", "PagePoolError", "AdmissionError", "PageStats",
           "pages_for"]


class PagePoolError(RuntimeError):
    """Allocator misuse: double free, foreign page, over-allocation."""


class AdmissionError(PagePoolError):
    """A request can never be admitted under the pool's page budget."""


def pages_for(positions: int, page_size: int) -> int:
    """Pages needed to hold ``positions`` KV positions."""
    return -(-positions // page_size)


@dataclasses.dataclass(frozen=True)
class PageStats:
    """One snapshot of the allocator (``PagePool.stats()``)."""
    num_pages: int          # total pages, scratch page included
    page_size: int
    free: int
    in_use: int             # unique pages with refcount >= 1
    peak_in_use: int
    hbm_bytes: int          # whole pool, all layers, K and V
    shared_pages: int       # pages with refcount > 1 (prefix dedup)
    prefix_hit_tokens: int  # prompt tokens served from shared pages
    quarantined: int        # pages pulled out of circulation


class PagePool:
    """Free-list page allocator and block tables over the pooled KV cache.

    ``batch`` is the decode-batch width (scheduler slots), ``max_pages``
    the block-table width. With ``alloc_device=False`` no tensors are
    built and only the allocator and its accounting run. ``cache_cfg``
    (default ``cfg``) is the config whose KV heads the device tensors
    hold: a rank's ``Hkv/tp`` under a shard plan, while the accounting
    (``hbm_bytes``, ``stats``) stays the whole pool's, host-global as
    in the reference."""

    def __init__(self, cfg: ModelConfig, *, batch: int, num_pages: int,
                 page_size: int, max_pages: int, device=None, dtype=None,
                 alloc_device: bool = True,
                 cache_cfg: Optional[ModelConfig] = None):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                             f"reserved scratch page), got {num_pages}")
        if page_size < 8 or page_size % 8:
            raise ValueError(f"page_size must be a positive multiple of "
                             f"8, got {page_size}")
        self.cfg = cfg
        self.spec = formats.resolve(cfg.kv_quant)
        self.batch = batch
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages = max_pages
        self._dtype = dtype
        # LIFO free list: hot pages get reused first (page 0 reserved)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._quarantined: set = set()
        self._peak = 0
        self._prefix_hit_tokens = 0
        self.table = np.zeros((batch, max_pages), np.int32)
        self.pos = np.zeros((batch,), np.int32)
        self.start = np.zeros((batch,), np.int32)
        self.cache = None
        if alloc_device:
            self.cache = model.init_paged_cache(
                cache_cfg or cfg, batch, num_pages, page_size, max_pages,
                device=device, dtype=dtype)

    # -- allocator ---------------------------------------------------------

    def pages_free(self) -> int:
        return len(self._free)

    def pages_in_use(self) -> int:
        return len(self._refs)

    def peak_pages_in_use(self) -> int:
        return self._peak

    def shared_pages(self) -> int:
        return sum(1 for c in self._refs.values() if c > 1)

    def refcount(self, page: int) -> int:
        """Owners of ``page`` (0: free)."""
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Tuple[int, ...]:
        """Take ``n`` pages off the free list at refcount 1 (strict)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PagePoolError(
                f"page pool exhausted: requested {n} pages with "
                f"{len(self._free)} free (budget {self.num_pages - 1} x "
                f"{self.page_size} {self.spec.name} KV positions)")
        pages = tuple(self._free.pop() for _ in range(n))
        for p in pages:
            self._refs[p] = 1
        self._peak = max(self._peak, len(self._refs))
        return pages

    def ref(self, page: int) -> None:
        """Add an owner to an allocated page."""
        if page not in self._refs:
            raise PagePoolError(f"ref of page {page} which is not allocated")
        self._refs[page] += 1

    def unref(self, page: int) -> None:
        """Drop one owner; the last owner's unref frees the page."""
        if page not in self._refs:
            raise PagePoolError(f"free of page {page} which is not allocated "
                                "(double free, scratch page, or foreign id)")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            # a quarantined page never returns to the free list
            if page not in self._quarantined:
                self._free.append(page)

    def free(self, pages: Sequence[int]) -> None:
        """Unref each page."""
        for p in pages:
            self.unref(p)

    def note_prefix_hits(self, n_tokens: int) -> None:
        self._prefix_hit_tokens += int(n_tokens)

    # -- quarantine (fault containment) ------------------------------------

    def quarantine(self, page: int) -> None:
        """Pull ``page`` out of circulation until
        :meth:`release_quarantined`: a free page leaves the free list now,
        an allocated one retires at its last ``unref``. Idempotent."""
        if not 0 < page < self.num_pages:
            raise PagePoolError(
                f"quarantine of page {page}: not a poolable page id "
                f"(scratch page 0 and ids >= {self.num_pages} excluded)")
        if page in self._quarantined:
            return
        self._quarantined.add(page)
        if page in self._free:
            self._free.remove(page)

    def pages_quarantined(self) -> int:
        return len(self._quarantined)

    def quarantined_pages(self) -> frozenset:
        return frozenset(self._quarantined)

    def release_quarantined(self) -> int:
        """Return the quarantined pages no one owns to the free list (a
        new owner writes a page from its position 0 before reading it);
        pages still referenced stay quarantined. Returns the count."""
        released = [p for p in sorted(self._quarantined)
                    if p not in self._refs]
        for p in released:
            self._quarantined.discard(p)
            self._free.append(p)
        return len(released)

    # -- memory accounting -------------------------------------------------

    def page_hbm_bytes(self) -> int:
        """Bytes one page costs across all layers, K and V."""
        cfg = self.cfg
        dtype = self._dtype or DTYPES[cfg.dtype]
        return (2 * self.page_size * cfg.n_kv_heads * cfg.hd * cfg.n_layers
                * self.spec.bytes_per_elem(dtype))

    def hbm_bytes(self) -> int:
        return self.num_pages * self.page_hbm_bytes()

    def stats(self) -> PageStats:
        return PageStats(num_pages=self.num_pages, page_size=self.page_size,
                         free=self.pages_free(), in_use=self.pages_in_use(),
                         peak_in_use=self._peak, hbm_bytes=self.hbm_bytes(),
                         shared_pages=self.shared_pages(),
                         prefix_hit_tokens=self._prefix_hit_tokens,
                         quarantined=self.pages_quarantined())

    def scan_nar(self, pages: Optional[Sequence[int]] = None) -> int:
        """NaR words stored in ``pages`` (default: every allocated page),
        all layers, K and V (NaN for a float cache): the pool's health
        scan, one torch reduction a layer and one read back. It runs
        between steps, never inside a captured step. Positions past a
        sequence's ``pos`` may hold stale words, so the count bounds the
        live corruption from above; a count that rises while the
        allocated set stands still is the signal."""
        self._require_cache()
        ids = (sorted(self._refs) if pages is None
               else sorted({int(p) for p in pages}))
        if not ids:
            return 0
        dev = self.cache[0]["k"].device
        idx = torch.as_tensor(ids, dtype=torch.long, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        nar = self.spec.nar_word
        if nar is not None and self.spec.n == 16:   # int16 carriers
            nar -= 1 << 16
        for layer in self.cache:
            for key in ("k", "v"):
                words = carrier(layer[key])[idx]
                if self.spec.is_identity:
                    total += torch.isnan(words).sum()
                else:
                    total += (words == nar).sum()
        return int(total)

    # -- block tables ------------------------------------------------------

    def assign(self, slot: int, pages: Sequence[int], *, pos: int,
               start: int = 0) -> None:
        """Point decode slot ``slot`` at ``pages`` from position ``pos``."""
        self.table[slot] = 0
        self.table[slot, :len(pages)] = pages
        self.pos[slot] = pos
        self.start[slot] = start

    def clear(self, slot: int) -> None:
        """Idle a slot: scratch-page table row, pos/start 0."""
        self.table[slot] = 0
        self.pos[slot] = 0
        self.start[slot] = 0

    def advance(self, slots: Sequence[int]) -> None:
        """Mirror one decode step on the host for the active slots."""
        for s in slots:
            self.pos[s] += 1

    # -- device-cache plumbing ---------------------------------------------

    def _require_cache(self):
        if self.cache is None:
            raise PagePoolError("pool built with alloc_device=False has no "
                                "device cache")

    def push_tables(self) -> None:
        """Copy the host ``table``/``pos``/``start`` into the device
        tensors every layer's cache shares, in place: the tensors stay
        the same objects (a CUDA graph of the decode step reads them)."""
        self._require_cache()
        first = self.cache[0]
        for key in ("table", "pos", "start"):
            dst = first[key]
            dst.copy_(torch.from_numpy(getattr(self, key)))
            for layer in self.cache[1:]:
                layer[key] = dst

    def scatter_prefill(self, contig_caches, pages: Sequence[int], *,
                        first_page: int = 0) -> None:
        """Copy contiguous pages ``[first_page, first_page + len(pages))``
        of a batch-1 prefilled cache into pool pages ``pages``, every
        layer, K and V (words copied as words)."""
        self._require_cache()
        ps, npg = self.page_size, len(pages)
        if not npg:
            return
        dev = self.cache[0]["k"].device
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=dev)
        lo, hi = first_page * ps, (first_page + npg) * ps
        for pool_l, contig_l in zip(self.cache, contig_caches):
            for key in ("k", "v"):
                src = contig_l[key]
                if src.shape[0] != 1 or src.shape[1] < hi:
                    raise ValueError(
                        f"scatter_prefill expects a batch-1 contiguous "
                        f"cache of at least {hi} positions, got "
                        f"{tuple(src.shape)}")
                tiles = src[0, lo:hi].reshape((npg, ps) + src.shape[2:])
                put_words(pool_l[key], idx, tiles)

    def gather_prefix(self, contig_caches, pages: Sequence[int], *,
                      pos: int) -> None:
        """Copy pool ``pages`` into the head of a batch-1 contiguous cache
        and set its ``pos`` (the prefix-hit seam: suffix chunks prefill on
        top of the shared prefix KV). Bit-exact: words stay words."""
        self._require_cache()
        ps, npg = self.page_size, len(pages)
        dev = self.cache[0]["k"].device
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=dev)
        for pool_l, contig_l in zip(self.cache, contig_caches):
            if npg:
                for key in ("k", "v"):
                    dst = contig_l[key]
                    if dst.shape[0] != 1 or dst.shape[1] < npg * ps:
                        raise ValueError(
                            f"gather_prefix needs a batch-1 contiguous "
                            f"cache of at least {npg * ps} positions, got "
                            f"{tuple(dst.shape)}")
                    span = carrier(pool_l[key])[idx].reshape(
                        (npg * ps,) + dst.shape[2:])
                    carrier(dst)[0, :npg * ps] = span
            contig_l["pos"] = pos
