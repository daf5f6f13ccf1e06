"""Radix-tree prefix cache over the paged takum-wire KV pool.

System prompts and few-shot prefixes repeat across requests. Because
the :class:`repro_torch.serve.paged.PagePool` stores KV in wire words, a
shared page costs n/32 of the f32 bytes — the codec's density win
compounds into cross-request deduplication: one takum8 page of a shared
system prompt serves every request that starts with it, at 1/4 the HBM
of an f32 page that would itself be stored once per request without
this cache.

Granularity is a **full page**: the tree node at depth ``d`` is keyed
by the ``d``-th ``page_size``-token chunk of the prompt, and holds the
pool page whose KV encodes exactly those positions. That is sound
because the serving path keeps prompts at *absolute* positions ``[0,
plen)`` (no left-padding) and KV words are encoded post-RoPE — page
``d``'s contents are a pure function of tokens ``[0, (d+1)*ps)``, which
is precisely the radix path to the node.

Ownership: the tree holds **one pool reference per node**
(``pool.ref``), on top of whatever block tables also reference the
page. Pages therefore survive their sequences (`tree retention`) and
are returned to the free list only when evicted (LRU, leaves first) or
:meth:`PrefixCache.clear`-ed. ``PageStats.shared_pages`` counts pages
with more than one owner; ``hbm_bytes`` never double-counts them —
capacity math credits the dedup.

Copy-on-write: sharing is read-only. A request whose prompt *fully*
matches cached pages still needs the logits of its last prompt token,
so the page holding that token is never served purely from cache — the
planner carves it out (``cow_src``), the scheduler re-prefills that one
page's tail and scatters it into a freshly allocated private page.
"Divergence copies exactly one page"; the shared original is untouched.
A prompt that diverges *mid-page* simply ends the radix match — there
is nothing to copy, the divergent page was never shared.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache", "PrefixPlan"]


@dataclasses.dataclass
class _Node:
    """One radix-tree node: a page keyed by its page-size token chunk."""
    chunk: Tuple[int, ...]
    page: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = \
        dataclasses.field(default_factory=dict)
    tick: int = 0


@dataclasses.dataclass(frozen=True)
class PrefixPlan:
    """Admission plan for one prompt against the tree (pure — computed
    by :meth:`PrefixCache.plan` without taking any references).

    ``shared``: cached pages the request will reference in place (its
    block table head). ``cow_src`` is the carved-out full-hit page (see
    module docstring) whose tail must be recomputed into a private copy
    — ``None`` unless the whole prompt matched. ``suffix_start`` is the
    first position prefill actually computes; everything before it is a
    prefix hit (``hit_tokens == suffix_start``).
    """
    shared: Tuple[int, ...]
    cow_src: Optional[int]
    suffix_start: int

    @property
    def hit_tokens(self) -> int:
        return self.suffix_start


class PrefixCache:
    """Page-granular radix tree over a :class:`PagePool`.

    The scheduler drives it with three calls: :meth:`plan` at admission
    (what can be shared?), :meth:`acquire` to take references on the
    shared pages, and :meth:`insert` after prefill to donate the new
    request's full prompt pages back to the tree. :meth:`evict_one`
    (LRU leaf) frees tree-held pages under page pressure, and
    :meth:`evict_pages` drops quarantined pages with their subtrees.
    """

    def __init__(self, pool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._nodes = 0
        self._ticks = itertools.count()
        # monotone tree-traffic counters (the hit/miss split tells a cold
        # cache from a disabled one)
        self.lookups = 0          # plan() calls
        self.hits = 0             # plans that shared at least one page
        self.hit_tokens = 0       # prompt positions served from the tree
        self.nodes_inserted = 0   # nodes ever donated (insert)
        self.nodes_evicted = 0    # nodes ever dropped (LRU)

    # -- lookup / planning -------------------------------------------------

    def _chunks(self, prompt: Sequence[int]):
        ps = self.page_size
        for i in range(0, len(prompt) - len(prompt) % ps, ps):
            yield tuple(prompt[i:i + ps])

    def _walk(self, prompt: Sequence[int]) -> List[_Node]:
        path: List[_Node] = []
        children = self._root
        for chunk in self._chunks(prompt):
            node = children.get(chunk)
            if node is None:
                break
            path.append(node)
            children = node.children
        return path

    def plan(self, prompt: Sequence[int]) -> PrefixPlan:
        """Longest-prefix match at page granularity, with the last
        prompt token carved out of the shared span (its logits must be
        computed, so its page is re-prefilled — COW on a full hit)."""
        path = self._walk(prompt)
        matched = len(path)
        plen = len(prompt)
        cow_src = None
        if matched and matched * self.page_size >= plen:
            # full hit: every prompt page is cached. Share all but the
            # last; recompute the last page from position plen - 1 so
            # the sampler gets its logits, into a private copy.
            cow_src = path[-1].page
            path = path[:-1]
            matched -= 1
            suffix_start = plen - 1
        else:
            suffix_start = matched * self.page_size
        plan = PrefixPlan(shared=tuple(n.page for n in path),
                          cow_src=cow_src, suffix_start=suffix_start)
        self.lookups += 1
        if plan.hit_tokens:
            self.hits += 1
            self.hit_tokens += plan.hit_tokens
        return plan

    def acquire(self, prompt: Sequence[int], plan: PrefixPlan) -> None:
        """Reference ``plan.shared`` for a new block table and bump the
        matched path's LRU ticks (an acquired path is hot — eviction
        starts elsewhere)."""
        path = self._walk(prompt)[:len(plan.shared)]
        tick = next(self._ticks)
        for node in path:
            self.pool.ref(node.page)
            node.tick = tick

    # -- insertion ---------------------------------------------------------

    def insert(self, prompt: Sequence[int],
               pages: Sequence[int]) -> int:
        """Donate a freshly prefilled request's full prompt pages to the
        tree: ``pages[d]`` must be the pool page holding prompt chunk
        ``d`` (the request's block-table head). Existing nodes are kept
        (first writer wins — a racing duplicate prefill donates nothing
        and its pages stay private); each *new* node takes one pool
        reference. Returns the number of nodes created."""
        children = self._root
        parent: Optional[_Node] = None
        created = 0
        tick = next(self._ticks)
        for d, chunk in enumerate(self._chunks(prompt)):
            if d >= len(pages):
                break
            node = children.get(chunk)
            if node is None:
                node = _Node(chunk=chunk, page=int(pages[d]), parent=parent,
                             tick=tick)
                self.pool.ref(node.page)
                children[chunk] = node
                self._nodes += 1
                created += 1
                self.nodes_inserted += 1
            else:
                node.tick = tick
            children = node.children
            parent = node
        return created

    # -- eviction ----------------------------------------------------------

    def _leaves(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def evict_one(self) -> bool:
        """Drop the least-recently-used *leaf* (interior nodes are
        pinned by their descendants — a child page's KV attends into its
        parent's positions). The page returns to the free list only if
        the tree was its last owner; evicting a page a live sequence
        still references merely ends its shareability. Returns whether
        a node was evicted."""
        leaf = min(self._leaves(), key=lambda n: (n.tick, n.page),
                   default=None)
        if leaf is None:
            return False
        siblings = leaf.parent.children if leaf.parent else self._root
        del siblings[leaf.chunk]
        self._nodes -= 1
        self.nodes_evicted += 1
        self.pool.unref(leaf.page)
        return True

    def evict_for(self, pages_wanted: int) -> None:
        """Evict LRU leaves until ``pages_wanted`` are free (or the
        tree is empty — the caller re-checks ``pages_free``)."""
        while self.pool.pages_free() < pages_wanted and self.evict_one():
            pass

    def evict_pages(self, pages) -> int:
        """Evict every node holding one of ``pages``, with its whole
        subtree (fault containment: a corrupted shared page, and the pages
        whose KV attends into it, must never serve a later admission);
        each removed node drops its pool reference. Quarantine the pages
        first, so the unrefs retire them. Returns the nodes removed."""
        pages = set(int(p) for p in pages)
        removed = 0

        def _drop_subtree(node: _Node) -> int:
            n = 1
            for child in node.children.values():
                n += _drop_subtree(child)
            self.pool.unref(node.page)
            return n

        stack: List[Tuple[Dict[Tuple[int, ...], _Node], _Node]] = \
            [(self._root, n) for n in self._root.values()]
        while stack:
            siblings, node = stack.pop()
            if node.page in pages:
                del siblings[node.chunk]
                removed += _drop_subtree(node)
            else:
                stack.extend((node.children, c)
                             for c in node.children.values())
        self._nodes -= removed
        self.nodes_evicted += removed
        return removed

    def clear(self) -> None:
        """Evict everything (drain-to-empty: after clear, a pool whose
        sequences have all released shows ``pages_in_use() == 0``)."""
        while self.evict_one():
            pass

    def pages_held(self) -> int:
        """Pages the tree references (one a node)."""
        return self._nodes

    def stats(self) -> Dict[str, int]:
        """Tree-traffic counters + current size, as a plain dict."""
        return {"nodes": self._nodes, "lookups": self.lookups,
                "hits": self.hits, "hit_tokens": self.hit_tokens,
                "nodes_inserted": self.nodes_inserted,
                "nodes_evicted": self.nodes_evicted}
