"""Data pipeline: deterministic synthetic LM stream + token-file shards,
host-sharded with straggler-tolerant assignment and background prefetch.

The port's copy of the JAX package's ``data/pipeline.py``: numpy there
too, so the same seed gives the same arrays bit for bit. The train step
moves a batch onto the device.

At 1000+ hosts, two failure modes matter at this layer:
* a *straggling* host starves the global batch -> every shard has a
  BACKUP owner; when the primary does not produce in time, the backup's
  copy (same deterministic content) is used and the step proceeds;
* a *restarted* host must resume mid-epoch -> iterators are stateless
  functions of (seed, step), so resumption is exact from the step index
  in the checkpoint. No data state is checkpointed at all.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "TokenFileDataset", "shard_assignment",
           "Prefetcher", "make_batch_fn"]


class SyntheticLM:
    """Deterministic synthetic LM batches: a mixture of Zipfian unigrams and
    copy/induction spans so that small models show a real learning curve.

    batch_at(step) is a pure function of (seed, step) — exact resume and
    backup-shard reproducibility come for free."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 with_labels: bool = True):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed, self.with_labels = seed, with_labels
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._p = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        t = self.seq_len + 1
        toks = rng.choice(self.vocab, p=self._p,
                          size=(self.batch, t)).astype(np.int32)
        # induction spans: copy a prefix forward so context helps
        span = max(4, t // 8)
        for b in range(self.batch):
            src = rng.integers(0, t - 2 * span)
            dst = rng.integers(src + span, t - span)
            toks[b, dst:dst + span] = toks[b, src:src + span]
        out = {"tokens": toks[:, :-1]}
        if self.with_labels:
            out["labels"] = toks[:, 1:]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class TokenFileDataset:
    """Flat token-file (np.memmap) reader with host-sharded strided windows:
    host h of H reads windows h, h+H, h+2H, ... deterministically."""

    def __init__(self, path: str, seq_len: int, batch: int,
                 host_id: int = 0, num_hosts: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len, self.batch = seq_len, batch
        self.host_id, self.num_hosts = host_id, num_hosts
        self.n_windows = (len(self.tokens) - 1) // seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        out_t = np.empty((self.batch, self.seq_len), np.int32)
        out_l = np.empty((self.batch, self.seq_len), np.int32)
        for i in range(self.batch):
            w = (step * self.batch * self.num_hosts
                 + i * self.num_hosts + self.host_id) % self.n_windows
            s = w * self.seq_len
            out_t[i] = self.tokens[s:s + self.seq_len]
            out_l[i] = self.tokens[s + 1:s + self.seq_len + 1]
        return {"tokens": out_t, "labels": out_l}


def shard_assignment(num_shards: int, num_hosts: int, *,
                     backups: int = 1) -> Dict[int, Dict[str, list]]:
    """shard -> {primary: host, backups: [hosts]} round-robin with offset
    backups (straggler mitigation: a backup regenerates the shard content
    deterministically if the primary is late)."""
    out = {}
    for s in range(num_shards):
        primary = s % num_hosts
        bk = [(primary + 1 + i) % num_hosts for i in range(backups)]
        out[s] = {"primary": primary, "backups": bk}
    return out


class Prefetcher:
    """Background-thread prefetch with a straggler timeout: if the primary
    producer misses the deadline, the batch is regenerated inline from the
    deterministic (seed, step) function — the backup path."""

    def __init__(self, batch_fn, depth: int = 2, timeout_s: float = 30.0):
        self.batch_fn = batch_fn
        self.timeout_s = timeout_s
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = 0
        self.stats = {"timeouts": 0, "produced": 0}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = 0
        while not self._stop.is_set():
            try:
                self.q.put((step, self.batch_fn(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        try:
            step, batch = self.q.get(timeout=self.timeout_s)
            self.stats["produced"] += 1
            if step != self._step:  # producer drifted: regenerate exact
                batch = self.batch_fn(self._step)
        except queue.Empty:  # straggling producer: backup path
            self.stats["timeouts"] += 1
            batch = self.batch_fn(self._step)
        self._step += 1
        return batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def make_batch_fn(dataset):
    return dataset.batch_at
