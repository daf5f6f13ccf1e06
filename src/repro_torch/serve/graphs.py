"""The packed decode step, replayed from a CUDA graph.

The port's counterpart of the reference's ``jax.jit(_step_paged)``
(``src/repro/serve/engine.py:268,285``): the reference compiles the decode
step once and runs it as one program; the port issues the same step
eagerly from Python, a few hundred kernel launches and the PyTorch ops
between them, each paying its host time. :class:`DecodeStep` captures
``model.decode_step`` over a :class:`~repro_torch.serve.paged.PagePool`
once per (decode batch, table width) with ``torch.cuda.graph``, after one
eager step on the capture stream (which is that call's step), and replays
it for every later step: the step's tokens and positions are copied into
static buffers, the graph runs, and the static logits are returned (valid
until the next step) with the step's ``head`` ``[2, B]`` int64: each row's
greedy token (argmax) and its NaN flag (``isnan(logits).any(-1)``, the
reference's per-row check for a NaR word read by that row's attention),
both computed inside the step, so the scheduler reads tokens and flags in
one copy. A replay costs the kernels' device time and one launch of host
time. Every capture is reported to ``obs.metrics.record_capture`` (the
counterpart of the reference's compile events).

What makes the step replayable: the pool's ``table``/``pos``/``start``
are updated in place (``PagePool.push_tables``), the step advances the
device ``pos`` in place (``pos.add_(1)``, captured with the step, so idle
slots drift exactly as in an eager step), the K/V words are written by the
fused append (``ops.kv_append``) from device indices, and no wrapper
reads a device value back to the host. A step that cannot be captured
raises; there is no fallback to the eager step on the card. Preemption,
cancellation, quarantine and fault injection change only the pool's
words and tables, in place, so they never cause a capture.

The kernel wrappers count their launches in Python, which a replay skips:
the step records each counter's increase while it is captured and adds it
again at every replay, so launch counts read the same under replay as
eagerly.

On the CPU the step runs eagerly; :func:`disable_graphs` (the counterpart
of ``jax.disable_jit()``) makes the card run it eagerly too, for the
harnesses that compare the two. Under a shard plan of more than one rank
(``ServeEngine.graphable`` is false) the step runs eagerly as well
(``serve/shard.py`` says why).
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Dict, List, Tuple

import torch

from repro_torch.obs.metrics import record_capture

__all__ = ["DecodeStep", "disable_graphs", "graphs_enabled", "COUNTERS"]

# every kernel wrapper's launch counter: (module of repro_torch.kernels,
# function, attribute)
COUNTERS = (("takum_codec", "decode", "launches"),
            ("takum_codec", "encode", "launches"),
            ("takum_codec", "kv_append", "launches"),
            ("takum_matmul", "qmatmul", "launches"),
            ("lns_matmul", "lns_matmul", "launches"),
            ("lns_matmul", "lns_matmul", "split_launches"),
            ("takum_attention", "attention", "launches"),
            ("takum_attention", "paged_attention", "launches"),
            ("quantize", "fake_quant", "launches"),
            ("build", "posit8_lut", "launches"))

_EAGER_DEPTH = 0


@contextlib.contextmanager
def disable_graphs():
    """Run every decode step eagerly inside this block, on the card too."""
    global _EAGER_DEPTH
    _EAGER_DEPTH += 1
    try:
        yield
    finally:
        _EAGER_DEPTH -= 1


def graphs_enabled() -> bool:
    return _EAGER_DEPTH == 0


def _counter_objects() -> List[Tuple[object, str]]:
    return [(getattr(importlib.import_module(f"repro_torch.kernels.{m}"), f),
             a) for m, f, a in COUNTERS]


def _read_counters() -> List[int]:
    return [getattr(o, a) for o, a in _counter_objects()]


def _add_counters(values) -> None:
    for (o, a), v in zip(_counter_objects(), values):
        setattr(o, a, getattr(o, a) + v)


class _Captured:
    """One captured step: the graph, its static inputs and logits, and the
    launch counts one step adds."""

    def __init__(self, graph, tok, pos, logits, head, deltas, keep):
        self.graph, self.tok, self.pos, self.logits = graph, tok, pos, logits
        self.head, self.deltas, self.keep = head, deltas, keep


class DecodeStep:
    """``model.decode_step`` over ``pool``'s cache with ``engine``'s
    weights: eager on the CPU or under :func:`disable_graphs`, replayed
    from a CUDA graph otherwise. ``captures``, ``capture_s`` and
    ``replays`` count the graphs captured, the seconds their capture
    took (the eager step before each included) and the replays."""

    def __init__(self, engine, pool):
        self.engine = engine
        self.pool = pool
        self._graphs: Dict[Tuple[int, ...], _Captured] = {}
        self._stream = None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def _step(self, tok: torch.Tensor, pos: torch.Tensor):
        eng = self.engine
        logits, _ = eng.decode_step(tok, self.pool.cache, pos=pos)
        self.pool.cache[0]["pos"].add_(1)    # shared by every layer
        head = torch.stack([torch.argmax(logits, dim=-1),
                            torch.isnan(logits).any(dim=-1).long()])
        return logits, head

    def __call__(self, tok: torch.Tensor, pos: torch.Tensor):
        """One step for ``tok``/``pos`` ([B, 1] int64, any device):
        (logits [B, V], head [2, B] int64: argmax tokens, NaN flags).
        Under replay they are the graph's static outputs, overwritten by
        the next step."""
        dev = self.engine.device
        if (dev.type != "cuda" or not graphs_enabled()
                or not self.engine.graphable):
            return self._step(tok.to(dev), pos.to(dev))
        key = tuple(tok.shape) + tuple(self.pool.cache[0]["table"].shape)
        cap = self._graphs.get(key)
        if cap is None:
            return self._capture(key, tok, pos)
        cap.tok.copy_(tok)
        cap.pos.copy_(pos)
        cap.graph.replay()
        _add_counters(cap.deltas)
        self.replays += 1
        return cap.logits, cap.head

    def _capture(self, key, tok, pos):
        from repro_torch.kernels import takum_attention
        dev = self.engine.device
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        static_tok = tok.to(dev).clone()
        static_pos = pos.to(dev).clone()
        main = torch.cuda.current_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            logits, head = self._step(static_tok, static_pos)  # this step
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                static_logits, static_head = self._step(static_tok,
                                                        static_pos)
        finally:
            # a failed capture can leave the capture stream current
            torch.cuda.set_stream(main)
        deltas = [b - a for a, b in zip(before, _read_counters())]
        _add_counters([-d for d in deltas])   # capture launched nothing
        main.wait_stream(stream)
        logits.record_stream(main)
        head.record_stream(main)
        # the per-stream counters paged attention's graph nodes point at
        keep = dict(takum_attention._COUNTERS)
        self._graphs[key] = _Captured(graph, static_tok, static_pos,
                                      static_logits, static_head, deltas,
                                      keep)
        seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += seconds
        record_capture(seconds)
        return logits, head
