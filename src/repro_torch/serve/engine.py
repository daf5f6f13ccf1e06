"""Serving engine: continuous batching over the paged takum-wire KV pool,
and the lockstep loop.

``ServeEngine.submit``/``run``/``generate`` stream requests through a
fixed-width decode batch over a :class:`~repro_torch.serve.paged.PagePool`
(``serve/scheduler.py``): admission as pages free up, chunked prefill
interleaved with decode, pages released the step a sequence finishes,
and the reference's failure model (preemption, deadlines, cancellation,
NaR quarantine) and telemetry (``REPRO_OBS``: ``timing``, ``obs``,
``trace_records``). ``generate_lockstep`` is the static-batch loop:
prompts left-padded to one length, one contiguous cache, decode until the
last sequence finishes; ``generate`` takes it at temperature > 0 and
beside pending ``submit``ed requests, as the reference does.
Weights come from :func:`quantize_weights` (``mode="wire"``: every
projection a ``WireMatrix`` of takum, logarithmic-takum or posit words;
``mode="fake"``: float weights rounded to the format's grid by the fused
fake-quant kernel) and the KV cache holds ``cfg.kv_quant`` words
(``takum8``/``takum16``, ``lns-takum8``/``lns-takum16`` or
``posit8``/``posit16``).

The engine runs on ``cuda`` unless it is given ``device="cpu"``, where
every kernel wrapper runs its plain PyTorch version; it never moves to
the CPU on its own. On the card each scheduler replays its decode step
from a CUDA graph (``serve/graphs.py``, the reference's
``jax.jit(_step_paged)``); inside :func:`disable_graphs` it runs the step
eagerly. The lockstep decode step runs eagerly (its contiguous
attention takes the position as a host int). Greedy decoding
(temperature 0) gives the JAX package's tokens; sampled tokens come from
a per-request ``torch.Generator`` (the scheduler) or one generator seeded
from the engine's ``seed`` at each ``generate_lockstep`` call, and match
the reference's distribution, not its threefry draws.

Not in this package yet (``NotImplementedError`` where asked for):
multi-device serving (``shard=``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import formats
from repro_torch.configs.base import ModelConfig, parse_kv_quant
from repro_torch.core import quant
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.takum_attention import DEFAULT_BK
from repro_torch.models import model
from repro_torch.models.layers import DTYPES
from repro_torch.models.transformer import cast_params
from repro_torch.obs import enabled as obs_enabled
from repro_torch.obs.metrics import GLOBAL as METRICS
from repro_torch.serve.graphs import disable_graphs
from repro_torch.serve.paged import pages_for
from repro_torch.serve.scheduler import Scheduler, StreamEvent, sample_rows

__all__ = ["ServeEngine", "quantize_weights", "sample_rows", "disable_graphs",
           "CACHE_SLACK"]

# lockstep cache headroom past prompt + max_new positions: the loop runs
# one step past the EOS break (its append lands past the last token)
CACHE_SLACK = 8

_DEFAULT_SKIP = ("embed", "unembed", "scale", "norm")
# leaves consumed through a plain ``x @ w`` (the only ones wired)
_WIRE_LEAVES = {"wq", "wk", "wv", "wo", "wg", "w1", "w2"}
_PER_TENSOR = quant.QuantSpec(fmt="takum", scale="per_tensor")
# each format's largest finite magnitude (every word decoded once)
_FMT_MAX: dict = {}
# elements of one slice of a stacked (3D) leaf: fake-quant and its absmax
# go a slice of the leading (expert) axis at a time, so a stack's f32
# temporaries stay this small (a kimi-k2 expert stack is 5.6 G elements)
_SLICE = 1 << 26


def _slices(leaf: torch.Tensor):
    """``leaf`` as consecutive slices of its leading axis (3D and up;
    a 2D leaf is one slice)."""
    if leaf.ndim < 3:
        yield slice(None)
        return
    step = max(1, _SLICE // max(1, leaf[0].numel()))
    for i in range(0, leaf.shape[0], step):
        yield slice(i, i + step)


def _absmax(leaf: torch.Tensor) -> torch.Tensor:
    """The f32 max |x| of ``leaf``, a slice at a time."""
    return torch.stack([quant.absmax(leaf[sl].to(torch.float32), _PER_TENSOR)
                        for sl in _slices(leaf)]).max()


def _fake_leaf(spec, leaf: torch.Tensor, scale_exp, in_place: bool):
    """``spec.fake_quant`` of ``leaf`` in its dtype, a slice at a time
    (linear takum with the whole leaf's exponent, or ``scale_exp``);
    written into ``leaf`` itself when ``in_place``."""
    if spec.kind == "linear" and scale_exp is None:
        scale_exp = int(quant.exponent_of(_absmax(leaf)))
    if leaf.ndim < 3 and not in_place:
        return spec.fake_quant(leaf, dtype=leaf.dtype, scale_exp=scale_exp)
    out = leaf if in_place else torch.empty_like(leaf)
    for sl in _slices(leaf):
        out[sl] = spec.fake_quant(leaf[sl], dtype=leaf.dtype,
                                  scale_exp=scale_exp)
    return out


def _format_max(spec) -> float:
    """The largest finite value of a wire format (inf for the identity
    codec)."""
    if spec.is_identity:
        return float("inf")
    if spec.name not in _FMT_MAX:
        from repro_torch.core.bitops import to_words
        words = to_words(torch.arange(2 ** spec.n), spec.word_dtype)
        vals = spec.decode_tile(words, dtype=torch.float32)
        _FMT_MAX[spec.name] = float(torch.where(
            torch.isfinite(vals), vals.abs(), torch.zeros_like(vals)).max())
    return _FMT_MAX[spec.name]


def quantize_weights(params, fmt: str = "takum8", *, mode: str = "fake",
                     skip_substrings=_DEFAULT_SKIP, verbose: bool = True,
                     in_place: bool = False):
    """Quantise a served model's weight matrices to a wire format.

    ``mode="wire"`` replaces every 2D float leaf named ``wq``/``wk``/
    ``wv``/``wo``/``wg``/``w1``/``w2`` by a ``WireMatrix`` of its
    words in ``fmt`` (encoded by the encode kernel on CUDA).
    ``"takum8"``/``"takum16"`` and ``"posit8"``/``"posit16"`` wire the
    projections through the wire-weight matmul; ``"lns-takum8"``/
    ``"lns-takum16"`` through the ell_bar-datapath LNS matmul, which also
    encodes the incoming activations to the LNS grid.

    ``mode="fake"`` (the default) quantises and dequantises in place: the
    model runs on float weights rounded to the format's grid, what
    serving accuracy evaluations use. Every other matrix of ``mode="wire"``
    takes that path too. The rounding is ``FormatSpec.fake_quant``, through
    the fused fake-quant kernel on CUDA; a leaf keeps its dtype. Linear
    takum scales by a power of two per tensor, and a leaf of the
    ``params["layers"]`` list is one slice of the reference's layer stack,
    so its scale is taken over that leaf in every layer (the largest
    absmax), as the reference's over its stacked leaf. Names containing a
    ``skip_substrings`` entry (embeddings, norms) and leaves below 2D stay
    as they are. A stacked (3D) leaf, such as a moe layer's expert stack,
    is rounded a slice of its leading axis at a time; ``in_place`` writes
    the rounded values into the float leaves themselves (the returned tree
    shares them), so a model whose weights fill most of the card is not
    held twice.

    The printed audit counts leaves as the reference's stacked tree
    holds them: a leaf of the ``params["layers"]`` list once, not once
    per layer.

    Under ``REPRO_OBS`` >= 1 the process-wide registry counts the weights
    beyond the format's finite range (``quant.saturated``, of
    ``quant.elems``), the population its grid clamps."""
    if mode not in ("fake", "wire"):
        raise ValueError(f"unknown quantize_weights mode {mode!r}")
    try:
        spec = formats.resolve_wire(fmt)
    except ValueError:
        raise ValueError(f"unknown quantize_weights fmt {fmt!r} (expected "
                         f"one of {', '.join(formats.wire_names())})") from None

    def action(path, leaf) -> str:
        name = "/".join(path)
        if any(s in name for s in skip_substrings):
            return "skipped"
        if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
            return "non_matrix"
        if mode == "wire" and path[-1] in _WIRE_LEAVES \
                and leaf.is_floating_point():
            if leaf.ndim != 2:
                raise ValueError(
                    f"quantize_weights(mode='wire'): {name!r} is on the wire "
                    f"allowlist but has ndim={leaf.ndim}; the port wires 2D "
                    "projections only")
            return "wired"
        return "fake"

    def leaves(path, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(path + (str(k),), v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(path + (str(i),), v)
        else:
            yield path, tree

    # linear takum: one scale per leaf name over the layer stack
    stack_exp = {}
    layers = params.get("layers") if isinstance(params, dict) else None
    if spec.kind == "linear" and isinstance(layers, (list, tuple)):
        absmax = {}
        for path, leaf in leaves(("layers",), layers):
            if action(path, leaf) == "fake":
                m = _absmax(leaf)
                absmax[path[2:]] = torch.maximum(absmax[path[2:]], m) \
                    if path[2:] in absmax else m
        stack_exp = {k: int(quant.exponent_of(m)) for k, m in absmax.items()}

    counts = {"wired": 0, "fake": 0, "skipped": 0, "non_matrix": 0}
    fmax = _format_max(spec) if obs_enabled() else float("inf")

    def visit(path, leaf):
        if isinstance(leaf, dict):
            return {k: visit(path + (str(k),), v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(visit(path + (str(i),), v)
                              for i, v in enumerate(leaf))
        act = action(path, leaf)
        if path[:1] != ("layers",) or path[1:2] == ("0",):
            counts[act] += 1      # a layer-stack leaf counts once
        if (fmax < float("inf") and act in ("wired", "fake")
                and leaf.is_floating_point()):
            METRICS.counter("quant.saturated").inc(
                int((leaf.abs() > fmax).sum()))
            METRICS.counter("quant.elems").inc(leaf.numel())
        if act == "wired":
            return ops.WireMatrix.encode(leaf, fmt=spec)
        if act == "fake":
            key = path[2:] if path[:1] == ("layers",) else None
            return _fake_leaf(spec, leaf, stack_exp.get(key), in_place)
        return leaf

    out = visit((), params)
    if verbose:
        print(f"quantize_weights[{spec.name}/{mode}]: {counts['wired']} "
              f"wired, {counts['fake']} fake-quantised, {counts['skipped']} "
              f"skipped, {counts['non_matrix']} non-matrix")
    return out


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_to_device(v, device) for v in params)
    if isinstance(params, (torch.Tensor, ops.WireMatrix)):
        return params.to(device)
    return params


@dataclasses.dataclass
class ServeEngine:
    params: object
    cfg: ModelConfig
    max_len: int              # per-sequence KV position cap (paged mode)
    temperature: float = 0.0
    eos_id: int = -1          # -1: never stop early
    seed: int = 0
    kv_block: Optional[int] = None    # contiguous attention KV tile
    page_size: Optional[int] = None   # None -> kv_block or 256
    num_pages: Optional[int] = None   # None -> decode_batch full sequences
    decode_batch: int = 8             # packed decode width (slots)
    prefix_cache: bool = True         # radix-tree shared prompt pages
    preempt: bool = True              # preempt low priority under pressure
    now_fn: Optional[Callable[[], float]] = None  # scheduler clock
                                      # (deadlines, watchdog; None: wall)
    shard: Optional[object] = None    # not ported yet: must stay None
    device: Optional[object] = None   # None -> cuda (raises without one)

    def __post_init__(self):
        if self.shard is not None:
            raise NotImplementedError("multi-device serving is not in the "
                                      "port yet")
        parse_kv_quant(self.cfg.kv_quant)   # reject typos up front
        self.device = resolve_device(self.device)
        if self.kv_block:
            self.cfg = dataclasses.replace(self.cfg, kv_block=self.kv_block)
        # place and cast once: the forward's own cast is then a no-op
        self.params = cast_params(_to_device(self.params, self.device),
                                  DTYPES[self.cfg.dtype])
        self._sched: Optional[Scheduler] = None
        self._sched_key = None

    def scheduler(self, *, page_size: Optional[int] = None,
                  num_pages: Optional[int] = None,
                  max_pages: Optional[int] = None) -> Scheduler:
        """The engine's scheduler (built lazily, reused while its sizing
        matches). Defaults: page size = ``kv_block`` or 256, table width
        = ``ceil(max_len / page_size)``, pool = ``decode_batch`` full
        sequences plus the scratch page."""
        if (self._sched is not None and page_size is None
                and num_pages is None and max_pages is None):
            return self._sched
        ps = page_size or self.page_size or self.cfg.kv_block or DEFAULT_BK
        db = self.decode_batch
        mp = max_pages or max(pages_for(self.max_len, ps), 1)
        npg = num_pages or self.num_pages or (db * mp + 1)
        key = (ps, mp, npg, db, self.prefix_cache, self.preempt)
        if self._sched is not None:
            if self._sched_key == key:
                return self._sched
            if self._sched.pending():
                raise RuntimeError("cannot resize the scheduler while "
                                   "requests are pending")
        prev = self._sched
        self._sched = Scheduler(self, page_size=ps, max_pages=mp,
                                num_pages=npg, decode_batch=db,
                                prefix_cache=self.prefix_cache,
                                preempt=self.preempt, now_fn=self.now_fn)
        if prev is not None:
            self._sched.adopt_finished(prev)
            if prev.obs is not None:
                prev.obs.close()      # detach the old capture watcher
        self._sched_key = key
        return self._sched

    def submit(self, prompt: List[int], max_new: int,
               eos_id: Optional[int] = None, *, priority: int = 0,
               temperature: Optional[float] = None, top_p: float = 1.0,
               seed: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Enqueue one request; returns its id for :meth:`run` and
        :meth:`result`. ``priority``: higher admits first (aged; under page
        pressure a strictly higher one may preempt a running one).
        ``deadline_ms``: total-latency bound on the scheduler clock, past
        which the request ends ``"timeout"``."""
        return self.scheduler().submit(prompt, max_new, eos_id=eos_id,
                                       priority=priority,
                                       temperature=temperature, top_p=top_p,
                                       seed=seed, deadline_ms=deadline_ms)

    def cancel(self, rid: int) -> bool:
        """Cancel a request in flight (its pages released, a terminal
        ``"cancelled"`` event); False if it had already ended."""
        return self.scheduler().cancel(rid)

    def status(self, rid: int) -> str:
        return self.scheduler().status(rid)

    def run(self) -> Iterator[StreamEvent]:
        """Serve every submitted request to completion, streaming
        ``StreamEvent(rid, token, done, status)`` per generated token."""
        yield from self.scheduler().run()

    def result(self, rid: int) -> List[int]:
        return self.scheduler().result(rid)

    def forget(self, rid: int) -> None:
        """Drop a request's record (one in flight is cancelled first)."""
        self.scheduler().forget(rid)

    def timing(self, rid: int):
        """The request's :class:`~repro_torch.obs.trace.RequestTiming`
        (queue/TTFT/TBT/total ms on the scheduler clock), with or without
        ``REPRO_OBS``."""
        return self.scheduler().timing(rid)

    @property
    def obs(self):
        """The scheduler's :class:`~repro_torch.obs.ServeObs`, or None (no
        scheduler yet, or ``REPRO_OBS`` off)."""
        return None if self._sched is None else self._sched.obs

    def trace_records(self, meta: Optional[dict] = None) -> List[dict]:
        """The serving trace as JSONL-shaped records (needs
        ``REPRO_OBS`` >= 1)."""
        return self.scheduler().trace_records(meta)

    def generate(self, prompts: List[List[int]],
                 max_new: int) -> List[List[int]]:
        """Prompt + ``max_new`` tokens per prompt. Greedy requests go
        through the scheduler, with the reference engine's pool sizing:
        the page size clamps to the per-sequence cap and the table is wide
        enough for a full-length prompt plus this call's growth. At
        temperature > 0, or while ``submit``ed requests are pending (whose
        stream belongs to their caller), the call runs
        :meth:`generate_lockstep`, as in the reference."""
        if self.temperature != 0.0 or (self._sched is not None
                                       and self._sched.pending()):
            return self.generate_lockstep(prompts, max_new)
        ps = self.page_size or self.cfg.kv_block or DEFAULT_BK
        ps = min(ps, max(8, -(-self.max_len // 8) * 8))
        bucket_max = max(-(-len(p) // ps) * ps for p in prompts)
        cap = max(-(-self.max_len // ps) * ps, bucket_max) + max_new - 1
        mp = pages_for(cap, ps)
        sched = self.scheduler(page_size=ps, max_pages=mp,
                               num_pages=self.num_pages
                               or (self.decode_batch * mp + 1))
        rids = [sched.submit(p, max_new) for p in prompts]
        for _ in sched.run():
            pass
        outs = [sched.result(r) for r in rids]
        for r in rids:
            sched.forget(r)
        return outs

    # -- lockstep (static batch) -------------------------------------------

    def generate_lockstep(self, prompts: List[List[int]],
                          max_new: int) -> List[List[int]]:
        """The static-batch loop: prompts left-padded to one length (each
        row's ``start`` masks its padding), one contiguous cache of
        ``plen + max_new + CACHE_SLACK`` positions (rounded up to the KV
        tile on the card, where the attention kernel runs), a prefill of
        the whole batch, then one decode step a token until every
        sequence has ``max_new`` tokens or its EOS. The host reads each
        step's tokens one step late (step s + 1 is issued before step s's
        tokens are read), so the card never waits on that read; the last
        issued step's append lands in the slack.

        At temperature > 0 tokens are drawn from one ``torch.Generator``
        seeded from ``seed`` at each call: the same distribution as the
        reference's, not its threefry draws (JAX's key schedule has no
        torch counterpart)."""
        cfg = self.cfg
        dev = self.device
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        prompt = np.zeros((b, plen), np.int64)
        start = np.zeros((b,), np.int32)
        for i, p in enumerate(prompts):      # left-pad, last token at end
            prompt[i, plen - len(p):] = p
            start[i] = plen - len(p)
        max_len = plen + max_new + CACHE_SLACK
        if dev.type == "cuda":
            # the kernel reads the cache in KV tiles: a cache of whole
            # tiles needs no padded copy (keys past pos are masked)
            blk = cfg.kv_block or DEFAULT_BK
            max_len = -(-max_len // blk) * blk
        cache = model.init_cache(cfg, b, max_len, device=dev,
                                 start=start if start.any() else None)
        logits, cache = model.prefill(self.params,
                                      torch.from_numpy(prompt).to(dev),
                                      cfg, cache)
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.seed)
        tok = self._lockstep_next(logits, gen)
        out = [list(p) for p in prompts]
        done = np.zeros(b, bool)
        for s in range(max_new):
            # issue step s + 1 before reading step s's tokens back
            logits, cache = model.decode_step(self.params, tok, cfg, cache,
                                              pos=plen + s)
            nxt = self._lockstep_next(logits, gen)
            tok_host = tok[:, 0].tolist()
            for i in range(b):
                if not done[i]:
                    out[i].append(tok_host[i])
            done |= np.asarray(tok_host) == self.eos_id
            if done.all():
                break
            tok = nxt
        return out

    def _lockstep_next(self, logits: torch.Tensor, gen) -> torch.Tensor:
        """[B, V] logits -> the next tokens [B, 1] on the card: argmax, or
        a draw from softmax(logits / temperature)."""
        if gen is None:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits.to(torch.float32)
                              / max(self.temperature, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
