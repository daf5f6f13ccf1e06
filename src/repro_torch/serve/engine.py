"""Serving engine: continuous batching over the paged takum-wire KV pool.

``ServeEngine.submit``/``run``/``generate`` stream requests through a
fixed-width decode batch over a :class:`~repro_torch.serve.paged.PagePool`
(``serve/scheduler.py``): admission as pages free up, chunked prefill
interleaved with decode, pages released the step a sequence finishes.
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
eagerly. Greedy decoding (temperature 0) gives the JAX
package's tokens; sampled tokens come from a per-request
``torch.Generator`` and match the reference's distribution, not its
threefry draws.

Not in this package yet (``NotImplementedError`` where asked for):
lockstep generation, preemption, deadlines and cancellation, NaR
quarantine, fault injection, tracing, multi-device serving.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import torch

from repro_torch import formats
from repro_torch.configs.base import ModelConfig, parse_kv_quant
from repro_torch.core import quant
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.takum_attention import DEFAULT_BK
from repro_torch.models.layers import DTYPES
from repro_torch.models.transformer import cast_params
from repro_torch.serve.graphs import disable_graphs
from repro_torch.serve.paged import pages_for
from repro_torch.serve.scheduler import Scheduler, StreamEvent, sample_rows

__all__ = ["ServeEngine", "quantize_weights", "sample_rows", "disable_graphs"]

_DEFAULT_SKIP = ("embed", "unembed", "scale", "norm")
# leaves consumed through a plain ``x @ w`` (the only ones wired)
_WIRE_LEAVES = {"wq", "wk", "wv", "wo", "wg", "w1", "w2"}
_PER_TENSOR = quant.QuantSpec(fmt="takum", scale="per_tensor")


def quantize_weights(params, fmt: str = "takum8", *, mode: str = "fake",
                     skip_substrings=_DEFAULT_SKIP, verbose: bool = True):
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
    as they are."""
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
                m = quant.absmax(leaf.to(torch.float32), _PER_TENSOR)
                absmax[path[2:]] = torch.maximum(absmax[path[2:]], m) \
                    if path[2:] in absmax else m
        stack_exp = {k: int(quant.exponent_of(m)) for k, m in absmax.items()}

    counts = {"wired": 0, "fake": 0, "skipped": 0, "non_matrix": 0}

    def visit(path, leaf):
        if isinstance(leaf, dict):
            return {k: visit(path + (str(k),), v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(visit(path + (str(i),), v)
                              for i, v in enumerate(leaf))
        act = action(path, leaf)
        counts[act] += 1
        if act == "wired":
            return ops.WireMatrix.encode(leaf, fmt=spec)
        if act == "fake":
            key = path[2:] if path[:1] == ("layers",) else None
            return spec.fake_quant(leaf, dtype=leaf.dtype,
                                   scale_exp=stack_exp.get(key))
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
    max_len: int              # per-sequence KV position cap
    temperature: float = 0.0
    eos_id: int = -1          # -1: never stop early
    seed: int = 0
    kv_block: Optional[int] = None    # contiguous attention KV tile
    page_size: Optional[int] = None   # None -> kv_block or 256
    num_pages: Optional[int] = None   # None -> decode_batch full sequences
    decode_batch: int = 8             # packed decode width (slots)
    prefix_cache: bool = True         # radix-tree shared prompt pages
    preempt: bool = False             # not ported yet: must stay False
    shard: Optional[object] = None    # not ported yet: must stay None
    device: Optional[object] = None   # None -> cuda (raises without one)

    def __post_init__(self):
        if self.preempt:
            raise NotImplementedError("preemption is not in the port yet")
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
        key = (ps, mp, npg, db, self.prefix_cache)
        if self._sched is not None:
            if self._sched_key == key:
                return self._sched
            if self._sched.pending():
                raise RuntimeError("cannot resize the scheduler while "
                                   "requests are pending")
        prev = self._sched
        self._sched = Scheduler(self, page_size=ps, max_pages=mp,
                                num_pages=npg, decode_batch=db,
                                prefix_cache=self.prefix_cache)
        if prev is not None:
            self._sched.adopt_finished(prev)
        self._sched_key = key
        return self._sched

    def submit(self, prompt: List[int], max_new: int,
               eos_id: Optional[int] = None, *, priority: int = 0,
               temperature: Optional[float] = None, top_p: float = 1.0,
               seed: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Enqueue one request; returns its id for :meth:`run` and
        :meth:`result`."""
        if deadline_ms is not None:
            raise NotImplementedError("deadlines are not in the port yet")
        return self.scheduler().submit(prompt, max_new, eos_id=eos_id,
                                       priority=priority,
                                       temperature=temperature, top_p=top_p,
                                       seed=seed)

    def cancel(self, rid: int) -> bool:
        raise NotImplementedError("cancellation is not in the port yet")

    def status(self, rid: int) -> str:
        return self.scheduler().status(rid)

    def run(self) -> Iterator[StreamEvent]:
        """Serve every submitted request to completion, streaming
        ``StreamEvent(rid, token, done)`` per generated token."""
        yield from self.scheduler().run()

    def result(self, rid: int) -> List[int]:
        return self.scheduler().result(rid)

    def forget(self, rid: int) -> None:
        self.scheduler().forget(rid)

    def generate(self, prompts: List[List[int]],
                 max_new: int) -> List[List[int]]:
        """Prompt + ``max_new`` greedy tokens per prompt, served through
        the scheduler, with the reference engine's pool sizing: the page
        size clamps to the per-sequence cap and the table is wide enough
        for a full-length prompt plus this call's growth."""
        if self.temperature != 0.0:
            raise NotImplementedError("generate at temperature > 0 runs the "
                                      "lockstep loop, not ported yet; use "
                                      "submit/run")
        if self._sched is not None and self._sched.pending():
            raise NotImplementedError("generate beside pending submit()ed "
                                      "requests runs lockstep (not ported)")
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
