"""Multi-device serving: the shard plan and the sharded step functions.

:class:`ShardPlan` says how ``ServeEngine`` spreads one model over a
``(data, tensor)`` mesh of ranks; :class:`ShardedSteps` runs the engine's
two paged steps (the prompt chunk and the packed decode step) on this
rank under the plan's TP context (``dist/tp.py``). The reference compiles
one ``jit(shard_map(...))`` that a host-global scheduler drives; the
port runs one process per rank (SPMD at the process level):

* every rank builds the same ``ServeEngine(shard=plan)`` and the same
  scheduler, and is given the same requests; the scheduler is
  deterministic, so every rank takes the same decisions, and the page
  accounting is host-global and equal on every rank, as the reference's;
* each rank holds its shard of the weights and its ``Hkv/tp`` KV heads
  (its ``PagePool`` holds those heads only, its accounting the whole
  pool's); the seams exchange activations through the rings
  (``dist/collectives.py``);
* the logits are replicated after the seams, so sampling (each
  request's own ``torch.Generator``), the greedy token and the NaR
  quarantine's NaN test give the same answers on every rank.

Placement (``tensor`` axis, size ``tp``), as the reference's:

* ``wq``/``wk``/``wv``/``wg``/``w1`` column-sharded on their last dim
  (``dist.sharding.param_spec``): rank r owns query heads ``[r*H/tp,
  (r+1)*H/tp)`` and, GQA groups being contiguous, exactly the matching
  ``Hkv/tp`` KV heads, so attention needs no head traffic. A
  ``WireMatrix``'s words (a plain ``[K, N]`` layout) are sliced by
  columns and made contiguous, since the kernels read rows of stride N;
* ``wo``/``w2`` replicated in ``"gather"`` mode, row-sharded in
  ``"psum"`` mode; embeddings, norms and the unembed replicated. The
  moe family's expert stacks and router are replicated too: the block
  after the attention seam computes on replicated activations.

Cross-rank traffic goes through the ring collectives with optional wire
compression (:data:`COMPRESS_ENV`): the words cross the links, n/32 of
f32, with error-feedback residuals carried per call site in the paged
cache (:meth:`ShardedSteps.ensure_residuals`).
:meth:`ShardPlan.step_interconnect_bytes` is the analytic byte census.

Under a plan of more than one rank the decode step runs eagerly
(``ShardedSteps.graphable``): a hop staged through host memory (gloo)
cannot be captured, and the rings' hop counters (``collectives.transport``)
count in Python, so under a replayed NCCL step they would count the
capture alone. Several ranks on one card must use gloo (NCCL refuses two
ranks of one communicator on one GPU); the NCCL path is for ranks on
cards of their own and has not been run on two cards yet.

A plan of one rank (``ShardPlan()``, the engine's default) needs no mesh:
its context is of size 1, where every seam is the plain matmul, so the
single-device engine runs through the same :class:`ShardedSteps`.

Launch: one process per rank, each with
``torch.distributed.init_process_group`` (``launch/mesh.py``);
``python -m repro_torch.serve.shard_selftest --world N`` spawns N gloo
ranks on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from repro_torch.dist import collectives as coll
from repro_torch.dist import tp as _tp
from repro_torch.dist.sharding import param_spec
from repro_torch.kernels.ops import WireMatrix
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import model
from repro_torch.models.transformer import layer_plan

__all__ = ["ShardPlan", "ShardedSteps", "make_plan", "place_params",
           "COMPRESS_ENV", "DATA", "TENSOR"]

# the mesh's axis names, as the reference's plan's defaults
DATA, TENSOR = "data", "tensor"

# the override: REPRO_SHARD_COMPRESS=0 forces f32 collectives even where
# the plan asks for compression; any other value names the wire format
COMPRESS_ENV = "REPRO_SHARD_COMPRESS"
_OFF = ("0", "off", "none", "")

# the leaf names sharded on the tensor axis (everything else:
# embeddings, norms, biases, expert stacks, stays replicated)
_COL_SHARDED = ("wq", "wk", "wv", "wg", "w1")   # last dim (heads / d_ff)
_ROW_SHARDED = ("wo", "w2")                     # first dim, psum mode only
# the families whose layers have the seams (attention, and an MLP or a
# moe block after the attention seam)
_FAMILIES = ("dense", "moe")


def make_plan(tp: int = 1, dp: int = 1, *, mode: str = "gather",
              compress: Optional[str] = None, env=None) -> "ShardPlan":
    """A plan, honouring :data:`COMPRESS_ENV`: unset, the caller's
    ``compress``; ``0``/``off``/``none``/empty, no compression; any other
    value, that wire format's name."""
    env = os.environ if env is None else env
    raw = env.get(COMPRESS_ENV)
    if raw is not None:
        compress = None if raw.strip().lower() in _OFF else raw.strip()
    return ShardPlan(tp=tp, dp=dp, mode=mode, compress=compress)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How to spread one served model over a ``(data, tensor)`` mesh."""
    tp: int = 1                    # tensor-parallel ranks (KV-head shards)
    dp: int = 1                    # data-parallel replicas (logit rows)
    mode: str = "gather"           # "gather" | "psum"
    compress: Optional[str] = None  # wire format of the collectives

    def __post_init__(self):
        if self.mode not in ("gather", "psum"):
            raise ValueError(f"ShardPlan.mode {self.mode!r}: expected "
                             "'gather' or 'psum'")
        if self.tp < 1 or self.dp < 1:
            raise ValueError(f"ShardPlan tp={self.tp} dp={self.dp}: both "
                             "must be >= 1")
        if self.compress is not None:
            self.wire_spec()  # reject typos before anything is built

    @property
    def size(self) -> int:
        return self.tp * self.dp

    def wire_spec(self):
        """The registry ``FormatSpec`` the collectives compress with (None:
        the uncompressed f32 wire)."""
        if self.compress is None:
            return None
        from repro_torch import formats
        return formats.resolve_wire(self.compress)

    def validate(self, cfg) -> None:
        """Reject, by name, a config the mesh cannot split evenly, and a
        family without the seams."""
        if self.size > 1 and cfg.family not in _FAMILIES:
            raise ValueError(
                f"ShardPlan(tp={self.tp}, dp={self.dp}) serves the "
                f"{' and '.join(_FAMILIES)} families (their attention and "
                f"MLP seams); {cfg.name!r} is {cfg.family!r}")
        for field, val in (("n_heads", cfg.n_heads),
                           ("n_kv_heads", cfg.n_kv_heads),
                           ("d_ff", cfg.d_ff)):
            if val % self.tp:
                raise ValueError(
                    f"ShardPlan(tp={self.tp}) cannot split {field}={val} "
                    f"of {cfg.name!r}: {val} % {self.tp} != 0")

    def build_mesh(self) -> Mesh:
        """This rank's ``(data, tensor)`` mesh of the job's ranks; raises,
        naming how to launch, unless a process group of ``size`` ranks is
        initialised."""
        return make_mesh((self.dp, self.tp), (DATA, TENSOR))

    def device_for(self, device=None) -> torch.device:
        """This rank's device: ``cuda:(rank % device_count)`` unless the
        caller names the CPU or an indexed device."""
        import torch.distributed as dist
        from repro_torch.device import resolve_device
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", dist.get_rank()
                                  % torch.cuda.device_count())
        return device

    def local_cfg(self, cfg):
        """This rank's view of ``cfg``: ``H/tp`` query heads and ``Hkv/tp``
        KV heads (the GQA groups stay contiguous)."""
        if self.tp == 1:
            return cfg
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // self.tp,
                                   n_kv_heads=cfg.n_kv_heads // self.tp)

    def context(self, mesh: Optional[Mesh] = None) -> _tp.TPContext:
        """The TP seams' context on ``mesh`` (groups None without one:
        every hook is then the plain matmul at size 1)."""
        group = (lambda a: None) if mesh is None else mesh.group
        return _tp.TPContext(axis=group(TENSOR), size=self.tp,
                             mode=self.mode, spec=self.wire_spec(),
                             dp_axis=group(DATA), dp=self.dp)

    # -- placement rules ---------------------------------------------------

    def leaf_spec(self, name: str, shape) -> tuple:
        """The placement of one parameter leaf (``name`` its '/'-joined
        path; its last segment picks the rule): the reference's
        ``PartitionSpec`` entries, ``()`` replicated.

        The dim comes from ``dist.sharding.param_spec``, the rules of the
        training placement, but only the projections serving shards are
        placed; everything else is replicated."""
        leaf = name.rsplit("/", 1)[-1]
        if self.tp == 1:
            return ()
        if leaf in _ROW_SHARDED and self.mode == "gather":
            return ()  # replicated: every rank multiplies the gathered acts
        if leaf not in _COL_SHARDED + _ROW_SHARDED:
            return ()  # embeddings / norms / biases stay replicated
        return param_spec(name, tuple(shape),
                          rules={"ff": (TENSOR,), "batch": None},
                          axis_sizes={TENSOR: self.tp})

    # -- byte accounting ---------------------------------------------------

    def shard_pool_bytes(self, pool) -> int:
        """A rank's device bytes of the paged pool: the KV head dim is
        sharded, so each rank holds ``1/tp`` of ``pool.hbm_bytes()`` (the
        whole pool's, which the engine's pool reports under a plan too)."""
        return pool.hbm_bytes() // self.tp

    def step_interconnect_bytes(self, cfg, batch: int) -> int:
        """The bytes a decode step moves across the mesh (summed over the
        links), from the rings' hop counts.

        gather mode: a rank's activation chunk travels ``tp - 1`` hops a
        seam; psum mode: reduce-scatter and all-gather of the ``d_model``
        partials (``2 (tp-1) G`` in all). The DP logit gather adds
        ``(dp-1) * batch * vocab_padded`` elements. Every element is
        ``wire_spec().bytes_per_elem(f32)`` wide (4 uncompressed)."""
        from repro_torch.models.layers import padded_vocab
        per = coll.hop_bytes(self.wire_spec())
        n_layers = sum(len(pat) * n_rep for pat, n_rep in layer_plan(cfg))
        elems = 0
        if self.tp > 1:
            if self.mode == "gather":
                cols = cfg.n_heads * cfg.hd + cfg.d_ff
                elems += n_layers * (self.tp - 1) * batch * cols
            else:
                elems += n_layers * 2 * 2 * (self.tp - 1) * batch \
                    * cfg.d_model
        if self.dp > 1 and batch % self.dp == 0:
            elems += (self.dp - 1) * batch * padded_vocab(cfg.vocab)
        return int(elems * per)

    def describe(self, cfg=None, batch: Optional[int] = None) -> dict:
        """A plain dict of the plan for config audits and traces; with
        ``cfg`` and ``batch``, the step's interconnect bytes too."""
        spec = self.wire_spec()
        out = {"tp": self.tp, "dp": self.dp, "mode": self.mode,
               "compress": None if spec is None else spec.name,
               "devices": self.size}
        if cfg is not None and batch is not None:
            out["interconnect_bytes_per_step"] = \
                self.step_interconnect_bytes(cfg, batch)
        return out


# -- placing the weights ----------------------------------------------------


def _full_size(leaf: str, cfg) -> Optional[int]:
    """The size of a sharded projection's sharded dim in the whole model."""
    heads = {"wq": cfg.n_heads, "wo": cfg.n_heads, "wk": cfg.n_kv_heads,
             "wv": cfg.n_kv_heads}
    if leaf in heads:
        return heads[leaf] * cfg.hd
    return cfg.d_ff if leaf in ("wg", "w1", "w2") else None


def _slice(t: torch.Tensor, dim: int, parts: int, r: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, r * n, n).contiguous()


def place_params(params, plan: ShardPlan, mesh: Mesh, cfg=None):
    """This rank's parameters: each leaf that ``plan.leaf_spec`` shards is
    sliced to the rank's part (a ``WireMatrix``'s words by the same rule),
    the rest kept. With ``cfg``, a leaf already of the rank's size is kept
    as it is: a rank may build its own slices a layer at a time (so no
    rank holds the whole model) and hand them in."""
    r = mesh.coord(TENSOR)

    def place(path, leaf):
        if isinstance(leaf, dict):
            return {k: place(path + (str(k),), v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(place(path + (str(i),), v)
                              for i, v in enumerate(leaf))
        if not isinstance(leaf, (torch.Tensor, WireMatrix)):
            return leaf
        spec = plan.leaf_spec("/".join(path), tuple(leaf.shape))
        dims = [d for d, a in enumerate(spec) if a is not None]
        if not dims:
            return leaf
        (dim,) = dims
        full = None if cfg is None else _full_size(path[-1], cfg)
        if full is not None and leaf.shape[dim] == full // plan.tp:
            return leaf
        if full is not None and leaf.shape[dim] != full:
            raise ValueError(f"place_params: {'/'.join(path)} has "
                             f"{leaf.shape[dim]} along dim {dim}, neither "
                             f"{full} nor its 1/{plan.tp}")
        if isinstance(leaf, WireMatrix):
            return WireMatrix(_slice(leaf.words, dim, plan.tp, r),
                              fmt=leaf.spec)
        return _slice(leaf, dim, plan.tp, r)

    return place((), params)


# -- the sharded step functions ---------------------------------------------


class ShardedSteps:
    """The engine's prompt-chunk and decode steps on this rank: the
    model at the plan's local config under its TP context. The steps
    update the caches in place, as the unsharded ones do; the scheduler
    above them cannot tell the mesh is there. A plan of one rank builds
    no mesh (``mesh`` None): its steps are the model's own."""

    def __init__(self, plan: ShardPlan, cfg):
        plan.validate(cfg)
        self.plan = plan
        self.cfg = cfg
        self.mesh = plan.build_mesh() if plan.size > 1 else None
        self.local_cfg = plan.local_cfg(cfg)
        self.ctx = plan.context(self.mesh)

    @property
    def graphable(self) -> bool:
        """Whether the decode step may be captured in a CUDA graph: at one
        rank only (see the module docstring)."""
        return self.plan.size == 1

    def active(self):
        """The plan's TP context, bound for a model call."""
        return _tp.active(self.ctx)

    # residuals -------------------------------------------------------------

    def _residual_shapes(self, batch: int):
        cfg, plan = self.cfg, self.plan
        if plan.mode == "gather":
            co = cfg.n_heads * cfg.hd // plan.tp
            cm = cfg.d_ff // plan.tp
        else:
            co = cm = cfg.d_model
        return {"tp_res_o": (1, batch, 1, co), "tp_res_m": (1, batch, 1, cm)}

    def ensure_residuals(self, cache) -> None:
        """Put zero error-feedback leaves into every paged attention node
        (in place, once). Only when compressing: exact collectives need no
        feedback."""
        if self.plan.wire_spec() is None or self.plan.tp == 1:
            return
        nodes = [node for node in cache
                 if isinstance(node, dict) and "table" in node]
        if not nodes or "tp_res_o" in nodes[0]:
            return
        table = nodes[0]["table"]
        shapes = self._residual_shapes(table.shape[0])
        for node in nodes:
            for key, shp in shapes.items():
                node[key] = torch.zeros(shp, dtype=torch.float32,
                                        device=table.device)

    # steps -------------------------------------------------------------------

    def prefill_chunk(self, params, tokens, cache, pos, last_idx):
        with self.active():
            return model.prefill_chunk(params, tokens, self.local_cfg, cache,
                                       pos=pos, last_idx=last_idx)

    def step_paged(self, params, tok, cache, pos):
        self.ensure_residuals(cache)
        with self.active():
            return model.decode_step(params, tok, self.local_cfg, cache,
                                     pos=pos)
