"""AdamW and LR schedules, in structured and flat forms.

The port's copy of the JAX package's ``optim/adamw.py``: the same
arithmetic in the same order, in f32 (``torch.optim.AdamW`` applies its
decoupled decay in another order, which rounds differently). The *flat*
form treats the whole parameter set as one vector: AdamW is elementwise,
so flattening is exact; the manual data-parallel step
(``train/trainer.py::make_train_step_manual``, ZeRO-1) updates each
rank's slice of the flat vector. Every update returns new tensors and
leaves its inputs as they were, unless a caller names them as the
flat update's ``out``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "AdamWState", "init_state", "apply_update",
           "flatten_like", "flat_spec", "flat_slice", "unflatten_like",
           "flat_adamw_update", "FLAT_BLOCK",
           "schedule_lr", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # 'cosine' | 'linear' | 'const'
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor            # int32 scalar


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (f32 scalar): linear warmup, then
    cosine, linear or constant decay to ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm * 1.0
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(_f32(math.pi, step.device) * frac))
    else:
        decay = 1.0 - frac
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(_f32(total))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, its norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), norm


def init_state(params) -> AdamWState:
    """Zero moments (f32, each leaf's shape and device), step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _bias_corrections(cfg: AdamWConfig, t: torch.Tensor):
    return (1.0 - torch.pow(_f32(cfg.b1, t.device), t),
            1.0 - torch.pow(_f32(cfg.b2, t.device), t))


def apply_update(params, grads, state: AdamWState, cfg: AdamWConfig
                 ) -> Tuple[Any, AdamWState]:
    """Structured AdamW (grads already averaged and clipped)."""
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step.to(torch.float32))

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype), m, v

    leaves_p, treedef = tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves_p, tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v))]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            AdamWState(tree_unflatten(treedef, [o[1] for o in out]),
                       tree_unflatten(treedef, [o[2] for o in out]), step))


# ---------------------------------------------------------------------------
# Flat (ZeRO-friendly) helpers
# ---------------------------------------------------------------------------

# the elements a flat elementwise pass takes at a time: its temporaries a
# block's (256 MB in f32)
FLAT_BLOCK = 1 << 26


def flat_spec(tree, pad_to: int = 1):
    """:func:`flatten_like`'s unflatten spec, without the vector: (treedef,
    sizes, shapes, dtypes, pad); the vector's length is ``sum(sizes) +
    pad``."""
    leaves, treedef = tree_flatten(tree)
    sizes = [leaf.numel() for leaf in leaves]
    pad = (-sum(sizes)) % pad_to
    return (treedef, sizes, [tuple(leaf.shape) for leaf in leaves],
            [leaf.dtype for leaf in leaves], pad)


def flatten_like(tree, pad_to: int = 1):
    """Concatenate all leaves (f32) into one vector padded to a multiple
    of ``pad_to``. Returns (vector, unflatten spec)."""
    spec = flat_spec(tree, pad_to)
    leaves = tree_leaves(tree)
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    if spec[4]:
        flat = torch.cat([flat, flat.new_zeros(spec[4])])
    return flat, spec


def flat_slice(tree, start: int, length: int) -> torch.Tensor:
    """``flatten_like(tree, pad_to)[0][start:start + length]`` without the
    whole vector: the leaves' parts in that range (f32), then the padding's
    zeros, in a new tensor (never a view of a leaf: the ZeRO-1 step
    updates it in place)."""
    parts, ofs = [], 0
    for leaf in tree_leaves(tree):
        n = leaf.numel()
        lo, hi = max(start - ofs, 0), min(start + length - ofs, n)
        if lo < hi:
            parts.append(leaf.reshape(-1)[lo:hi].to(torch.float32))
        ofs += n
    got = sum(p.numel() for p in parts)
    if got < length:
        dev = tree_leaves(tree)[0].device
        parts.append(torch.zeros(length - got, dtype=torch.float32,
                                 device=dev))
    return torch.cat(parts)


def unflatten_like(flat: torch.Tensor, spec):
    treedef, sizes, shapes, dtypes, pad = spec
    if pad:
        flat = flat[:-pad]
    out = []
    ofs = 0
    for size, shape, dt in zip(sizes, shapes, dtypes):
        out.append(flat[ofs:ofs + size].reshape(shape).to(dt))
        ofs += size
    return tree_unflatten(treedef, out)


def flat_adamw_update(flat_p, flat_g, flat_m, flat_v, step,
                      cfg: AdamWConfig, out=None):
    """Elementwise AdamW on flat slices: (p, m, v) after step ``step``
    (the step count after this update, as ``apply_update``'s).

    ``FLAT_BLOCK`` elements at a time: the same operations on each
    element, so the same bits, with the temporaries bounded by a block
    (the ZeRO-1 step's slice is half a billion elements at full width).
    ``out``: three flat tensors to write p, m and v into, which may be
    the inputs themselves (a block is read before it is written)."""
    step = torch.as_tensor(step)
    lr = schedule_lr(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step.to(torch.float32))

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p
        return p - lr * u, m, v

    n = flat_p.numel()
    if out is None:
        out = tuple(torch.empty_like(flat_p) for _ in range(3))
    for lo in range(0, n, FLAT_BLOCK):
        hi = min(lo + FLAT_BLOCK, n)
        for dst, src in zip(out, upd(flat_p[lo:hi], flat_g[lo:hi],
                                     flat_m[lo:hi], flat_v[lo:hi])):
            dst[lo:hi] = src
    return out
