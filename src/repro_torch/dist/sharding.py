"""Logical-axis sharding: activation annotations and parameter placement.

Model code never names mesh axes. The reference tags activation dims with
*logical* names (``annotate(x, "batch", "seq", "heads", None)``) and its
launch layer binds them to mesh axes with ``use_rules(mesh, rules)``,
where ``annotate`` becomes a sharding constraint that XLA's partitioner
honours. The port runs one process per rank (``serve/shard.py``): each
rank already holds its local shard of every sharded tensor, so inside
the rules ``annotate`` checks the names and returns its input, and
outside them it is the identity, as the reference's.

Parameter placement (:func:`param_spec`) is the reference's FSDP x TP
recipe: one dimension tensor-parallel on the model axis (by the param's
role: the contraction input of a down-projection, the output otherwise),
and one fully-sharded dimension on the data axes where sizes divide
(only when ``axis_sizes`` is given). A placement is a tuple with one
entry per dim: an axis name, a tuple of axis names, or None; ``()`` is
replicated. The entries are the reference's ``PartitionSpec``'s.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple, Union

__all__ = ["RULES_2D", "RULES_3D", "annotate", "use_rules", "param_spec",
           "current_rules", "Placement"]

Axes = Union[None, str, Tuple[str, ...]]
Placement = Tuple[Axes, ...]

# logical activation/parameter dim -> mesh axes; None/absent: replicated
RULES_2D: Dict[str, Axes] = {
    "batch": ("data",),
    "seq": None,
    "embed": None,          # the residual stream stays replicated
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "state": ("model",),
}

RULES_3D: Dict[str, Axes] = dict(RULES_2D, batch=("pod", "data"))

# the (mesh, rules) pairs bound by use_rules, innermost last
_ACTIVE: list = []


@contextlib.contextmanager
def use_rules(mesh, rules: Dict[str, Axes]):
    """Bind logical axis names to ``mesh`` axes for :func:`annotate`."""
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_rules() -> Optional[tuple]:
    return _ACTIVE[-1] if _ACTIVE else None


def _as_tuple(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def annotate(x, *names):
    """``x`` itself: outside rules the identity; inside, the local shard
    a rank already holds (one name per dim is still required, as the
    reference's constraint requires)."""
    if current_rules() is not None and len(names) != x.ndim:
        raise ValueError(f"annotate: {len(names)} names for rank-{x.ndim}")
    return x


# params whose *input* (second-to-last) dim is the wide one: the
# down-projections back into the residual stream; every other matrix
# shards its output dim
_TP_IN_DIM_SUBSTRINGS = ("wo", "w2", "w_out", "down")
_REPLICATED_SUBSTRINGS = ("scale", "norm", "bias", "a_param", "decay",
                          "time_", "gate_bias")


def param_spec(name: str, shape: tuple, rules: Dict[str, Axes], *,
               axis_sizes: Optional[Dict[str, int]] = None) -> Placement:
    """The FSDP x TP placement of a parameter, by name and shape.

    ``rules`` supplies the axis vocabulary: the model (TP) axes from its
    ``ff`` entry, the data (FSDP) axes from ``batch``. With
    ``axis_sizes`` a placement whose axes do not divide the dim is
    dropped; without it only the TP placement is given (FSDP needs a
    divisibility guarantee the caller then adds)."""
    nd = len(shape)
    if nd < 2 or any(s in name for s in _REPLICATED_SUBSTRINGS):
        return ()
    tp_axes = _as_tuple(rules.get("ff", ("model",)))
    dp_axes = _as_tuple(rules.get("batch", ("data",)))

    def fits(axes: Tuple[str, ...], dim: int) -> bool:
        if not axes:
            return False
        if axis_sizes is None:
            return True
        return dim % math.prod(axis_sizes.get(a, 1) for a in axes) == 0

    parts: list = [None] * nd
    # a stacked-layer leading dim (the reference's scanned stacks) stays
    # whole
    first = 1 if nd >= 3 else 0
    leaf = name.rsplit("/", 1)[-1]
    if "embed_tokens" in name:
        tp_dim = first                      # (vocab, d_model): the vocab
    elif any(s in leaf for s in _TP_IN_DIM_SUBSTRINGS):
        tp_dim = nd - 2                     # down-projection: its input
    else:
        tp_dim = nd - 1                     # up/out-projection: its output
    if fits(tp_axes, shape[tp_dim]):
        parts[tp_dim] = tp_axes if len(tp_axes) > 1 else tp_axes[0]
    # FSDP: the largest remaining dim that divides (needs axis_sizes)
    if axis_sizes is not None and dp_axes:
        cands = sorted((d for d in range(first, nd)
                        if parts[d] is None and fits(dp_axes, shape[d])),
                       key=lambda d: -shape[d])
        if cands:
            parts[cands[0]] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return tuple(parts)
