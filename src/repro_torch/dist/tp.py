"""Tensor-parallel activation seams for the sharded serving step.

``serve/shard.py`` runs every rank's step under a :class:`TPContext`:
attention's QKV and the MLP's up-projections are column-sharded on the
``tensor`` axis (a rank owns ``H/tp`` query heads, ``Hkv/tp`` KV heads and
``d_ff/tp`` hidden channels), so a step's only cross-rank traffic is at
the three projection seams this module hooks:

* :func:`attn_out`: the ``out @ wo`` seam after attention;
* :func:`mlp_out`: the ``hid @ w2`` seam after the MLP's nonlinearity;
* :func:`unembed_rows`: the logit matmul, its batch rows sharded over
  ``data``.

Two TP modes, as the reference's:

* ``"gather"`` (default): ``wo``/``w2`` stay **replicated** and the
  column-sharded activation is all-gathered before the whole matmul;
  uncompressed, that is the single-device step's arithmetic on the same
  values (per head and per channel, over the whole model dim);
* ``"psum"``: ``wo``/``w2`` are **row-sharded** and the partial products
  summed with :func:`~repro_torch.dist.collectives.ring_all_reduce`:
  fewer bytes a seam (``d_model`` against ``H*hd``/``d_ff`` columns), a
  different order of summation than one device, so tokens agree and
  logits to round-off.

Wire compression (``TPContext.spec``, a registry ``FormatSpec`` or a
``QuantSpec``) rides the collectives: the words cross the links, n/32 of
f32. Error-feedback residuals are carried **per call site**: the hooks
read the ``tp_res_o``/``tp_res_m`` leaves that ``serve/shard.py`` puts
into each layer's paged attention-cache dict and write the new residual
into them **in place** (the port's caches are updated in place, and the
step keeps no copy of the cache it is given). A leaf is this rank's own
``[1, B, 1, C]`` (the reference's rank-major leaf is ``[tp, B, 1, C]``,
of which each device sees ``[1, ...]``). Prefill chunks carry no
feedback; their shapes change from chunk to chunk.

Outside an active context every hook is the plain ``x @ w``: the
single-device engines, training and the tests pay nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.dist import collectives as coll

__all__ = ["TPContext", "active", "current", "attn_out", "mlp_out",
           "unembed_rows", "RESIDUAL_KEYS", "residual_norms"]

#: The per-call-site error-feedback residual leaves ``serve/shard.py``
#: puts into each layer's attention-cache dict (see the module docstring).
RESIDUAL_KEYS = ("tp_res_o", "tp_res_m")


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The process groups and sizes of the serving TP seams."""
    axis: object = None           # the tensor axis' process group
    size: int = 1                 # ranks on the tensor axis
    mode: str = "gather"          # "gather" | "psum"
    spec: object = None           # wire spec of the collectives, or None
    dp_axis: object = None        # the data axis' process group
    dp: int = 1                   # ranks on the data axis


# the contexts bound by active(), innermost last
_ACTIVE: list = []


@contextlib.contextmanager
def active(ctx: TPContext):
    """Bind ``ctx`` for the hooks below while a sharded step runs."""
    _ACTIVE.append(ctx)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current() -> Optional[TPContext]:
    return _ACTIVE[-1] if _ACTIVE else None


def _all_gather_cols(payload, wire, group, size: int, spec=None):
    """All-gather a column-sharded activation's last dim, in rank order.

    ``wire [..., c]`` is this rank's values and ``payload`` what crosses
    the links for them (``collectives.encode_hop``; ``wire`` itself when
    uncompressed). Returns ``[..., size * c]`` with rank r's columns at
    ``[r*c, (r+1)*c)``: the inverse of slicing a column-sharded
    projection, so the result has the unsharded layout."""
    full = coll.gather_encoded(payload.reshape(-1), wire.reshape(-1), spec,
                               group, size)
    parts = full.reshape((size,) + wire.shape)
    return torch.movedim(parts, 0, -2).reshape(
        wire.shape[:-1] + (size * wire.shape[-1],))


def _compress(x, spec, res):
    """One wire hop with optional carried error feedback: ``(payload,
    wire, new_res)``. ``payload`` crosses the links, ``wire`` is the
    compressed values of ``x + res``, ``new_res`` the compression error
    of ``x + res`` (what the call site adds back next step). ``res=None``
    carries no feedback (prefill)."""
    if spec is None:
        return x, x, (None if res is None else torch.zeros_like(res))
    xin = x if res is None else x + res.to(x.dtype)
    payload, wire = coll.encode_hop(xin, spec)
    return payload, wire, xin - wire


def _proj_out(x, w, state, res_key: str):
    """The shared TP seam: ``x @ w`` with the active context's collective.

    ``state`` is the layer's attention-cache dict (or None): when it holds
    a ``res_key`` leaf, the error-feedback residual is read from it and
    the new one written into it in place."""
    ctx = current()
    if ctx is None or ctx.size == 1:
        return x @ w, state
    res = state.get(res_key) if isinstance(state, dict) else None
    if ctx.mode == "gather":
        # compressed once at the owning rank: every rank then multiplies
        # the same gathered wire values by the replicated w
        payload, wire, err = _compress(x, ctx.spec,
                                       None if res is None else res[0])
        y = _all_gather_cols(payload, wire, ctx.axis, ctx.size,
                             ctx.spec) @ w
    else:   # psum: w is row-sharded; the partial sums compress in transit
        part = x @ w
        if res is not None:
            part = part + res[0].to(part.dtype)
        y, err = coll.ring_all_reduce(part, ctx.axis, ctx.size,
                                      spec=ctx.spec)
    if res is not None:
        res.copy_(err[None])
    return y, state


def attn_out(out, wo, cache=None):
    """The ``out @ wo`` seam after attention; returns ``(y, cache)``."""
    return _proj_out(out, wo, cache, "tp_res_o")


def mlp_out(hid, w2, state=None):
    """The ``hid @ w2`` seam after the MLP's gate; returns
    ``(y, state)``."""
    return _proj_out(hid, w2, state, "tp_res_m")


def unembed_rows(x, w):
    """The DP logit seam: this rank's share of the batch rows through the
    unembed matmul, the logits all-gathered in rank order over ``data``,
    so sampling stays replicated. Only when the batch divides ``dp``: a
    batch-1 prefill chunk takes the replicated matmul."""
    ctx = current()
    if ctx is None or ctx.dp <= 1 or x.shape[0] % ctx.dp:
        return x @ w
    import torch.distributed as dist
    rows = x.shape[0] // ctx.dp
    r = dist.get_rank(ctx.dp_axis)
    lg = x[r * rows:(r + 1) * rows] @ w
    full = coll.ring_all_gather(lg.reshape(-1), ctx.dp_axis, ctx.dp,
                                spec=ctx.spec)
    return full.reshape((ctx.dp * rows,) + lg.shape[1:])


def residual_norms(tree) -> dict:
    """Per-call-site L2 norms of the error-feedback residuals in a cache
    tree: ``{"tp_res_o/<n>": norm, ...}``, keyed by leaf name and
    occurrence (the tree walked in the reference's order, dict keys
    sorted). The port's caches hold a dict a layer, so there is one entry
    a layer and rank (the reference's stacked leaves give one a scanned
    group, over all ranks).

    The compressed collectives' numeric-health signal: the residual is
    the quantisation error the last step deferred, so a norm that grows
    without bound means error feedback is not absorbing it. Reads device
    values: the scheduler samples it once a tick at ``REPRO_OBS=2``,
    between steps."""
    from repro_torch.tree import leaves_with_paths
    out = {}
    counts = {k: 0 for k in RESIDUAL_KEYS}
    for path, leaf in leaves_with_paths(tree):
        if leaf is None or not path:
            continue
        key = path[-1]
        if key in counts:
            t = torch.as_tensor(leaf).to(torch.float32)
            out[f"{key}/{counts[key]}"] = float(torch.sqrt(torch.sum(t * t)))
            counts[key] += 1
    return out
