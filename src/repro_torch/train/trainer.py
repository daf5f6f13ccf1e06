"""Train steps: the port's counterparts of the JAX package's
``make_train_step_gspmd`` (one device) and ``make_train_step_manual``
(data parallel over ranks, ZeRO-1).

``make_train_step`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and its gradients (``_grads_fn``:
``loss_fn`` under ``torch.autograd``, with per-block remat and microbatch
accumulation), clipping by the global norm, then AdamW. The step leaves
its inputs as they were.

``make_train_step_manual`` is the reference's manual data-parallel step
with one process per rank (``torch.distributed``; the mesh is
``launch/mesh.py``'s): each rank takes its rows of the global batch,
flattens its gradients, ring reduce-scatters them over ``data``
(takum-compressed when there is no ``pod`` axis), ring all-reduces its
chunk over ``pod`` with takum compression and error feedback, clips by
the global norm, runs flat AdamW on its slice (the optimizer state is
sharded over ``data``: ZeRO-1) and ring all-gathers the parameters. The
rings are ``dist/collectives.py``'s, the compressed hops on the codec
kernels.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.core.quant import QuantSpec
from repro_torch.dist import collectives as coll
from repro_torch.models import model
from repro_torch.optim import adamw as opt
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["make_train_step", "make_train_step_manual", "init_flat_state",
           "TrainStateFlat", "apply_flat_grads", "reduce_flat_grads",
           "update_flat", "shard_slot", "state_shard",
           "step_interconnect_bytes", "grad_spec_from_quant"]


def grad_spec_from_quant(name: str) -> Optional[QuantSpec]:
    """A gradient-compression name (``takum8``, ``posit16``, ...) as its
    ``QuantSpec``; ``"none"`` or empty: None. The reference reads the
    width from the last two characters, which fails on ``takum8``."""
    if not name or name == "none":
        return None
    m = re.fullmatch(r"(takum|posit)(\d+)", name)
    if m is None:
        raise ValueError(f"unknown gradient compression {name!r}: "
                         f"takum<n> or posit<n>")
    return QuantSpec(fmt=m.group(1), n=int(m.group(2)), scale="none")


def _device_batch(batch, device):
    """A batch's arrays as tensors on ``device`` (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


def _grads_fn(cfg: ModelConfig, runtime: RuntimeConfig):
    remat = runtime.remat != "none"

    def value_and_grad(params, batch):
        leaves, treedef = tree_flatten(params)
        for leaf in leaves:
            if not (isinstance(leaf, torch.Tensor)
                    and leaf.is_floating_point()):
                raise TypeError(f"the train step takes float tensor "
                                f"parameters, got {type(leaf).__name__}")
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss, metrics = model.loss_fn(tree_unflatten(treedef, live), batch,
                                      cfg, remat=remat)
        metrics = {k: v.detach() for k, v in metrics.items()}
        # no local keeps the gradients: the caller's tree is their only
        # holder (a frame the first checkpointed backward retains until
        # the cyclic collector runs would otherwise hold them too)
        return loss.detach(), metrics, tree_unflatten(
            treedef, list(torch.autograd.grad(loss, live)))

    def grads_of(params, batch):
        if runtime.microbatch and runtime.microbatch > 1:
            k = runtime.microbatch
            mb = {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
                  for key, v in batch.items()}
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(params)]
            l_acc = 0.0
            for i in range(k):
                l, _, g = value_and_grad(params,
                                         {key: v[i] for key, v in mb.items()})
                g_acc = [a + b for a, b in zip(g_acc, tree_leaves(g))]
                l_acc = l_acc + l
            g = tree_unflatten(tree_flatten(params)[1],
                               [x / k for x in g_acc])
            loss = l_acc / k
            metrics = {"loss": loss, "xent": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
            return loss, metrics, g
        return value_and_grad(params, batch)

    return grads_of


def make_train_step(cfg: ModelConfig, opt_cfg: opt.AdamWConfig,
                    runtime: RuntimeConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on the parameters' device; ``batch`` holds numpy arrays or tensors
    ({"tokens", "labels"} [B, T], optionally "loss_mask"). ``metrics``:
    loss, xent, aux and grad_norm as 0-d tensors."""
    grads_of = _grads_fn(cfg, runtime)

    def step(params, opt_state: opt.AdamWState, batch):
        batch = _device_batch(batch, tree_leaves(params)[0].device)
        loss, metrics, grads = grads_of(params, batch)
        grads, gnorm = opt.clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = opt.apply_update(params, grads, opt_state,
                                             opt_cfg)
        metrics = dict(metrics, grad_norm=gnorm)
        return params, opt_state, metrics

    return step


# ---------------------------------------------------------------------------
# Manual-DP ZeRO-1 step with compressed ring collectives
# ---------------------------------------------------------------------------


class TrainStateFlat(NamedTuple):
    """This rank's shard of the reference's ``TrainStateFlat``: ``m`` and
    ``v`` its ``G/dp`` slice of the reference's ``[G]`` vectors (sharded
    over ``data``), ``ef`` its ``G/dp`` chunk of ``[npod, dp, G/dp]`` (the
    pod ring's error feedback); :func:`shard_slot` says where each sits."""
    m: torch.Tensor       # [G/dp] f32
    v: torch.Tensor       # [G/dp] f32
    ef: torch.Tensor      # [G/dp] f32; a broadcast zero where none is kept
    step: torch.Tensor    # int32 scalar


def _zero_chunk(n: int, device) -> torch.Tensor:
    """``n`` zeros in no memory (a broadcast scalar): the error feedback
    of a mesh without a ``pod`` ring, which no step changes."""
    return torch.zeros((), dtype=torch.float32, device=device).expand(n)


def init_flat_state(params, dp: int, npod: int = 1):
    """``(state, flat_spec)``: zero moments and error feedback of this
    rank's shard (every rank's is the same at step 0), the flat vector
    padded as ``opt.flatten_like(params, pad_to=dp)`` pads it. Without a
    pod ring (``npod == 1``) the error feedback is a broadcast zero, as
    the reference's stays zero there."""
    spec = opt.flat_spec(params, pad_to=dp)
    csize = (sum(spec[1]) + spec[4]) // dp
    dev = tree_leaves(params)[0].device

    def zeros():
        return torch.zeros(csize, dtype=torch.float32, device=dev)

    ef = zeros() if npod > 1 else _zero_chunk(csize, dev)
    return TrainStateFlat(zeros(), zeros(), ef,
                          torch.zeros((), dtype=torch.int32, device=dev)), spec


def _layout(mesh):
    """(dp, npod, has_pod) of a mesh with a ``data`` axis."""
    dp = mesh.axis_size("data")
    npod = mesh.axis_size("pod") if "pod" in mesh.axis_names else 1
    return dp, npod, npod > 1


def shard_slot(mesh, flat_size: int):
    """Where this rank's shard sits in the reference's global layout:
    ``(s, (p, d))`` with ``m[s]`` and ``v[s]`` its slice of ``[G]`` and
    ``ef[p, d]`` its chunk of ``[npod, dp, G/dp]``."""
    dp, _, _ = _layout(mesh)
    csize = flat_size // dp
    d = mesh.coord("data")
    p = mesh.coord("pod") if "pod" in mesh.axis_names else 0
    return slice(d * csize, (d + 1) * csize), (p, d)


def state_shard(m, v, ef, step, mesh, device="cpu") -> TrainStateFlat:
    """This rank's shard of a global flat state in the reference's layout
    (``m``, ``v`` [G], ``ef`` [npod, dp, G/dp], ``step``): numpy arrays
    or tensors, as tensors on ``device``."""
    s, (p, d) = shard_slot(mesh, len(m))

    def t(x):
        return torch.as_tensor(x).to(device)

    return TrainStateFlat(t(m[s]).clone(), t(v[s]).clone(),
                          t(ef[p, d]).clone(),
                          t(step).to(torch.int32).reshape(()))


def _all_reduce_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` summed over the ranks of ``axes`` (uncompressed rings, one
    axis after the other; the identity on axes of size 1)."""
    for axis in axes:
        if axis in mesh.axis_names and mesh.axis_size(axis) > 1:
            x, _ = coll.ring_all_reduce(x, mesh.group(axis),
                                        mesh.axis_size(axis))
    return x


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """``sum(x * x)`` as an f32 scalar: a block's f32 squares at a time,
    summed in f64 and rounded once (the reference's f32 sum runs in
    XLA's order, which no other library repeats)."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, x.numel(), opt.FLAT_BLOCK):
        blk = x[lo:lo + opt.FLAT_BLOCK]
        total += torch.sum((blk * blk).to(torch.float64))
    return total.to(torch.float32)


def reduce_flat_grads(gflat: torch.Tensor, ef: torch.Tensor, mesh, *,
                      compress: Optional[QuantSpec] = None,
                      error_feedback: bool = True):
    """This rank's flat gradients ``[G]`` -> ``(chunk, new_ef)``: the sum
    over the data-parallel ranks of its ``G/dp`` chunk, divided by
    ``dp * npod``, and the pod ring's new error feedback.

    The reference's order: a ring reduce-scatter over ``data``
    (compressed with ``compress`` only where there is no pod ring), then,
    across pods, ``chunk + ef`` ring all-reduced with ``compress`` (the
    slow links), its residual the new ``ef``."""
    dp, npod, has_pod = _layout(mesh)
    data_spec = None if has_pod else compress
    chunk, _ = coll.ring_reduce_scatter(gflat, mesh.group("data"), dp,
                                        spec=data_spec, residual=False)
    new_ef = _zero_chunk(chunk.numel(), chunk.device)
    if has_pod:
        if error_feedback:
            chunk = chunk + ef
        chunk, res = coll.ring_all_reduce(chunk, mesh.group("pod"), npod,
                                          spec=compress)
        if error_feedback:
            new_ef = res
    return chunk / (dp * npod), new_ef


def update_flat(chunk: torch.Tensor, new_ef: torch.Tensor, params,
                state: TrainStateFlat, mesh, opt_cfg: opt.AdamWConfig,
                flat_spec):
    """The manual step after the reduction: the global norm of the
    reduced chunks (``sum(chunk²)`` summed over ``data``) and the
    reference's clip scale, flat AdamW on this rank's slice of the
    parameters, then the ring all-gather of the new slices over ``data``
    (uncompressed) into the parameter tree. ``chunk`` (this step's own,
    from :func:`reduce_flat_grads`) is clipped in place and its memory
    becomes the new ``m``. Returns ``(params, state, grad_norm)``."""
    dp, _, _ = _layout(mesh)
    csize = chunk.numel()
    p_slice = opt.flat_slice(params, mesh.coord("data") * csize, csize)
    gnorm = torch.sqrt(_all_reduce_over(_sum_squares(chunk).reshape(1),
                                        mesh, ("data",)))[0]
    scale = torch.clamp(opt_cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    chunk.mul_(scale)
    step_no = state.step + 1
    # the slice and the chunk are this step's own: the new p and m take
    # their memory (a G/dp vector each at full width)
    new_p, new_m, new_v = opt.flat_adamw_update(
        p_slice, chunk, state.m, state.v, step_no, opt_cfg,
        out=(p_slice, chunk, torch.empty_like(chunk)))
    del p_slice, chunk
    pfull = coll.ring_all_gather(new_p, mesh.group("data"), dp, spec=None)
    del new_p
    return (opt.unflatten_like(pfull, flat_spec),
            TrainStateFlat(new_m, new_v, new_ef, step_no), gnorm)


def apply_flat_grads(gflat: torch.Tensor, params, state: TrainStateFlat,
                     mesh, opt_cfg: opt.AdamWConfig, flat_spec, *,
                     compress: Optional[QuantSpec] = None,
                     error_feedback: bool = True):
    """The manual step after the gradients, the seam a test replays the
    reference's gradients through: this rank's flat gradients ``[G]``
    (padded to ``dp``) -> :func:`reduce_flat_grads` -> :func:`update_flat`
    -> ``(params, state, grad_norm)``."""
    chunk, new_ef = reduce_flat_grads(gflat, state.ef, mesh,
                                      compress=compress,
                                      error_feedback=error_feedback)
    return update_flat(chunk, new_ef, params, state, mesh, opt_cfg,
                       flat_spec)


def _rank_rows(batch, n: int, index: int, mesh):
    """Rows ``index`` of ``n`` equal parts of every array of the global
    ``batch`` (the reference's ``P(dp_axes)``: rank-major over ``(pod,
    data)``); a batch the ranks do not divide is refused by name."""
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"the batch's arrays have {sorted(rows)} rows")
    b = rows.pop()
    if b % n:
        raise ValueError(
            f"global batch {b} is not divisible by the {n} data-parallel "
            f"ranks of mesh {mesh.shape}: the manual step gives each rank "
            f"b / {n} rows")
    k = b // n
    return {key: v[index * k:(index + 1) * k] for key, v in batch.items()}


def make_train_step_manual(cfg: ModelConfig, opt_cfg: opt.AdamWConfig,
                           runtime: RuntimeConfig, mesh, flat_spec, *,
                           compress: Optional[QuantSpec] = None,
                           error_feedback: bool = True):
    """The reference's ZeRO-1 step over the data-parallel ranks of
    ``mesh`` (``launch/mesh.py``; axes ``data``, optionally ``pod``, and
    ``model`` of size 1): ``step(params, state, batch) -> (params, state,
    metrics)`` on this rank, ``batch`` the global batch (numpy arrays or
    tensors) of which the step takes this rank's rows.

    Gradient flow: flat grads -> ring reduce-scatter over ``data``
    (uncompressed on a pod mesh) -> ring all-reduce of the chunk over
    ``pod`` (``compress``, with error feedback) -> flat ZeRO-1 AdamW on
    the chunk -> parameter all-gather. Single-pod meshes compress the
    data ring instead and carry no error feedback. Every rank returns the
    same parameters and the metrics (loss, xent, aux, grad_norm) averaged
    over the data-parallel ranks.

    A ``model`` axis larger than 1 is refused: the reference leaves it to
    GSPMD with replicated parameters, and the port has no tensor-parallel
    training."""
    if mesh is None or "data" not in mesh.axis_names:
        raise ValueError("the manual step runs over a mesh with a 'data' "
                         f"axis (launch/mesh.py::make_mesh), got {mesh}")
    if "model" in mesh.axis_names and mesh.axis_size("model") > 1:
        raise ValueError(
            f"mesh {mesh.shape}: the manual data-parallel step runs with "
            "model axis 1; the port has no tensor-parallel training (the "
            "reference leaves the model axis to GSPMD)")
    grads_of = _grads_fn(cfg, runtime)
    dp, npod, _ = _layout(mesh)
    n = dp * npod
    index = mesh.coord("data") + dp * (mesh.coord("pod")
                                       if "pod" in mesh.axis_names else 0)
    metric_keys = ("loss", "xent", "aux", "grad_norm")

    def step(params, state: TrainStateFlat, batch):
        rows = _rank_rows(batch, n, index, mesh)
        dev = tree_leaves(params)[0].device
        _, metrics, grads = grads_of(params, _device_batch(rows, dev))
        gflat = opt.flatten_like(grads, pad_to=dp)[0]
        del grads
        chunk, new_ef = reduce_flat_grads(gflat, state.ef, mesh,
                                          compress=compress,
                                          error_feedback=error_feedback)
        # apply_flat_grads's two halves: the G-element gradients go first
        del gflat
        params, state, gnorm = update_flat(chunk, new_ef, params, state,
                                           mesh, opt_cfg, flat_spec)
        metrics = dict(metrics, grad_norm=gnorm)
        vals = torch.stack([metrics[k].to(torch.float32).reshape(())
                            for k in metric_keys])
        vals = _all_reduce_over(vals, mesh, ("data", "pod")) / n
        return params, state, dict(zip(metric_keys, vals.unbind()))

    return step


def step_interconnect_bytes(flat_size: int, dp: int, npod: int = 1,
                            compress=None) -> int:
    """The bytes one rank sends in a manual step
    (``collectives.transport``'s ``bytes_sent``), from the rings' hop
    counts: the data reduce-scatter (``dp - 1`` hops of ``G/dp``
    elements, compressed only without a pod ring), the pod all-reduce of
    the chunk (``2 (npod - 1)`` hops of ``G/dp/npod``, compressed), the
    norm's all-reduce over ``data`` and the four metrics' over ``data``
    and ``pod`` (f32, each padded to its ring), and the parameters'
    all-gather over ``data`` (``dp - 1`` hops of ``G/dp`` in f32)."""
    csize = flat_size // dp
    has_pod = npod > 1
    f32 = 4

    def all_reduce(elems, size, per):
        return 2 * (size - 1) * math.ceil(elems / size) * per if size > 1 \
            else 0

    data_per = f32 if has_pod else coll.hop_bytes(compress)
    out = (dp - 1) * csize * data_per
    out += all_reduce(csize, npod, coll.hop_bytes(compress))
    out += all_reduce(1, dp, f32)
    out += all_reduce(4, dp, f32) + all_reduce(4, npod, f32)
    out += (dp - 1) * csize * f32
    return int(out)
