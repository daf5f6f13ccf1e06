"""The dry run: every (arch x shape x mesh) cell at full width and depth,
traced on fake tensors through the kernels' fake branches.

The JAX package lowers and compiles each cell against ``ShapeDtypeStruct``
stand-ins on 512 forced host devices and reads XLA's memory and cost
analyses. The port has no compiler to ask, so a cell here runs rank 0's
program of the mesh once inside ``device.fake_cuda()``: every tensor is
fake (a shape, a dtype and a device, no data), every process group is
``torch.distributed``'s ``fake`` backend with the mesh's world size, and
every kernel wrapper takes its fake branch (``kernels/cost.py``). Nothing
is allocated, no card and no ``nvcc`` are needed, and the same step runs
on the card for real (``chip_smoke.py`` phase 40 holds the two against
each other).

Per cell this reports, as JSON under ``experiments/dryrun/``:

* ``memory.argument_size_in_bytes``: a device's bytes of the step's
  arguments under the reference's placements: its ``param_spec`` with
  ``axis_sizes`` (FSDP x TP), ``_zero1ify`` for the AdamW moments, the
  manual step's flat state over ``data``, ``_cache_spec`` for caches and
  states, ``batch_spec_axes`` for the batch. Placements are computed on
  the reference's layout of the port's own trees (each scan group's
  layers stacked, ``convert.py``'s pairing; a cache's host ``pos`` as the
  reference's int32), so they are shape arithmetic and need no
  partitioner. A placement whose axes do not divide a dim is taken with
  the larger shard and its leaf listed under ``uneven`` (the reference's
  ``jit`` refuses such an argument);
* ``params`` and ``active_params`` (``ModelConfig.param_count``);
* the step under the port's own placement for the mesh:
  ``ShardPlan(tp=model, dp=the data axes)`` for ``prefill``/``decode``
  (``model.prefill``, ``model.decode_step`` inside the plan's TP
  context, on this rank's shards), ``make_train_step`` on one rank or
  ``make_train_step_manual`` (``--dp-mode manual``) for ``train``.
  Where the port places the cell: ``flops`` and ``bytes_accessed`` from
  the cost counter, ``memory.output_size_in_bytes``,
  ``memory.temp_size_in_bytes`` (the traced peak of live storages less
  the arguments), ``port_argument_bytes`` (what rank 0 holds under the
  port's placement), ``collectives`` (the reference's five kinds counted
  from the port's rings, and the bytes ``collectives.transport`` moves),
  ``kernels`` (each kernel's fake calls, flops and bytes), ``trace_s``
  (in place of ``lower_s``/``compile_s``) and ``n_devices``. Where the
  port refuses it (a plan that cannot split the heads, a family without
  TP seams, a ``model`` axis in training), ``status`` is ``error`` with
  the refusal's own text, as the reference reports any exception.

Cells that ``shape_applicable`` excludes are ``skipped``.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-medium-14b \\
      --shape train_4k [--multi-pod] [--dp-mode manual] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

``--mesh 1`` (or ``2x2``, ...) runs a cell on a ``(data, model)`` mesh of
that shape instead of the production one (three numbers: ``(pod, data,
model)``): the mesh the port can place, and the one ``chip_smoke.py``
holds against the card. The ``overrides`` of :func:`run_cell` also take
``n_layers``, ``global_batch`` and ``seq_len``, which cut a cell to a
card, and ``reduced`` (the arch's reduced config, for tests).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import (SHAPES, RuntimeConfig, get_arch, list_archs,
                                 shape_applicable)
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import RULES_2D, RULES_3D, param_spec
from repro_torch.kernels.cost import CostCounter
from repro_torch.kernels.ops import WireMatrix
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import (PRODUCTION_MESHES, batch_spec_axes,
                                     make_mesh)
from repro_torch.models.transformer import layer_index
from repro_torch.tree import path_name, tree_map

__all__ = ["DEFAULT_OUT", "COLLECTIVES", "DEFAULT_TRAIN_RUNTIME",
           "build_cell", "run_cell", "port_step", "placement_bytes",
           "stacked_leaves", "reference_argument_bytes",
           "zero1ify", "cache_spec", "fake_world", "Census", "main"]

DEFAULT_OUT = "experiments/dryrun"

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# the reference's train runtime: 8-way gradient accumulation
DEFAULT_TRAIN_RUNTIME = RuntimeConfig(microbatch=8)

# ---------------------------------------------------------------------------
# The fake job
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` process group of ``size`` ranks in which this process is
    rank 0 (every collective returns at once, moving nothing); destroyed
    on exit. Refuses if a process group already exists."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "the dry run makes a fake process group of the mesh's ranks, "
            f"and this process already has one ({dist.get_backend()}, "
            f"{dist.get_world_size()} ranks): run it in a process of its "
            "own")
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class Census:
    """Counts the port's collectives while it is entered: each outermost
    ring call by the reference's kind (``ring_all_reduce`` all-reduce,
    ``ring_reduce_scatter`` reduce-scatter, ``ring_all_gather`` and
    ``gather_encoded`` all-gather) with its result's bytes, and the hops
    and bytes ``transport`` sends (``hops``, ``wire_bytes``). Every hop
    of the port belongs to a ring, so all-to-all and collective-permute
    stay 0."""

    _KINDS = {"ring_all_reduce": "all-reduce",
              "ring_reduce_scatter": "reduce-scatter",
              "ring_all_gather": "all-gather",
              "gather_encoded": "all-gather"}

    def __init__(self):
        self.out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self._depth = 0
        self._saved: Dict[str, object] = {}

    def _wrap(self, name: str, fn):
        kind = self._KINDS[name]

        def counted(*args, **kwargs):
            self._depth += 1
            try:
                res = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            if self._depth == 0:
                t = res[0] if isinstance(res, tuple) else res
                self.out[kind]["count"] += 1
                self.out[kind]["bytes"] += t.numel() * t.element_size()
            return res
        return counted

    def __enter__(self):
        self._hops0 = coll.transport.hops
        self._bytes0 = coll.transport.bytes_sent
        for name in self._KINDS:
            self._saved[name] = getattr(coll, name)
            setattr(coll, name, self._wrap(name, self._saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(coll, name, fn)
        self.out["hops"] = coll.transport.hops - self._hops0
        self.out["wire_bytes"] = coll.transport.bytes_sent - self._bytes0
        self.out["total_bytes"] = sum(v["bytes"] for k, v in self.out.items()
                                      if isinstance(v, dict))
        return False


# ---------------------------------------------------------------------------
# The reference's placements over the port's trees
# ---------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    return () if isinstance(leaf, int) else tuple(leaf.shape)


def _itemsize(leaf) -> int:
    if isinstance(leaf, WireMatrix):
        return leaf.words.element_size()
    if isinstance(leaf, int):
        return 4          # a host position: the reference's int32
    return leaf.element_size()


def _leaves(tree):
    """(path, leaf) in ``tree.leaves_with_paths``' order, a ``WireMatrix``
    one leaf and a host int one leaf too."""
    if isinstance(tree, WireMatrix):
        return [((), tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += [((k,) + p, v) for p, v in _leaves(tree[k])]
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += [((i,) + p, x) for p, x in _leaves(v)]
        return out
    return [((), tree)]


def stacked_leaves(tree, cfg, kind: str = "params"
                   ) -> List[Tuple[str, tuple, int]]:
    """(reference name, shape, itemsize) of every leaf of the port's
    ``params`` or contiguous ``cache`` tree in the reference's layout:
    ``params["layers"]`` (a cache's list) stacked into
    ``["groups"][g]["b{i}"]`` by ``transformer.layer_index`` (encdec's
    ``enc``/``dec`` lists into one stack each), the rest as they are. A
    cache node's host ``pos`` counts as the reference's int32 scalar."""
    out: List[Tuple[tuple, tuple, int]] = []

    def flat(sub, prefix):
        return [(prefix + p, _shape(v), _itemsize(v))
                for p, v in _leaves(sub)]

    def stack(layers, index, prefix):
        groups: Dict[tuple, list] = {}
        for key, layer in zip(index, layers):
            groups.setdefault(key, []).append(layer)
        for key in sorted(groups):
            members = groups[key]
            for path, leaf in _leaves(members[0]):
                out.append((prefix(key) + path,
                            (len(members),) + _shape(leaf), _itemsize(leaf)))

    if kind == "cache":
        if isinstance(tree, dict):          # encdec
            stack(tree["dec"], [0] * len(tree["dec"]),
                  lambda _: ("dec", "attn"))
            out += flat(tree["enc_out"], ("enc_out",))
        else:
            stack(tree, [(g, i) for g, i, _ in layer_index(cfg)],
                  lambda k: (k[0], f"b{k[1]}"))
        return [(path_name(p), s, b) for p, s, b in out]
    for k in sorted(tree):
        if k == "layers":
            stack(tree[k], [(g, i) for g, i, _ in layer_index(cfg)],
                  lambda key: ("groups", key[0], f"b{key[1]}"))
        elif k in ("enc", "dec"):
            stack(tree[k], [0] * len(tree[k]), lambda _, k=k: (k,))
        else:
            out += flat(tree[k], (k,))
    return [(path_name(p), s, b) for p, s, b in out]


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placement_bytes(shape: Sequence[int], itemsize: int, placement,
                    sizes: Dict[str, int]) -> Tuple[int, bool]:
    """(a device's bytes of a leaf under ``placement``, whether every
    placed dim divides): each placed dim cut into ``prod(axis sizes)``
    parts, the larger part where it does not divide."""
    elems, even = 1, True
    parts = list(placement) + [None] * (len(shape) - len(placement))
    for dim, entry in zip(shape, parts):
        n = math.prod(sizes[a] for a in _axes_of(entry))
        elems *= -(-dim // n)
        even = even and dim % n == 0
    return elems * itemsize, even


def zero1ify(spec: tuple, shape, sizes: Dict[str, int],
             enabled: bool) -> tuple:
    """The reference's ``_zero1ify``: the AdamW moments' placement, the
    parameter's plus a data axis (``data``, then ``pod``) on the first
    free dim it divides."""
    if not enabled:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for p in parts:
        used.update(_axes_of(p))
    for axis in ("data", "pod"):
        if axis not in sizes or axis in used:
            continue
        asize = sizes[axis]
        for i, (p, s) in enumerate(zip(parts, shape)):
            if p is None and s % asize == 0 and s >= asize:
                parts[i] = axis
                used.add(axis)
                break
    return tuple(parts)


def cache_spec(shape, batch: int, dp: tuple, sizes: Dict[str, int]) -> tuple:
    """The reference's ``_cache_spec``: the batch dim (matched by size in
    the first two dims) on the data axes, where they divide it; then the
    first later dim of at least, and divisible by, the ``model`` axis's
    size on ``model`` (for a KV cache the sequence dim)."""
    if not shape:
        return ()
    parts: list = [None] * len(shape)
    msize = sizes["model"]
    dpsize = math.prod(sizes[a] for a in dp)
    bdim = -1
    for i, s in enumerate(shape[:2]):
        if s == batch:
            if dp and batch % dpsize == 0:
                parts[i] = dp
            bdim = i
            break
    for i in range(bdim + 1, len(shape)):
        if shape[i] >= msize and shape[i] % msize == 0:
            parts[i] = "model"
            break
    return tuple(parts)


class _Args:
    """A per-device argument byte count under the reference's placements,
    by group (params, opt_state, batch, cache, pos), with the uneven
    leaves."""

    def __init__(self, sizes: Dict[str, int]):
        self.sizes = sizes
        self.by_group: Dict[str, int] = {}
        self.uneven: List[str] = []

    def add(self, group: str, name: str, shape, itemsize: int,
            placement) -> None:
        b, even = placement_bytes(shape, itemsize, placement, self.sizes)
        self.by_group[group] = self.by_group.get(group, 0) + b
        if not even:
            self.uneven.append(f"{group}:{name}")

    @property
    def total(self) -> int:
        return sum(self.by_group.values())


def _rules(sizes: Dict[str, int]):
    return RULES_3D if "pod" in sizes else RULES_2D


def _param_placements(params, cfg, sizes, args: _Args) -> list:
    rules = _rules(sizes)
    leaves = stacked_leaves(params, cfg)
    for name, shp, isz in leaves:
        args.add("params", name, shp, isz,
                 param_spec(name, shp, rules, axis_sizes=sizes))
    return leaves


def reference_argument_bytes(params, cache, batch, cfg, shape, sizes,
                             *, dp_mode: str = "gspmd",
                             runtime: Optional[RuntimeConfig] = None,
                             dp: tuple = ()) -> _Args:
    """A device's argument bytes of a cell under the reference's
    placements (see the module docstring), from the port's trees."""
    args = _Args(sizes)
    leaves = _param_placements(params, cfg, sizes, args)
    for name, t in sorted(batch.items()):
        plc = ((dp,) + (None,) * (t.ndim - 1)
               if t.ndim and t.shape[0] == shape.global_batch else ())
        args.add("batch", name, tuple(t.shape), t.element_size(), plc)
    if shape.kind == "train":
        runtime = runtime or DEFAULT_TRAIN_RUNTIME
        rules = _rules(sizes)
        if dp_mode == "manual":
            ndp = sizes["data"]
            npod = sizes.get("pod", 1)
            total = sum(math.prod(s) for _, s, _ in leaves)
            g = total + (-total) % ndp
            for name in ("m", "v"):
                args.add("opt_state", name, (g,), 4, ("data",))
            args.add("opt_state", "ef", (npod, ndp, g // ndp), 4,
                     ("pod" if "pod" in sizes else None, "data", None))
        else:
            for prefix in ("m", "v"):
                for name, shp, _ in leaves:
                    base = param_spec(name, shp, rules)
                    args.add("opt_state", f"{prefix}/{name}", shp, 4,
                             zero1ify(base, shp, sizes, runtime.zero1))
        args.add("opt_state", "step", (), 4, ())
        return args
    for name, shp, isz in stacked_leaves(cache, cfg, "cache"):
        args.add("cache", name, shp, isz,
                 cache_spec(shp, shape.global_batch, dp, sizes))
    if shape.kind == "decode":
        args.add("pos", "pos", (), 4, ())
    return args


# ---------------------------------------------------------------------------
# Building a cell
# ---------------------------------------------------------------------------


def _tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    seen, total = set(), 0
    for _, leaf in _leaves(tree):
        t = leaf.words if isinstance(leaf, WireMatrix) else leaf
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


def _fake_params(cfg, dev, weight_wire: str):
    """The model's parameters as fake tensors on ``dev`` (inside
    ``fake_cuda``), with ``weight_wire``'s words where the port's
    ``quantize_weights(mode="wire")`` puts them."""
    from repro_torch.models import model
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, cfg, device="cpu")
    params = tree_map(lambda t: torch.empty_like(t, device=dev), params)
    if weight_wire:
        from repro_torch.serve.engine import quantize_weights
        params = quantize_weights(params, weight_wire, mode="wire", cfg=cfg,
                                  verbose=False)
    return params


def _cell_config(arch: str, shape_name: str, overrides: Optional[dict]):
    ov = overrides or {}
    spec = get_arch(arch)
    cfg = spec.reduced if ov.get("reduced") else spec.config
    shape = SHAPES[shape_name]
    over = {k: ov[k] for k in ("kv_quant", "param_dtype", "dtype",
                               "n_layers") if k in ov}
    if over:
        cfg = dataclasses.replace(cfg, **over)
    sh = {k: ov[k] for k in ("global_batch", "seq_len") if k in ov}
    if sh:
        shape = dataclasses.replace(shape, **sh)
    return cfg, shape


def build_cell(arch: str, shape_name: str, mesh, *, dp_mode: str = "gspmd",
               runtime: RuntimeConfig = None, overrides: dict = None):
    """``(fn, args, info)`` of a cell on ``mesh`` (the port's
    ``launch.mesh.Mesh``), built inside ``device.fake_cuda()`` and a
    fake process group of the mesh's ranks (:func:`run_cell` makes both):
    ``fn(*args)`` is rank 0's step, ``args`` its fake arguments under the
    port's placement, and ``info`` holds the reference placements'
    argument bytes (``argument_bytes``, ``argument_groups``,
    ``uneven``). Raises the port's own refusal where it cannot place the
    cell; ``info`` is then on the exception (``exc.info``).

    ``overrides``: ``kv_quant``, ``param_dtype``, ``dtype``,
    ``weight_wire`` (serving), ``microbatch`` (training), and the cuts
    ``n_layers``, ``global_batch``, ``seq_len``, ``reduced`` (the arch's
    reduced config)."""
    from repro_torch.device import resolve_device
    from repro_torch.models import model

    ov = overrides or {}
    cfg, shape = _cell_config(arch, shape_name, ov)
    if runtime is None:
        runtime = (DEFAULT_TRAIN_RUNTIME if shape.kind == "train"
                   else RuntimeConfig())
    if "microbatch" in ov:
        runtime = dataclasses.replace(runtime, microbatch=ov["microbatch"])
    sizes = dict(mesh.shape)
    dp = batch_spec_axes(mesh, shape.global_batch)
    dev = resolve_device("cuda")
    weight_wire = ov.get("weight_wire", "")
    if weight_wire and shape.kind == "train":
        raise ValueError("weight_wire is a serving option")
    params = _fake_params(cfg, dev, weight_wire)
    batch = specs_mod.input_specs(cfg, shape, device=dev)
    cache = None
    if shape.kind != "train":
        enc_len = max(shape.seq_len // 4, 8)
        cache = model.init_cache(cfg, shape.global_batch, shape.seq_len + 64,
                                 enc_len=enc_len)
        if shape.kind == "decode":
            _set_pos(cache, shape.seq_len)
    ref = reference_argument_bytes(params, cache, batch, cfg, shape, sizes,
                                   dp_mode=dp_mode, runtime=runtime, dp=dp)
    info = {"argument_bytes": ref.total, "argument_groups": ref.by_group,
            "uneven": ref.uneven}
    try:
        fn, args = port_step(cfg, shape, mesh, params, batch, cache,
                             dp_mode, runtime)
    except Exception as e:
        e.info = info
        raise
    return fn, args, info


def _set_pos(cache, pos: int) -> None:
    nodes = cache["dec"] if isinstance(cache, dict) else cache
    for node in nodes:
        if "pos" in node:
            node["pos"] = pos


def port_step(cfg, shape, mesh, params, batch, cache, dp_mode, runtime):
    """``(fn, args)``: rank 0's step of a cell on ``mesh`` under the
    port's placement, from whole ``params``, ``batch`` and ``cache``
    (fake or real); raises the port's refusal where it cannot place
    it."""
    from repro_torch.models import model
    from repro_torch.optim import adamw as opt
    from repro_torch.serve.shard import ShardPlan, ShardedSteps, place_params
    from repro_torch.train import trainer
    sizes = dict(mesh.shape)
    if shape.kind == "train":
        ocfg = opt.AdamWConfig()
        if dp_mode == "manual":
            npod = sizes.get("pod", 1)
            state, flat_spec = trainer.init_flat_state(params, sizes["data"],
                                                       npod)
            compress = trainer.grad_spec_from_quant(
                runtime.quant.grad_allreduce)
            step = trainer.make_train_step_manual(
                cfg, ocfg, runtime, mesh, flat_spec, compress=compress)
            return step, (params, state, batch)
        if mesh.size > 1:
            raise ValueError(
                f"mesh {sizes}: the port's make_train_step runs on one "
                "device and the port has no partitioner to spread it "
                "(the reference's GSPMD); --dp-mode manual spreads a "
                "step over data axes with a model axis of 1")
        step = trainer.make_train_step(cfg, ocfg, runtime)
        return step, (params, opt.init_state(params), batch)
    tp = sizes["model"]
    plan = ShardPlan(tp=tp, dp=mesh.size // tp)
    steps = ShardedSteps(plan, cfg)
    if steps.mesh is not None:
        params = place_params(params, plan, steps.mesh, cfg)
        # this rank's heads: the cache of the plan's local config
        enc_len = max(shape.seq_len // 4, 8)
        cache = model.init_cache(steps.local_cfg, shape.global_batch,
                                 shape.seq_len + 64, enc_len=enc_len)
        if shape.kind == "decode":
            _set_pos(cache, shape.seq_len)
    lcfg = steps.local_cfg
    if shape.kind == "prefill":
        def fn(params, batch, cache):
            with steps.active():
                return model.prefill(params, batch["tokens"], lcfg, cache,
                                     media=batch.get("media"))
        return fn, (params, batch, cache)

    def fn(params, batch, cache):
        with steps.active():
            return model.decode_step(params, batch["tokens"], lcfg, cache,
                                     pos=shape.seq_len)
    return fn, (params, batch, cache)


# ---------------------------------------------------------------------------
# Running a cell
# ---------------------------------------------------------------------------


def _mesh_spec(multi_pod: bool, mesh_shape) -> Tuple[tuple, tuple, str]:
    if mesh_shape is None:
        shp, names = PRODUCTION_MESHES[bool(multi_pod)]
        return shp, names, "pod2x16x16" if multi_pod else "pod16x16"
    shp = tuple(int(s) for s in mesh_shape)
    names = {1: ("model",), 2: ("data", "model"),
             3: ("pod", "data", "model")}[len(shp)]
    if len(shp) == 1:
        shp, names = (1,) + shp, ("data", "model")
    return shp, names, "mesh" + "x".join(str(s) for s in shp)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = DEFAULT_OUT, dp_mode: str = "gspmd",
             runtime: RuntimeConfig = None, tag: str = "",
             overrides: dict = None, mesh_shape=None,
             keep: bool = False) -> dict:
    """Dry-run one cell and write its JSON under ``out_dir`` (``None``:
    write nothing). ``mesh_shape`` replaces the production mesh (see the
    module docstring). With ``keep`` the cell also holds, under
    ``"_trace"``, the fake arguments and outputs (for comparing shapes
    with a real run; not written)."""
    cfg, shape = _cell_config(arch, shape_name, overrides)
    ok, reason = shape_applicable(cfg, shape)
    shp, names, mesh_name = _mesh_spec(multi_pod, mesh_shape)
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "dp_mode": dp_mode, "tag": tag}
    if not ok:
        cell["status"] = "skipped"
        cell["reason"] = reason
        _dump(cell, out_dir, tag)
        return cell
    cell.update({"n_devices": math.prod(shp), "params": cfg.param_count(),
                 "active_params": cfg.active_param_count()})
    from repro_torch.device import fake_cuda
    t0 = time.time()
    try:
        with fake_world(math.prod(shp)), fake_cuda():
            mesh = make_mesh(shp, names)
            try:
                fn, args, info = build_cell(arch, shape_name, mesh,
                                            dp_mode=dp_mode, runtime=runtime,
                                            overrides=overrides)
            except Exception as e:
                info = getattr(e, "info", None)
                if info is not None:
                    cell["memory"] = {
                        "argument_size_in_bytes": info["argument_bytes"]}
                    cell["argument_groups"] = info["argument_groups"]
                    cell["uneven"] = info["uneven"]
                raise
            cell["memory"] = {"argument_size_in_bytes": info["argument_bytes"]}
            cell["argument_groups"] = info["argument_groups"]
            cell["uneven"] = info["uneven"]
            counter = CostCounter()
            port_args = counter.track([
                leaf.words if isinstance(leaf, WireMatrix) else leaf
                for _, leaf in _leaves(args)])
            t1 = time.time()
            with Census() as census, counter:
                out = fn(*args)
            t2 = time.time()
            cell.update({
                "status": "ok",
                "build_s": round(t1 - t0, 2),
                "trace_s": round(t2 - t1, 2),
                "flops": float(counter.flops),
                "bytes_accessed": float(counter.bytes),
                "collectives": census.out,
                "kernels": {k: dict(v) for k, v in
                            sorted(counter.kernels.items())},
                "port_argument_bytes": port_args,
            })
            cell["memory"].update({
                "output_size_in_bytes": _tensor_bytes(out),
                "temp_size_in_bytes": max(counter.peak - port_args, 0),
            })
            if keep:
                cell["_trace"] = {"args": args, "out": out}
    except Exception as e:  # noqa: BLE001 - the refusal is the result
        cell["status"] = "error"
        cell["error"] = f"{type(e).__name__}: {e}"
        cell["traceback"] = traceback.format_exc()[-4000:]
    _dump(cell, out_dir, tag)
    return cell


def _dump(cell, out_dir, tag="") -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    sfx = f"__{tag}" if tag else ""
    path = os.path.join(
        out_dir, f"{cell['arch']}__{cell['shape']}__{cell['mesh']}{sfx}.json")
    slim = {k: v for k, v in cell.items()
            if k not in ("traceback", "_trace")}
    with open(path, "w") as f:
        json.dump(slim, f, indent=1)
    if cell.get("traceback"):
        with open(path + ".err", "w") as f:
            f.write(cell["traceback"])


def _parse_mesh(s: str):
    return tuple(int(x) for x in s.lower().split("x"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry-run (arch x shape x mesh) cells on fake tensors.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--dp-mode", default="gspmd")
    ap.add_argument("--tag", default="")
    ap.add_argument("--param-dtype", default="")
    ap.add_argument("--kv-quant", default="")
    ap.add_argument("--weight-wire", default="")
    ap.add_argument("--mesh", default="",
                    help="a mesh of this shape (1, 2x2, 2x2x2) in place of "
                         "the production one")
    args = ap.parse_args(argv)
    overrides = {}
    if args.param_dtype:
        overrides["param_dtype"] = args.param_dtype
    if args.kv_quant:
        overrides["kv_quant"] = args.kv_quant
    if args.weight_wire:
        overrides["weight_wire"] = args.weight_wire
    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    mesh_shape = _parse_mesh(args.mesh) if args.mesh else None
    meshes = ([False, True] if args.both_meshes and mesh_shape is None
              else [args.multi_pod])
    n_ok = n_skip = n_err = 0
    for arch, shape in cells:
        for mp in meshes:
            cell = run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                            dp_mode=args.dp_mode, tag=args.tag,
                            overrides=overrides, mesh_shape=mesh_shape)
            status = cell["status"]
            n_ok += status == "ok"
            n_skip += status == "skipped"
            n_err += status == "error"
            msg = f"[{status:7s}] {arch:24s} {shape:12s} {cell['mesh']:11s}"
            if "memory" in cell:
                gb = cell["memory"]["argument_size_in_bytes"] / 1e9
                msg += f" args={gb:.3f}GB/dev"
            if status == "ok":
                msg += (f" trace={cell['trace_s']:6.1f}s "
                        f"flops={cell['flops']:.3e} "
                        f"coll={cell['collectives']['total_bytes']:.3e}B")
            elif status == "error":
                msg += " " + cell["error"][:120]
            print(msg, flush=True)
    print(f"dryrun: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
