"""Data-parallel training selftest: the manual ZeRO-1 step on gloo ranks.

``python -m repro_torch.train.dp_selftest --world N`` (default 4) spawns
N ranks on the CPU (``--device cuda``: each on a card, ``--backend nccl``
where each has its own; the job then also runs on the CPU and is held to
it, :func:`against`), runs every case that fits N on them (three steps of
the reduced phi3-medium-14b at 2 layers, T 32, a global batch of 4 rows
from ``SyntheticLM``), holds each against one rank and prints one line
a case and ``DP SELFTEST OK``:

* every rank's parameters, after every step, bit for bit the same;
* the losses finite, and the uncompressed data-2 run's losses and
  parameter leaves those of ``make_train_step`` on the whole batch within
  ``ONE_RANK_REL`` (relative; the leaves' relative L2);
* the compressed runs' losses beside the uncompressed one's, the pod
  run's error feedback finite and not all zero;
* the bytes a rank sends a step equal ``trainer.step_interconnect_bytes``.

A job of N ranks runs its cases in rounds, as ``serve/shard_selftest.py``
does: each case takes a block of its mesh's ranks, joined by a process
group of their own. ``tests/test_torch_train_dp*.py`` run the same job on
the reference's weights and replay the reference's own flat gradients
through ``trainer.apply_flat_grads`` (:func:`run_case`'s ``replay``);
``chip_smoke.py`` runs it on the card and on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.launch.mesh import RANK_TIMEOUT

LAYERS, SEQ, BATCH, STEPS, SEED = 2, 32, 4, 3, 3
LR = 1e-3
# the uncompressed run against make_train_step on one rank (the ring sums
# two ranks' gradients where one rank's backward sums the batch): losses
# and each parameter leaf's relative L2
ONE_RANK_REL = 1e-5

# name -> (mesh axes and sizes, gradient compression)
CASES = {
    "data2": ((("data", 2),), None),
    "data2_takum16": ((("data", 2),), "takum16"),
    "pod2_data2_takum16": ((("pod", 2), ("data", 2)), "takum16"),
    "pod2_takum16": ((("pod", 2), ("data", 1)), "takum16"),
}


def train_cfg():
    """The reduced phi3-medium-14b at ``LAYERS`` layers."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                               n_layers=LAYERS)


def opt_cfg():
    from repro_torch.optim import adamw as opt
    return opt.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def case_size(name: str) -> int:
    return int(np.prod([s for _, s in CASES[name][0]]))


def rounds(world: int, names=None):
    """The cases (of ``names``, default all) that fit ``world`` ranks,
    packed into rounds: a list of rounds, each a list of (case, first
    rank, size)."""
    pending = [n for n in (names or CASES) if case_size(n) <= world]
    out = []
    while pending:
        cur, free = [], world
        for n in list(pending):
            size = case_size(n)
            if size <= free:
                cur.append((n, world - free, size))
                free -= size
                pending.remove(n)
        out.append(cur)
    return out


def case_mesh(name: str):
    """This rank's mesh for case ``name`` (its axes, then ``model`` 1)."""
    from repro_torch.launch.mesh import make_mesh
    axes = CASES[name][0]
    return make_mesh(tuple(s for _, s in axes) + (1,),
                     tuple(a for a, _ in axes) + ("model",))


def _np_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _torch_tree(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: torch.tensor(np.asarray(a)).to(device),
                    tree)


def fingerprint(params, block: int = 1 << 24) -> list:
    """Every leaf's 32-bit words summed weighted by their positions (int64,
    a block at a time): ranks whose fingerprints agree hold the same bits
    but for a chance of about 2^-60 (the CPU tests compare the leaves
    themselves)."""
    from repro_torch.tree import tree_leaves
    out = []
    for leaf in tree_leaves(params):
        w = leaf.detach().reshape(-1).view(torch.int32)
        total = torch.zeros((), dtype=torch.int64, device=w.device)
        for lo in range(0, w.numel(), block):
            part = w[lo:lo + block].to(torch.int64)
            pos = torch.arange(lo + 1, lo + 1 + part.numel(),
                               device=w.device) * 2654435761
            total += torch.sum(part * (pos % 4294967291))
        out.append(int(total))
    return out


def run_case(name: str, params, device="cpu", replay=None) -> dict:
    """One case on this rank (inside its process group).

    Free-running (``replay`` None): ``STEPS`` manual steps from ``params``
    (the port's tree) on ``SyntheticLM`` batches: every step's metrics,
    bytes sent and parameter fingerprints, the final parameters, this
    rank's state shard and the census.

    Replayed: ``replay`` holds, a step each, the reference's flat state
    before the step (``params`` [G], ``m``, ``v``, ``ef``, ``step``) and
    every rank's flat gradients (``gflat`` [ranks, G]), and ``template``,
    a tree in its layout; each step goes through ``reduce_flat_grads``
    (the chunk and the new error feedback) and ``apply_flat_grads`` (the
    norm, the parameters and this rank's state)."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.dist import collectives as coll
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    cfg, ocfg = train_cfg(), opt_cfg()
    mesh = case_mesh(name)
    comp = trainer.grad_spec_from_quant(CASES[name][1] or "none")
    dp_ = mesh.axis_size("data")
    npod = mesh.axis_size("pod") if "pod" in mesh.axis_names else 1
    res = {"coords": dict(zip(mesh.axis_names, mesh.coords))}
    if replay is not None:
        template = _torch_tree(replay["template"], "cpu")
        spec, padded = opt.flat_spec(template), opt.flat_spec(template, dp_)
        index = mesh.coord("data") + dp_ * (mesh.coord("pod")
                                            if npod > 1 else 0)
        res["replay"] = []
        for r in replay["steps"]:
            gflat = torch.as_tensor(r["gflat"][index]).to(device)
            st = trainer.state_shard(r["m"], r["v"], r["ef"], r["step"],
                                     mesh, device)
            p = opt.unflatten_like(torch.as_tensor(r["params"]).to(device),
                                   spec)
            chunk, new_ef = trainer.reduce_flat_grads(gflat, st.ef, mesh,
                                                      compress=comp)
            p, st, gnorm = trainer.apply_flat_grads(gflat, p, st, mesh, ocfg,
                                                    padded, compress=comp)
            res["replay"].append({
                "chunk": chunk.cpu().numpy(),
                "new_ef": new_ef.contiguous().cpu().numpy(),
                "gnorm": float(gnorm),
                "params": opt.flatten_like(p)[0].cpu().numpy(),
                "m": st.m.cpu().numpy(), "v": st.v.cpu().numpy(),
                "ef": st.ef.contiguous().cpu().numpy()})
        return res
    params = _torch_tree(params, device)
    state, spec = trainer.init_flat_state(params, dp_, npod)
    step = trainer.make_train_step_manual(
        cfg, ocfg, RuntimeConfig(remat="block"), mesh, spec, compress=comp)
    ds = dp.SyntheticLM(cfg.vocab, SEQ, BATCH, seed=SEED)
    res.update(metrics=[], sent=[], fingerprints=[])
    for s in range(STEPS):
        before = coll.transport.bytes_sent
        params, state, met = step(params, state, ds.batch_at(s))
        res["sent"].append(coll.transport.bytes_sent - before)
        res["metrics"].append({k: float(v) for k, v in met.items()})
        res["fingerprints"].append(fingerprint(params))
    res["params"] = _np_tree(params)
    res["state"] = {k: getattr(state, k).contiguous().cpu().numpy()
                    for k in ("m", "v", "ef", "step")}
    res["census"] = trainer.step_interconnect_bytes(
        sum(spec[1]) + spec[4], dp_, npod, comp)
    return res


def rank_main(rank: int, world: int, tmp: str, inputs_path: str,
              device="cpu", names=None, backend="gloo") -> None:
    """One rank of the job (``torch.multiprocessing.spawn``'s target):
    for each round, its case in a process group of that case's ranks,
    the results into ``tmp/<case>_<rank in case>.pt``. On ``cuda`` the
    rank computes on ``cuda:(rank % device_count)``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    if device == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    inputs = torch.load(inputs_path, weights_only=False)
    for i, cur in enumerate(rounds(world, names)):
        for name, first, size in cur:
            if not first <= rank < first + size:
                continue
            # NCCL binds the group to this rank's card (its barrier would
            # otherwise guess the card from the rank within the case)
            dist.init_process_group(
                backend, init_method=f"file://{tmp}/pg_{i}_{first}",
                world_size=size, rank=rank - first, timeout=RANK_TIMEOUT,
                device_id=device if backend == "nccl" else None)
            try:
                res = run_case(name, inputs["params"], device,
                               (inputs.get("replay") or {}).get(name))
                dist.barrier()
            finally:
                dist.destroy_process_group()
            torch.save(res, os.path.join(tmp, f"{name}_{rank - first}.pt"))


def run_job(world: int, inputs: dict, tmp: str, device="cpu",
            names=None, backend="gloo") -> dict:
    """Spawn ``world`` ranks on ``inputs`` (``params``: the port's tree;
    optionally ``replay``: a case each, see :func:`run_case`) for the
    cases ``names`` (default all) on ``device`` over ``backend`` (NCCL
    needs a card a rank); returns, a case each, every rank's results (a
    list in rank order)."""
    import torch.multiprocessing as mp
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    mp.spawn(rank_main, args=(world, tmp, path, device, names, backend),
             nprocs=world, join=True)
    out = {}
    for cur in rounds(world, names):
        for name, _, size in cur:
            out[name] = [torch.load(os.path.join(tmp, f"{name}_{r}.pt"),
                                    weights_only=False) for r in range(size)]
    return out


def make_params(seed: int = 0):
    """The port's own weights for the selftest (``model.init``, CPU)."""
    from repro_torch.models import model
    return model.init(torch.Generator().manual_seed(seed), train_cfg(),
                      device="cpu")


def one_rank(params, device="cpu") -> dict:
    """``make_train_step`` on the whole global batch (one rank): losses
    and the final parameters, on ``device``."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    cfg = train_cfg()
    params = _torch_tree(params, device)
    state = opt.init_state(params)
    step = trainer.make_train_step(cfg, opt_cfg(), RuntimeConfig(
        remat="block"))
    ds = dp.SyntheticLM(cfg.vocab, SEQ, BATCH, seed=SEED)
    losses = []
    for s in range(STEPS):
        params, state, met = step(params, state, ds.batch_at(s))
        losses.append(float(met["loss"]))
    return {"losses": losses, "params": _np_tree(params)}


def leaf_rel_l2(got, want) -> float:
    """The largest relative L2 distance between two trees' leaves."""
    from repro_torch.tree import tree_leaves
    return max(float(np.linalg.norm(np.asarray(a, np.float64) - b)
                     / np.linalg.norm(np.asarray(b, np.float64)))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def check(results: dict, want: dict) -> list:
    """Hold every case's ranks to each other and to one rank's ``want``
    (:func:`one_rank`); returns one line a case. Raises AssertionError."""
    lines = []
    base = results.get("data2")
    for name, ranks in results.items():
        first = ranks[0]
        for r, got in enumerate(ranks[1:], 1):
            assert got["fingerprints"] == first["fingerprints"], \
                f"{name}: rank {r}'s parameters differ from rank 0's"
            assert [m["loss"] for m in got["metrics"]] == \
                [m["loss"] for m in first["metrics"]], \
                f"{name}: rank {r}'s averaged losses differ from rank 0's"
        losses = [m["loss"] for m in first["metrics"]]
        assert np.all(np.isfinite(losses)), f"{name}: losses {losses}"
        for r, got in enumerate(ranks):
            assert got["sent"] == [got["census"]] * STEPS, (
                f"{name}: rank {r} sent {got['sent']} bytes a step, the "
                f"census {got['census']}")
        note = f"losses {', '.join(f'{x:.6f}' for x in losses)}"
        if name == "data2":
            np.testing.assert_allclose(losses, want["losses"],
                                       rtol=ONE_RANK_REL,
                                       err_msg=f"{name}: losses")
            rel = leaf_rel_l2(first["params"], want["params"])
            assert rel <= ONE_RANK_REL, f"{name}: leaves {rel} from one rank"
            note += f" (one rank's within {ONE_RANK_REL:g}; leaves {rel:.1e})"
        elif base is not None:
            rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                      for a, b in zip(first["metrics"], base[0]["metrics"]))
            note += f" (uncompressed's within {rel:.1e})"
        if CASES[name][0][0][0] == "pod":
            ef = np.concatenate([rk["state"]["ef"] for rk in ranks])
            assert np.all(np.isfinite(ef)) and np.any(ef), \
                f"{name}: error feedback {ef[:4]}"
            note += f", error feedback |ef|max {np.abs(ef).max():.2e}"
        lines.append(f"# {name}: {note}")
    return lines


def against(results: dict, other: dict) -> dict:
    """Hold each case's rank 0 to the same case of another job (another
    device's): losses within ``ONE_RANK_REL`` and each leaf within
    ``ONE_RANK_REL`` relative L2. Returns the figures a case; raises
    AssertionError."""
    out = {}
    for name, ranks in results.items():
        got, want = ranks[0], other[name][0]
        lg = [m["loss"] for m in got["metrics"]]
        lw = [m["loss"] for m in want["metrics"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lw))
        l2 = leaf_rel_l2(got["params"], want["params"])
        assert rel <= ONE_RANK_REL and l2 <= ONE_RANK_REL, (
            f"{name}: losses {lg} against {lw}, leaves {l2:.3e} relative L2")
        out[name] = {"losses": lg, "losses_other": lw, "loss_max_rel": rel,
                     "leaf_rel_l2": l2}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4, help="ranks to spawn")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                    help="cuda: each rank on cuda:(rank %% device_count), "
                    "held also against the same job on the CPU")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="nccl needs a card a rank")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build_all()       # once, before the ranks load the libraries
    params = make_params()
    with tempfile.TemporaryDirectory() as tmp:
        results = run_job(args.world, {"params": params}, tmp, args.device,
                          backend=args.backend)
    for line in check(results, one_rank(params, args.device)):
        print(line)
    if args.device == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            cpu = run_job(args.world, {"params": params}, tmp)
        for name, row in against(results, cpu).items():
            print(f"# {name} card against CPU: losses within "
                  f"{row['loss_max_rel']:.1e}, leaves {row['leaf_rel_l2']:.1e}"
                  " relative L2")
    print("DP SELFTEST OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
