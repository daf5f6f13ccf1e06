"""Train launcher: a registered arch (reduced or full config) on one
device, or data parallel over the ranks of a ``torch.distributed`` job,
with checkpointing and preemption handling.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi3-medium-14b --reduced --steps 20

    # manual data parallel (ZeRO-1) over two ranks, takum16 gradient rings
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch phi3-medium-14b --reduced \
        --steps 2 --dp-mode manual --grad-compress takum16 --device cpu

    # the same job with each rank started by hand
    RANK=<r> WORLD_SIZE=2 PYTHONPATH=src python -m repro_torch.launch.train \
        ... --dp-mode manual --coordinator localhost:29500

Runs on ``cuda`` unless ``--device`` names another device.
``--dp-mode manual`` runs ``trainer.make_train_step_manual`` on a
``(ranks, 1)`` mesh of ``("data", "model")``: each rank takes its rows of
``SyntheticLM``'s global batch, and ``--grad-compress`` (``takum16``,
``takum8``, ``posit16``, ...) compresses its gradient rings. The ranks
come from ``--coordinator host:port`` (``RANK`` and ``WORLD_SIZE`` in
each rank's environment, torchrun's variables), else from torchrun's
environment; without either the launcher runs one rank, where every ring
is the identity. The backend is gloo on the CPU, NCCL where each rank has
a CUDA device of its own, and gloo where ranks share a card (their hops
staged through host memory, ``dist/collectives.py``). Rank 0 prints the
audit line and the step lines and writes the checkpoints.
``--dp-mode gspmd`` is the one-device step: it takes neither
``--grad-compress`` (one device has no ring) nor a job of several ranks.
"""

import argparse
import os
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import QuantConfig, RuntimeConfig
from repro_torch.data import pipeline as dp
from repro_torch.device import resolve_device
from repro_torch.launch.env import log_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.optim import adamw as opt
from repro_torch.train import trainer


def init_ranks(coordinator: str, device: torch.device):
    """``(rank, world, device)`` of this process: the process group
    initialised from ``--coordinator`` (``tcp://host:port``, rank and
    world size from ``RANK`` / ``WORLD_SIZE``) or from torchrun's
    environment, else one rank with no group. A CUDA rank takes
    ``cuda:(LOCAL_RANK % device_count)``; NCCL where every local rank has
    its own card, gloo otherwise."""
    import torch.distributed as dist
    env = os.environ
    if coordinator:
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in env]
        if missing:
            raise ValueError(f"--coordinator {coordinator} needs "
                             f"{' and '.join(missing)} in each rank's "
                             "environment (torchrun's variables)")
        init = f"tcp://{coordinator}"
    elif all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                "MASTER_PORT")):
        init = "env://"
    else:
        return 0, 1, device
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    backend = "gloo"
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        if device.index is None:
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if torch.cuda.device_count() >= int(env.get("LOCAL_WORLD_SIZE",
                                                    world)):
            backend = "nccl"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            device_id=device if backend == "nccl" else None)
    return rank, world, device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch: the ranks' rows together")
    ap.add_argument("--dp-mode", default="gspmd",
                    choices=["gspmd", "manual"])
    ap.add_argument("--grad-compress", default="none",
                    help="takum16/takum8 for manual dp-mode rings")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="block")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--coordinator", default="",
                    help="host:port of rank 0's rendezvous for a job of "
                    "RANK / WORLD_SIZE ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    runtime = RuntimeConfig(remat=args.remat, microbatch=args.microbatch,
                            quant=QuantConfig(
                                grad_allreduce=args.grad_compress))
    compress = trainer.grad_spec_from_quant(runtime.quant.grad_allreduce)
    if args.dp_mode == "gspmd" and compress is not None:
        ap.error(f"--grad-compress {args.grad_compress} compresses the "
                 "manual data-parallel rings: --dp-mode gspmd runs one "
                 "device, which has no ring (use --dp-mode manual)")
    rank, world, dev = init_ranks(args.coordinator,
                                  resolve_device(args.device))
    try:
        if args.dp_mode == "gspmd" and world > 1:
            ap.error(f"a job of {world} ranks trains with --dp-mode "
                     "manual; --dp-mode gspmd runs one device")
        return _train(args, runtime, compress, rank, world, dev)
    finally:
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, runtime, compress, rank, world, dev):
    say = print if rank == 0 else (lambda *a, **k: None)
    log_config(say)
    spec = get_arch(args.arch)
    cfg = spec.reduced if args.reduced else spec.config
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)

    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    ds = dp.SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)

    if args.dp_mode == "manual":
        mesh = make_mesh((world, 1), ("data", "model"))
        state, flat_spec = trainer.init_flat_state(params, dp=world)
        step_fn = trainer.make_train_step_manual(
            cfg, ocfg, runtime, mesh, flat_spec, compress=compress)
    else:
        state = opt.init_state(params)
        step_fn = trainer.make_train_step(cfg, ocfg, runtime)

    mgr = CheckpointManager(args.ckpt_dir, save_interval=50) \
        if args.ckpt_dir and rank == 0 else None
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        params, state, metrics = step_fn(params, state, ds.batch_at(step))
        losses.append(float(metrics["loss"]))
        if step % 5 == 0 or step == args.steps - 1:
            say(f"step {step:4d} loss {losses[-1]:.4f} "
                f"({time.time() - t0:.1f}s)", flush=True)
        if mgr:
            mgr.maybe_save(step, {"params": params})
    if mgr:
        mgr.wait()
    return params, state, losses


if __name__ == "__main__":
    main()
