"""Train launcher: a registered arch (reduced or full config) on one
device, with checkpointing and preemption handling.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi3-medium-14b --reduced --steps 20

Runs on ``cuda`` unless ``--device`` names another device. The manual
data-parallel mode (``--dp-mode manual``), the gradient compression of
its rings (``--grad-compress``) and multi-host runs (``--coordinator``)
raise: they come with multi-device training (ROADMAP.md section 1
item 6).
"""

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import RuntimeConfig
from repro_torch.data import pipeline as dp
from repro_torch.device import resolve_device
from repro_torch.launch.env import log_config
from repro_torch.models import model
from repro_torch.optim import adamw as opt
from repro_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dp-mode", default="gspmd",
                    choices=["gspmd", "manual"])
    ap.add_argument("--grad-compress", default="none",
                    help="takum16/takum8 for manual dp-mode rings "
                    "(not in the port)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="block")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--coordinator", default="",
                    help="host:port for a multi-host run (not in the port)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    log_config()
    if args.coordinator:
        raise NotImplementedError("multi-host training is not in the port: "
                                  "ROADMAP.md section 1 item 6")
    compress = trainer.grad_spec_from_quant(args.grad_compress)
    if compress is not None:
        raise NotImplementedError("--grad-compress compresses the manual "
                                  "data-parallel rings: "
                                  + trainer.MANUAL_DP_TODO)

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.reduced if args.reduced else spec.config
    runtime = RuntimeConfig(remat=args.remat, microbatch=args.microbatch)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)

    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    ds = dp.SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)

    if args.dp_mode == "manual":
        state, flat_spec = trainer.init_flat_state(params, dp=1)
        step_fn = trainer.make_train_step_manual(
            cfg, ocfg, runtime, None, flat_spec)
    else:
        state = opt.init_state(params)
        step_fn = trainer.make_train_step(cfg, ocfg, runtime)

    mgr = CheckpointManager(args.ckpt_dir, save_interval=50) \
        if args.ckpt_dir else None
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        params, state, metrics = step_fn(params, state, ds.batch_at(step))
        losses.append(float(metrics["loss"]))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if mgr:
            mgr.maybe_save(step, {"params": params})
    if mgr:
        mgr.wait()
    return params, state, losses


if __name__ == "__main__":
    main()
