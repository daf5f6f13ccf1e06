"""Serving launcher: batched generation against a registered arch.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3-medium-14b --reduced --batch 4 --max-new 16 \
        --kv-quant takum16

Runs on ``cuda`` unless ``--device`` names another device. A config
with a frontend stub gets seeded normal media, as the reference's
launcher makes them: ``vision`` ``[batch, n_media_tokens, d_media or
d_model]``, ``audio`` ``[batch, max(prompt_len // 4, 8), d_model]``.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.env import log_config
from repro_torch.models import model
from repro_torch.obs import enabled as obs_enabled
from repro_torch.serve.engine import ServeEngine, quantize_weights


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-quant", default="none")
    ap.add_argument("--weights", default="none",
                    help="'takum8'/'takum16' weight-only quantisation")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto-loadable Chrome trace of the "
                    "run (requires REPRO_OBS=1 or 2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    log_config()
    if args.trace and not obs_enabled():
        ap.error("--trace needs REPRO_OBS=1 (or 2) in the environment")

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.reduced if args.reduced else spec.config
    if args.kv_quant != "none":
        cfg = dataclasses.replace(cfg, kv_quant=args.kv_quant)

    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    if args.weights != "none":
        params = quantize_weights(params, args.weights, cfg=cfg)

    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, args.prompt_len)]
               for _ in range(args.batch)]
    media = None
    if cfg.frontend == "vision":
        media = rng.normal(size=(args.batch, cfg.n_media_tokens,
                                 cfg.d_media or cfg.d_model)).astype(
            np.float32)
    elif cfg.frontend == "audio":
        media = rng.normal(size=(args.batch, max(args.prompt_len // 4, 8),
                                 cfg.d_model)).astype(np.float32)

    eng = ServeEngine(params, cfg, max_len=args.prompt_len + args.max_new + 8,
                      temperature=args.temperature, device=dev)
    t0 = time.time()
    outs = eng.generate(prompts, max_new=args.max_new, media=media)
    dt = time.time() - t0
    total_new = sum(len(o) - args.prompt_len for o in outs)
    print(f"generated {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s)")
    for o in outs[:2]:
        print(" ...", o[-args.max_new:])
    if args.trace:
        # the paged scheduler recorded spans while generate() ran; a
        # sampled run, a media prompt or a family the scheduler refuses
        # goes through lockstep, which has no per-request trace
        if eng.obs is None:
            print("# no trace written: this run used the lockstep path "
                  "(temperature > 0, a media prompt or an unpaged family)")
        else:
            from repro_torch.obs import export
            export.write_chrome(args.trace,
                                eng.trace_records({"arch": args.arch}))
            print(f"# chrome trace -> {args.trace} "
                  "(load in ui.perfetto.dev)")
    return outs


if __name__ == "__main__":
    main()
