"""Sharded-serving parity selftest: gloo ranks on the CPU.

``python -m repro_torch.serve.shard_selftest --world N`` (default 4)
spawns N ranks, runs every sharded case that fits N on them, holds each
against the single-rank engine on the same weights, prints one line a
case and ``SHARD SELFTEST OK``, and exits 0. The weights are the port's
own ``model.init`` from a seed; ``tests/test_torch_shard.py`` runs the
same job on the reference's weights and holds it to the JAX engine too.

The pins (the reference's ``serve/shard_selftest.py``): serving over a
mesh is a re-layout, so for the same prompts at :func:`serve_cfg`
(reduced phi3-medium-14b, 16/8 heads, takum8 pages, page 8, decode
batch 4, prompts of 12/5/9/17 tokens, 8 new):

* gather mode, uncompressed, at tp 2 and 4: greedy and seeded-sampling
  tokens equal to the single-rank engine's, and ``PagePool.stats()``
  too; one prefill chunk's logits within ``LOGITS_TOL`` (bit-equal or
  not is reported: a matmul over a column slice may sum in another
  order); at tp 2 also ``generate_lockstep``'s greedy tokens;
* dp 2 x tp 2 greedy tokens and stats;
* psum mode at tp 2: greedy tokens (another order of summation, so the
  logits agree to round-off only);
* takum8 and lns-takum8 wire weights at tp 2 (the ``WireMatrix``
  column slices; the LNS matmul): greedy tokens;
* takum16-compressed collectives at tp 2: the right lengths, the prompt
  kept, ``tp_res_o``/``tp_res_m`` in every attention node with finite,
  non-zero norms, and ``tp.res_norm/<site>`` gauges at ``REPRO_OBS=2``;
* reduced granite-moe-3b-a800m at tp 2: greedy tokens (its expert
  stacks replicated, as the reference's, whose tp 2 tokens equal its
  single-device ones).

A job of N ranks runs its cases in rounds: each case takes a block of
``plan.size`` ranks joined by a process group of their own (a plan's
mesh is the whole group), and the other ranks take the next case.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.launch.mesh import RANK_TIMEOUT

PROMPT_LENS = (12, 5, 9, 17)
MAX_NEW = 8
MAX_LEN = 32
LOGITS_TOL = 1e-5      # gather mode against one rank, f32 on the CPU
MOE_ARCH = "granite-moe-3b-a800m"

# name -> (ShardPlan arguments, weights, what runs)
CASES = {
    "tp4": (dict(tp=4), "float", ("greedy", "seeded", "logits")),
    "dp2tp2": (dict(tp=2, dp=2), "float", ("greedy",)),
    "tp2": (dict(tp=2), "float", ("greedy", "seeded", "logits",
                                  "lockstep")),
    "psum2": (dict(tp=2, mode="psum"), "float", ("greedy",)),
    "wire2": (dict(tp=2), "takum8", ("greedy",)),
    "takum16": (dict(tp=2, compress="takum16"), "float", ("compressed",)),
    "lns2": (dict(tp=2), "lns-takum8", ("greedy",)),
    "moe2": (dict(tp=2), "moe", ("greedy",)),
}


def serve_cfg(arch: str = "phi3-medium-14b"):
    """16 query heads and 8 KV heads, so tp 4 still owns 2 KV heads a
    rank; takum8 pages keep the codec in the loop."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).reduced
    if arch == "phi3-medium-14b":
        cfg = dataclasses.replace(cfg, n_heads=16, n_kv_heads=8)
    return dataclasses.replace(cfg, kv_quant="takum8")


def prompts(cfg):
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(1, cfg.vocab - 1, size=n)]
            for n in PROMPT_LENS]


def build_engine(cfg, params, plan=None, temperature=0.0, device="cpu"):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(params, cfg, max_len=MAX_LEN, temperature=temperature,
                       page_size=8, decode_batch=4, shard=plan, device=device)


def _stats(eng) -> dict:
    return dataclasses.asdict(eng.scheduler().pool.stats())


def serve_greedy(eng, toks):
    return eng.generate(toks, MAX_NEW), _stats(eng)


def serve_seeded(eng, toks):
    rids = [eng.submit(p, MAX_NEW, temperature=0.8, top_p=0.9, seed=123 + i)
            for i, p in enumerate(toks)]
    for _ in eng.run():
        pass
    return [eng.result(r) for r in rids], _stats(eng)


def serve_lockstep(eng, toks):
    """The static-batch loop's greedy tokens (left-padded prompts, one
    contiguous cache)."""
    return eng.generate_lockstep(toks, MAX_NEW)


def prefill_logits(eng, toks) -> np.ndarray:
    """The logits of one 16-token chunk of the longest prompt on a fresh
    contiguous cache (the engine's prompt-chunk step)."""
    from repro_torch.models import model
    p = max(toks, key=len)[:16]
    tokens = torch.zeros((1, 16), dtype=torch.long)
    tokens[0, :len(p)] = torch.as_tensor(p)
    cache = model.init_cache(eng.run_cfg, 1, 32, device=eng.device)
    with torch.no_grad():
        row, _ = eng.prefill_chunk(tokens.to(eng.device), cache, pos=0,
                                   last_idx=len(p) - 1)
    return row.cpu().numpy()


def make_weights(seed: int = 0) -> dict:
    """The port's own weights for the selftest (``model.init`` from a
    seed, on the CPU): float, takum8 and lns-takum8 wire, and reduced
    granite-moe."""
    from repro_torch.models import model
    from repro_torch.serve.engine import quantize_weights
    cfg = serve_cfg()
    params = model.init(torch.Generator().manual_seed(seed), cfg,
                        device="cpu")
    moe = model.init(torch.Generator().manual_seed(seed), serve_cfg(MOE_ARCH),
                     device="cpu")
    return {"float": params,
            "takum8": quantize_weights(params, "takum8", mode="wire",
                                       verbose=False),
            "lns-takum8": quantize_weights(params, "lns-takum8",
                                           mode="wire", verbose=False),
            "moe": moe}


def single_rank(weights: dict, names, device="cpu") -> dict:
    """The single-rank engine's results for the cases ``names`` (a plan
    of one rank is the plain engine): for the float weights greedy and
    seeded tokens, their page stats and the prefill logits; the greedy
    tokens under every other weight key, by that key."""
    from repro_torch.serve.shard import ShardPlan
    one = ShardPlan(tp=1)
    out = {}
    for wkey in dict.fromkeys(CASES[n][1] for n in names):
        cfg = serve_cfg(MOE_ARCH if wkey == "moe" else "phi3-medium-14b")
        toks = prompts(cfg)

        def engine(temperature=0.0):
            return build_engine(cfg, weights[wkey], one, temperature, device)

        if wkey != "float":
            out[wkey] = serve_greedy(engine(), toks)[0]
            continue
        out["greedy"], out["stats"] = serve_greedy(engine(), toks)
        out["seeded"], out["sstats"] = serve_seeded(engine(), toks)
        out["logits"] = prefill_logits(engine(), toks)
        out["lockstep"] = serve_lockstep(engine(), toks)
    return out


def rounds(world: int, names=None):
    """The cases (of ``names``, default all) that fit ``world`` ranks,
    packed into rounds: a list of rounds, each a list of (case, first
    rank, size)."""
    from repro_torch.serve.shard import ShardPlan
    pending = [n for n in (names or CASES)
               if ShardPlan(**CASES[n][0]).size <= world]
    out = []
    while pending:
        cur, free = [], world
        for n in list(pending):
            size = ShardPlan(**CASES[n][0]).size
            if size <= free:
                cur.append((n, world - free, size))
                free -= size
                pending.remove(n)
        out.append(cur)
    return out


def run_case(name: str, weights: dict, device="cpu") -> dict:
    """One case on this rank (inside its process group), on ``device``
    (the plan's: ``cuda:(rank % device_count)`` for ``"cuda"``)."""
    from repro_torch.dist.tp import RESIDUAL_KEYS, residual_norms
    from repro_torch.serve.shard import ShardPlan
    plan_kw, wkey, what = CASES[name]
    plan = ShardPlan(**plan_kw)
    cfg = serve_cfg(MOE_ARCH if wkey == "moe" else "phi3-medium-14b")
    params, toks = weights[wkey], prompts(cfg)
    res = {}
    def engine(temperature=0.0):
        return build_engine(cfg, params, plan, temperature, device)

    if "greedy" in what:
        eng = engine()
        # a multi-rank decode step runs eagerly on every backend
        res["eager"] = not eng.graphable
        res["greedy"], res["stats"] = serve_greedy(eng, toks)
    if "seeded" in what:
        res["seeded"], res["sstats"] = serve_seeded(engine(), toks)
    if "logits" in what:
        res["logits"] = prefill_logits(engine(), toks)
    if "lockstep" in what:
        res["lockstep"] = serve_lockstep(engine(), toks)
    if "compressed" in what:
        old = os.environ.get("REPRO_OBS")
        os.environ["REPRO_OBS"] = "2"
        try:
            eng = engine()
            res["greedy"], _ = serve_greedy(eng, toks)
        finally:
            if old is None:
                del os.environ["REPRO_OBS"]
            else:
                os.environ["REPRO_OBS"] = old
        sched = eng.scheduler()
        res["leaves"] = [sorted(k for k in node if k in RESIDUAL_KEYS)
                         for node in sched.pool.cache]
        res["norms"] = residual_norms(sched.pool.cache)
        res["gauges"] = sorted(k for k in sched.obs.metrics.snapshot()
                               if k.startswith("tp.res_norm/"))
    return res


def rank_main(rank: int, world: int, tmp: str, weights_path: str,
              device="cpu", names=None) -> None:
    """One rank of the job (``torch.multiprocessing.spawn``'s target):
    for each round, its case in a process group of that case's ranks,
    the results into ``tmp/<case>_<rank in case>.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    weights = torch.load(weights_path, weights_only=False)
    for i, cur in enumerate(rounds(world, names)):
        for name, first, size in cur:
            if not first <= rank < first + size:
                continue
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp}/pg_{i}_{first}",
                world_size=size, rank=rank - first,
                timeout=RANK_TIMEOUT)
            try:
                res = run_case(name, weights, device)
                dist.barrier()
            finally:
                dist.destroy_process_group()
            torch.save(res, os.path.join(tmp, f"{name}_{rank - first}.pt"))


def run_job(world: int, weights: dict, tmp: str, device="cpu",
            names=None) -> dict:
    """Spawn ``world`` ranks on ``weights`` (the cases ``names``, default
    all, on ``device``); returns, a case each, every rank's results (a
    list in rank order)."""
    import torch.multiprocessing as mp
    path = os.path.join(tmp, "weights.pt")
    torch.save(weights, path)
    mp.spawn(rank_main, args=(world, tmp, path, device, names),
             nprocs=world, join=True)
    out = {}
    for cur in rounds(world, names):
        for name, _, size in cur:
            out[name] = [torch.load(os.path.join(tmp, f"{name}_{r}.pt"),
                                    weights_only=False) for r in range(size)]
    return out


def check(results: dict, want: dict) -> list:
    """Hold every case's results (each rank's) against the single-rank
    ``want``; returns one line a case. Raises AssertionError on a
    mismatch."""
    lines = []
    for name, ranks in results.items():
        first = ranks[0]
        for r, got in enumerate(ranks[1:], 1):
            for key in ("greedy", "seeded", "stats", "sstats", "lockstep"):
                assert got.get(key) == first.get(key), \
                    f"{name}: rank {r}'s {key} differs from rank 0's"
        what = CASES[name][2]
        wkey = CASES[name][1]
        if wkey != "float":
            assert first["greedy"] == want[wkey], \
                f"{name}: greedy tokens on the {wkey} weights diverged"
        if "greedy" in what:
            assert first["eager"], f"{name}: a multi-rank step is graphable"
        if wkey == "float" and "greedy" in what:
            assert first["greedy"] == want["greedy"], \
                f"{name}: greedy tokens diverged from one rank"
            if CASES[name][0].get("mode", "gather") == "gather":
                assert first["stats"] == want["stats"], (
                    f"{name}: page accounting diverged: {first['stats']} != "
                    f"{want['stats']}")
        if "seeded" in what:
            assert first["seeded"] == want["seeded"], \
                f"{name}: seeded tokens diverged from one rank"
            assert first["sstats"] == want["sstats"], \
                f"{name}: seeded page accounting diverged"
        if "lockstep" in what:
            assert first["lockstep"] == want["lockstep"], \
                f"{name}: lockstep tokens diverged from one rank"
        note = ""
        if "logits" in what:
            diff = float(np.max(np.abs(first["logits"] - want["logits"])))
            assert diff <= LOGITS_TOL, f"{name}: logits differ by {diff}"
            note = (" logits bit-equal" if diff == 0.0
                    else f" logits within {diff:.2e}")
        if "compressed" in what:
            toks = prompts(serve_cfg())
            for p, o in zip(toks, first["greedy"]):
                assert len(o) == len(p) + MAX_NEW, (len(o), len(p))
                assert o[:len(p)] == list(p), \
                    f"{name}: the compressed run lost the prompt"
            assert all(leaves == ["tp_res_m", "tp_res_o"]
                       for leaves in first["leaves"]), first["leaves"]
            norms = [v for rk in ranks for v in rk["norms"].values()]
            assert norms and all(np.isfinite(norms)) and all(
                v > 0 for v in norms), norms
            assert first["gauges"] == sorted(
                f"tp.res_norm/{k}" for k in first["norms"]), first["gauges"]
            note = f" residual norms {min(norms):.3e}..{max(norms):.3e}"
        lines.append(f"# {name}: parity ok{note}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4,
                    help="ranks to spawn (gloo, CPU)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    weights = make_weights()
    with tempfile.TemporaryDirectory() as tmp:
        results = run_job(args.world, weights, tmp)
    for line in check(results, single_rank(weights, list(results))):
        print(line)
    print("SHARD SELFTEST OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
