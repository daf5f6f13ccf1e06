"""Time the port's wire matmul, LNS matmul and attention kernels, and the
build-time choices of its kernels, on one CUDA card.

    python3 tools/torch_kernel_times.py [--src DIR] [--attention] [--lns]
        [--paged] [--serve N [--eager]] [--step-trace] [--moe-trace]
        [--variants] [--out F]

Times ``takum_matmul.qmatmul`` for takum8, takum16, posit8 (through the
table) and posit16 words at every projection shape of a phi3-medium-14b
layer (decode M = 4 and a prefill chunk M = 256), with CUDA events. The
package is imported from ``--src`` (default: this checkout's ``src``), so
two trees can be timed in one call on one card, an older one too: only
``formats.get``, ``takum_codec.encode`` and ``takum_matmul.qmatmul`` are
used there.

``--attention`` also times contiguous attention at the 1024-row chunk
of a 256-token prefill for every KV format the tree's kernels take.

``--lns`` also times ``lns_matmul.lns_matmul`` (linear accumulation) on
lns-takum8 and lns-takum16 words at the same eight shapes, and reads
``nvidia-smi``'s SM clock and power draw while 256x5120x17920 lns-takum8
calls keep the card busy.

``--paged`` also times paged attention at ``chip_smoke.py`` phase 4's
decode step (B 4, Hkv 10, G 4, hd 128, page 256, pos 76 / 520 / 1023 and
an idle slot) for every KV format the tree's kernels take.

``--serve N`` also serves ``chip_smoke.py`` phase 5's (takum8 weights
and KV cache), phase 10's (lns-takum8), phase 15's (posit8) and phase
18's (takum8 weights, a bf16 cache) requests at full width with N new
tokens each, through ``chip_smoke.serve_full_width`` on the ``--src``
tree, and keeps each run's decode step, median token gap and prefill
time: the serving comparison of two trees under one harness. The decode
step is replayed from a CUDA graph where the tree does so; ``--eager``
serves under its ``disable_graphs()`` instead (a tree without graphs
always serves eagerly), so that an older tree, this tree eager and this
tree replayed compare under one harness.

``--step-trace`` (this checkout only) serves phase 5's and phase 10's
requests at full width until the decode step has been captured, then
replays the captured step alone: its device time per step (CUDA events
over back-to-back replays) and a ``torch.profiler`` trace of a few
replays, the device time summed by kernel (the port's kernels by name,
cuBLAS, and the PyTorch ops between them): where a replayed step's time
goes. ``--moe-trace`` does the same for phase 26's (granite-moe-3b-a800m)
and phase 27's (kimi-k2-1t-a32b, 1 layer) step, with the moe block's
ops grouped (expert products, routing sorts, dispatch and combine).

``--variants`` (this checkout's kernels only) also builds the sources
again with the defines that undo one choice each, and times them against
the default build on the same inputs:

* ``FLASH_KSPLIT=1`` / ``=2``: contiguous attention with one group of 4
  warps, or two groups splitting the keys, for every KV format (the
  default takes two for 16-bit words decoded by computation);
* ``TF32_GUARD_ALWAYS=1``: the prefill matmul and contiguous attention
  with tf32.cuh's guards on every tile (the default takes them only on
  tiles that hold a value that needs them);
* ``WIRE_TAKUM8_COMPUTED=1``: takum8 words by the computed decode in
  every kernel instead of the 256-entry table, and lns-takum8 words by
  the computed LNS decode in the LNS matmul instead of its 256-entry
  table of lv pairs;

and, not a build, the LNS matmul's K-split target for prefill chunks
(``lns_matmul.TILE_PER_SM``: 6, 12 and the default) at the four prefill
shapes.

Prints the card (``nvidia-smi``'s name and power limit) and one JSON
object as its last line; ``--out`` writes the same object to a file.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import cuda_ms, graph_ms  # noqa: E402  (the repo's root)

MM_SHAPES = [(4, 5120, 5120), (4, 5120, 1280), (4, 5120, 17920),
             (4, 17920, 5120), (256, 5120, 5120), (256, 5120, 1280),
             (256, 5120, 17920), (256, 17920, 5120)]
MM_FORMATS = ("takum8", "takum16", "posit8", "posit16")
KV_FORMATS = ("takum8", "takum16", "lns-takum8", "lns-takum16", "posit8",
              "posit16", "bf16", "f32")
# variant builds: name -> (sources, defines)
VARIANTS = {
    "ksplit1": (("flash_attention",), ("-DFLASH_KSPLIT=1",)),
    "ksplit2": (("flash_attention",), ("-DFLASH_KSPLIT=2",)),
    "guard_always": (("qmatmul", "flash_attention"),
                     ("-DTF32_GUARD_ALWAYS=1",)),
    "takum8_computed": (("qmatmul", "flash_attention", "attention", "codec",
                         "lns_matmul"),
                        ("-DWIRE_TAKUM8_COMPUTED=1",)),
}


def graph_or_none(torch, fn, iters=20):
    """``chip_smoke.graph_ms``, or None where ``fn`` cannot be captured in
    a CUDA graph (a wrapper of an older tree that syncs with the host)."""
    try:
        return graph_ms(torch, fn, iters=iters)
    except RuntimeError:
        torch.cuda.synchronize()
        return None


def matmul_times(torch, dev, formats, takum_codec, takum_matmul,
                 names=MM_FORMATS, shapes=MM_SHAPES):
    """{"<format> MxKxN": ms} on seeded N(0, 1/K) weights."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(3)
    for name in names:
        spec = formats.get(name)
        for m, k, n in shapes:
            x = torch.randn((m, k), generator=g, device=dev)
            w = takum_codec.encode(torch.randn((k, n), generator=g,
                                               device=dev) / k ** 0.5, spec)
            out[f"{name} {m}x{k}x{n}"] = cuda_ms(
                torch, lambda: takum_matmul.qmatmul(x, w, spec))
            del x, w
    return out


def attention_times(torch, dev, names=KV_FORMATS):
    """{"<format>": ms} of contiguous attention at the 1024-row chunk
    (G 4 x 256 rows, 10 KV heads, hd 128, pos 768)."""
    from repro_torch import formats
    from repro_torch.kernels import takum_codec
    from repro_torch.kernels import takum_attention as kattn
    hkv, grp, hd, tq, pos0, tcache = 10, 4, 128, 256, 768, 1280
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((1, tq, hkv * grp, hd), generator=g, device=dev)
    q4 = kattn.to_rows(q, hkv).contiguous()
    kf = torch.randn((1, tcache, hkv, hd), generator=g, device=dev)
    vf = torch.randn((1, tcache, hkv, hd), generator=g, device=dev)
    start0 = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {}
    for name in names:
        if name in ("bf16", "f32"):
            spec = formats.get("none")
            dt = torch.bfloat16 if name == "bf16" else torch.float32
            kc, vc = kf.to(dt), vf.to(dt)
        else:
            spec = formats.get(name)
            kc, vc = takum_codec.encode(kf, spec), takum_codec.encode(vf, spec)
        try:
            out[name] = cuda_ms(torch, lambda: kattn.attention(
                q4, kc, vc, pos0, start0, spec=spec, bk=256, tq=tq),
                iters=50)
        except (NotImplementedError, TypeError):
            out[name] = None       # a format this tree's kernels refuse
    return out


def lns_times(torch, dev, names=("lns-takum8", "lns-takum16"),
              shapes=MM_SHAPES, graph=True):
    """{"<format> MxKxN": ms} of the linear LNS matmul on seeded words (x
    from N(0, 1), w from N(0, 1/K), both encoded to ``format``), and with
    ``graph`` {"<format> MxKxN graph": ms} replayed from a CUDA graph."""
    from repro_torch import formats
    from repro_torch.kernels import lns_matmul as klns
    from repro_torch.kernels import takum_codec
    out = {}
    g = torch.Generator(device=dev).manual_seed(6)
    for name in names:
        spec = formats.get(name)
        for m, k, n in shapes:
            x = takum_codec.encode(torch.randn((m, k), generator=g,
                                               device=dev), spec)
            w = takum_codec.encode(torch.randn((k, n), generator=g,
                                               device=dev) / k ** 0.5, spec)
            iters = 5 if m * k * n > 5e9 else 20
            out[f"{name} {m}x{k}x{n}"] = cuda_ms(
                torch, lambda: klns.lns_matmul(x, w, spec), iters=iters)
            if graph:
                out[f"{name} {m}x{k}x{n} graph"] = graph_or_none(
                    torch, lambda: klns.lns_matmul(x, w, spec), iters=iters)
            del x, w
    return out


def paged_inputs(torch, dev, g):
    """Phase 4's decode step: q rows, an f32 pool of 24 pages, the block
    table, pos and start."""
    hkv, hd = 10, 128
    kf = torch.randn((24, 256, hkv, hd), generator=g, device=dev)
    vf = torch.randn((24, 256, hkv, hd), generator=g, device=dev)
    qd4 = torch.randn((4, hkv, 4, hd), generator=g, device=dev)
    table = torch.tensor([[1, 2, 0, 0, 0], [3, 4, 5, 0, 0],
                          [6, 7, 8, 9, 10], [0, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([76, 520, 1023, 4000], dtype=torch.int32, device=dev)
    startp = torch.zeros(4, dtype=torch.int32, device=dev)
    return qd4, kf, vf, table, pos, startp


def paged_times(torch, dev, names=KV_FORMATS):
    """{"<format>": ms} of paged attention at phase 4's decode step, and
    {"<format> graph": ms} replayed from a CUDA graph."""
    from repro_torch import formats
    from repro_torch.kernels import takum_codec
    from repro_torch.kernels import takum_attention as kattn
    g = torch.Generator(device=dev).manual_seed(7)
    qd4, kf, vf, table, pos, startp = paged_inputs(torch, dev, g)
    out = {}
    for name in names:
        if name in ("bf16", "f32"):
            spec = formats.get("none")
            dt = torch.bfloat16 if name == "bf16" else torch.float32
            kp, vp = kf.to(dt), vf.to(dt)
        else:
            spec = formats.get(name)
            kp, vp = takum_codec.encode(kf, spec), takum_codec.encode(vf, spec)
        def call():
            return kattn.paged_attention(qd4, kp, vp, pos, startp, table,
                                         spec=spec)
        try:
            out[name] = cuda_ms(torch, call, iters=100)
        except (NotImplementedError, TypeError, ValueError):
            out[name] = None       # a format this tree's kernels refuse
            continue
        out[f"{name} graph"] = graph_or_none(torch, call, iters=100)
    return out


def serve_times(torch, dev, max_new, eager=False):
    """{"phase 5 takum8" | "phase 10 lns-takum8" | "phase 15 posit8" |
    "phase 18 bf16 cache": {...}}: chip_smoke.py's serving runs of those
    phases with ``max_new`` new tokens a request (``eager``: under
    ``disable_graphs()``)."""
    from chip_smoke import PHASE5_PLENS, PHASE10_PLENS, serve_full_width
    from repro_torch.kernels import lns_matmul as klns
    from repro_torch.kernels import takum_attention as kattn
    from repro_torch.kernels import takum_codec, takum_matmul
    wrappers = {"takum_decode": takum_codec.decode,
                "takum_encode": takum_codec.encode,
                "qmatmul": takum_matmul.qmatmul,
                "lns_matmul": klns.lns_matmul,
                "attention": kattn.attention,
                "paged_attention": kattn.paged_attention}
    if hasattr(takum_codec, "kv_append"):
        wrappers["kv_append"] = takum_codec.kv_append
    keep = ("decode_ms_per_step", "decode_steps", "token_gap_ms_median",
            "prefill_s", "prefill_chunks", "step", "graphs_captured",
            "capture_step_ms", "launches")
    out = {}
    for name, wfmt, kv, plens in (
            ("phase 5 takum8", "takum8", "takum8", PHASE5_PLENS),
            ("phase 10 lns-takum8", "lns-takum8", "lns-takum8",
             PHASE10_PLENS),
            ("phase 15 posit8", "posit8", "posit8", PHASE10_PLENS),
            ("phase 18 bf16 cache", "takum8", "none", PHASE10_PLENS)):
        max_len = -(-(max(plens) + max_new) // 256) * 256
        serve = serve_full_width(torch, dev, wfmt=wfmt, kv=kv, plens=plens,
                                 max_new=max_new, max_len=max_len,
                                 wrappers=wrappers, eager=eager)
        out[name] = {k: serve[k] for k in keep}
    return out


# kernel name fragments -> the group a trace sums them into
TRACE_GROUPS = (("kv_append_kernel", "kv_append"),
                ("encode_kernel", "encode (LNS activations)"),
                ("attn_kernel", "paged attention"),
                ("split_sum_kernel", "matmul K-split sums"),
                ("stream_kernel", "wire / LNS matmul, streaming"),
                ("gemm", "cuBLAS (bf16 unembed)"),
                ("xmma", "cuBLAS (bf16 unembed)"),
                ("cutlass", "cuBLAS (bf16 unembed)"),
                ("nvjet", "cuBLAS (bf16 unembed)"))
# the moe block's ops, for --moe-trace: cuBLAS there is the experts'
# batched products (and the router and unembed), the sorts are routing
MOE_GROUPS = (("gemm", "cuBLAS (expert bmm, router, unembed)"),
              ("xmma", "cuBLAS (expert bmm, router, unembed)"),
              ("cutlass", "cuBLAS (expert bmm, router, unembed)"),
              ("nvjet", "cuBLAS (expert bmm, router, unembed)"),
              ("sort", "sorts (top-k, argsort, combine order)"),
              ("Sort", "sorts (top-k, argsort, combine order)"),
              ("radix", "sorts (top-k, argsort, combine order)"),
              ("scatter", "dispatch / combine gathers and scatters"),
              ("gather", "dispatch / combine gathers and scatters"),
              ("index", "dispatch / combine gathers and scatters"))


def step_trace(torch, dev, replays=50, traced=5):
    """{"phase 5 takum8" | "phase 10 lns-takum8": {...}}: the captured
    decode step of those phases' serving runs, replayed alone."""
    from chip_smoke import (PHASE5_PLENS, PHASE10_PLENS, full_width_cfg,
                            full_width_params)
    out = {}
    for name, fmt, plens in (("phase 5 takum8", "takum8", PHASE5_PLENS),
                             ("phase 10 lns-takum8", "lns-takum8",
                              PHASE10_PLENS)):
        cfg = full_width_cfg(fmt)
        params, _ = full_width_params(torch, dev, cfg, fmt)
        out[name] = trace_step(torch, dev, cfg, params, plens, replays,
                               traced)
        del params
        torch.cuda.empty_cache()
    return out


def moe_trace(torch, dev, replays=50, traced=5):
    """{"phase 26 granite-moe-3b-a800m" | "phase 27 kimi-k2-1t-a32b": ...}:
    the captured decode step of chip_smoke.py's moe phases, replayed
    alone, the moe block's ops grouped."""
    from chip_smoke import MOE_PHASES, PHASE5_PLENS, moe_cfg, moe_params
    out = {}
    for n, (arch, layers) in zip((26, 27), MOE_PHASES):
        cfg = moe_cfg(arch, layers)
        params, _, _ = moe_params(torch, dev, cfg, torch.float32
                                  if layers is None else torch.bfloat16)
        out[f"phase {n} {arch}"] = trace_step(
            torch, dev, cfg, params, PHASE5_PLENS, replays, traced,
            groups=MOE_GROUPS + TRACE_GROUPS)
        del params
        torch.cuda.empty_cache()
    return out


def trace_step(torch, dev, cfg, params, plens, replays, traced,
               groups=TRACE_GROUPS):
    """Serve ``plens`` until the decode step has been captured, then replay
    the captured step alone: CUDA events over ``replays`` back-to-back
    replays and a ``torch.profiler`` trace of ``traced``, the device time
    summed by kernel and by the first of ``groups`` whose fragment the
    kernel's name holds."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, max_len=1280, page_size=256,
                      decode_batch=4, device=dev)
    sched = eng.scheduler()
    g = torch.Generator().manual_seed(5)
    for n in plens:
        eng.submit(torch.randint(0, cfg.vocab, (n,), generator=g)
                   .tolist(), 64)
    run = eng.run()
    while sched.step.replays < 3:       # the step captured, replayed
        next(run)
    run.close()                         # the replays below move pos
    graph = next(iter(sched.step._graphs.values())).graph
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(traced):
            graph.replay()
        torch.cuda.synchronize()
    by_kernel, launches = {}, 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue        # host ops: their kernels are counted below
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + t / 1e3 / traced
            launches += e.count
    by_group = {}
    for key, ms in by_kernel.items():
        group = next((g for frag, g in groups if frag in key),
                     "PyTorch ops between the kernels")
        by_group[group] = by_group.get(group, 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    res = {"replay_device_ms": t0.elapsed_time(t1) / replays,
           "traced_device_ms": sum(by_kernel.values()) or None,
           "by_group_ms": by_group,
           "top_kernels_ms": [[k[:120], v] for k, v in top],
           "kernels_traced": len(by_kernel),
           "kernel_launches_per_step": launches / traced}
    del eng, sched, graph, run
    return res


def takum8_times(torch, dev):
    """The kernels that decode takum8 (and lns-takum8) words through a
    table, at the serving shapes."""
    from repro_torch import formats
    from repro_torch.kernels import takum_codec, takum_matmul
    from repro_torch.kernels import takum_attention as kattn
    t8 = formats.get("takum8")
    out = matmul_times(torch, dev, formats, takum_codec, takum_matmul,
                       names=("takum8",),
                       shapes=[(4, 5120, 17920), (256, 5120, 17920)])
    out["attention"] = attention_times(torch, dev, ("takum8",))["takum8"]
    g = torch.Generator(device=dev).manual_seed(5)
    hkv, hd = 10, 128
    kp = takum_codec.encode(torch.randn((24, 256, hkv, hd), generator=g,
                                        device=dev), t8)
    vp = takum_codec.encode(torch.randn((24, 256, hkv, hd), generator=g,
                                        device=dev), t8)
    qd4 = kattn.to_rows(torch.randn((4, 1, 4 * hkv, hd), generator=g,
                                    device=dev), hkv).contiguous()
    table = torch.tensor([[1, 2, 0, 0, 0], [3, 4, 5, 0, 0],
                          [6, 7, 8, 9, 10], [0, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([76, 520, 1023, 4000], dtype=torch.int32, device=dev)
    startp = torch.zeros(4, dtype=torch.int32, device=dev)
    out["paged_attention"] = cuda_ms(torch, lambda: kattn.paged_attention(
        qd4, kp, vp, pos, startp, table, spec=t8), iters=50)
    out.update(lns_times(torch, dev, names=("lns-takum8",),
                         shapes=[(4, 5120, 17920), (256, 5120, 17920)],
                         graph=False))
    w = takum_codec.encode(torch.randn((5120, 17920), generator=g,
                                       device=dev), t8)
    out["decode [5120, 17920]"] = cuda_ms(
        torch, lambda: takum_codec.decode(w, t8))
    return out


def build_variants(build):
    """{variant: {source: library path}}, one nvcc per library, all
    started together, into ``build/repro_torch/variants``."""
    dst = build.BUILD_DIR / "variants"
    dst.mkdir(parents=True, exist_ok=True)
    procs, paths = [], {}
    for var, (sources, defines) in VARIANTS.items():
        for src in sources:
            lib = dst / f"lib{src}-{var}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-I",
                   str(build.CSRC), "-o", str(lib),
                   str(build.CSRC / f"{src}.cu")]
            procs.append((var, src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            paths.setdefault(var, {})[src] = lib
    for var, src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src}.cu ({var}) failed:\n{log}")
    return paths


def swap_in(build, libs):
    """Load ``{source: path}`` in place of the default libraries (the
    wrappers' ctypes signatures); returns what it replaced."""
    from repro_torch.kernels import lns_matmul
    from repro_torch.kernels import takum_attention, takum_codec, takum_matmul
    sigs = {"qmatmul": takum_matmul._SIGNATURES,
            "codec": takum_codec._SIGNATURES,
            "lns_matmul": lns_matmul._SIGNATURES,
            **takum_attention._SIGNATURES}
    old = {}
    for src, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in sigs[src].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        old[src] = build._LIBS.get(src)
        build._LIBS[src] = lib
    return old


def variant_times(torch, dev):
    """Each variant build against the default build, on the same inputs."""
    from repro_torch import formats
    from repro_torch.kernels import build, takum_codec, takum_matmul
    build.build_all()
    paths = build_variants(build)
    prefill = [(256, 5120, 17920), (256, 17920, 5120)]

    def measure():
        return {
            "attention": attention_times(torch, dev),
            "prefill_matmul": matmul_times(torch, dev, formats, takum_codec,
                                           takum_matmul, shapes=prefill),
            "takum8": takum8_times(torch, dev)}

    res = {"default": measure()}
    for var, libs in paths.items():
        old = swap_in(build, libs)
        res[var] = measure()
        for src, lib in old.items():
            build._LIBS[src] = lib
    # the LNS matmul's K-split target for prefill chunks (a launch-plan
    # choice, not a build): blocks queued an SM
    from repro_torch.kernels import lns_matmul as klns
    kept = klns.TILE_PER_SM
    res["lns_tile_per_sm"] = {}
    for per_sm in (6, 12, kept):
        klns.TILE_PER_SM = per_sm
        res["lns_tile_per_sm"][per_sm] = lns_times(
            torch, dev, names=("lns-takum8",),
            shapes=[s for s in MM_SHAPES if s[0] > klns.STREAM_M],
            graph=False)
    klns.TILE_PER_SM = kept
    return res


def busy_clocks(torch, fn, seconds=1.5) -> str:
    """``nvidia-smi``'s SM clock, power draw and limit, read while ``fn``
    keeps the card busy (calls queued for about ``seconds``)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smi = None
    while time.perf_counter() - t0 < seconds:
        fn()
        if smi is None and time.perf_counter() - t0 > seconds / 2:
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw,power.limit", "--format=csv,noheader", "-i",
                 "0"], stdout=subprocess.PIPE, text=True)
    out = smi.communicate()[0].strip() if smi else ""
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--attention", action="store_true")
    ap.add_argument("--lns", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--serve", type=int, default=0, metavar="N")
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--step-trace", action="store_true")
    ap.add_argument("--moe-trace", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import formats
    from repro_torch.kernels import takum_codec, takum_matmul
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    res = {"src": str(Path(args.src).resolve()), "card": card,
           "qmatmul_ms": matmul_times(torch, dev, formats, takum_codec,
                                      takum_matmul)}
    if args.attention:
        res["attention_ms"] = attention_times(torch, dev)
    if args.lns:
        res["lns_ms"] = lns_times(torch, dev)
        from repro_torch import formats as fm
        from repro_torch.kernels import lns_matmul as klns
        spec = fm.get("lns-takum8")
        g = torch.Generator(device=dev).manual_seed(8)
        x = takum_codec.encode(torch.randn((256, 5120), generator=g,
                                           device=dev), spec)
        w = takum_codec.encode(torch.randn((5120, 17920), generator=g,
                                           device=dev), spec)
        res["lns_busy_clocks"] = busy_clocks(
            torch, lambda: klns.lns_matmul(x, w, spec))
        del x, w
    if args.paged:
        res["paged_ms"] = paged_times(torch, dev)
    if args.serve:
        res["serve"] = serve_times(torch, dev, args.serve, args.eager)
    if args.step_trace:
        res["step_trace"] = step_trace(torch, dev)
    if args.moe_trace:
        res["moe_trace"] = moe_trace(torch, dev)
    if args.variants:
        res["variants_ms"] = variant_times(torch, dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
