"""Time the port's wire matmul, LNS matmul and attention kernels, and the
build-time choices of its kernels, on one CUDA card.

    python3 tools/torch_kernel_times.py [--src DIR] [--attention] [--lns]
        [--append] [--paged] [--serve N [--eager]] [--plan-lookup]
        [--lockstep N] [--step-trace]
        [--moe-trace] [--variants] [--codec] [--codec-widths]
        [--against CSRC] [--sass] [--no-matmul] [--out F]

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

``--append`` also times the fused K/V append (``kv_append``) for every
wire KV format at ``chip_smoke.py`` phase 19's two shapes, from CUDA
graph replays.

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

``--plan-lookup`` also times, on the host, what a wire matmul call
spends choosing its launch plan at phase 5's decode shape (4 x 5120 x
17920, takum8), once resolved: ``cost.is_fake`` of its input and
``autotune.resolved_plan``, in microseconds a call over 10^5 calls, on
the ``--src`` tree (None for a tree without the autotuner).

``--lockstep N`` also serves ``chip_smoke.py`` phase 20's lockstep batch
(phi3-medium-14b at full width, phase 5's prompts left-padded into one
batch, 16 new tokens, takum8 weights and KV) and phase 29's
(recurrentgemma-2b at full width and depth, ``RG_BATCH`` prompts of
``RG_PLEN`` tokens) N times each on the ``--src`` tree, every forward
timed by ``chip_smoke.lockstep_traced``: each run's prefill seconds and
eager decode ms per step, the lockstep comparison of two trees under one
harness.

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

``--codec`` times the fused fake-quant at ``WIDTHS_TIMED`` for each
kind, f32 and bf16 out, on seeded normals and on weights-like values (x
0.02, linear takum scaled as served), and at the served leaves of
phases 26 and 27 (``SERVED_LEAVES``: granite-moe's f32 expert stack,
kimi-k2's bf16 expert slice; takum8 with the leaf's power-of-two scale),
each beside its byte bound; kimi's through the wrapper (the bf16 leaf
cast to f32 first, then the kernel with bf16 out), the kernel alone on
the cast and the cast alone. With ``--against DIR`` both trees' kernels
are timed in turns (against, this, this, against) on the same inputs,
their outputs compared bit for bit.

``--codec-widths`` (this checkout's kernels) reads ``chip_smoke.py``
phase 33's ``width_times`` (the codec's decode and encode at
``WIDTHS_TIMED`` for each kind at ``CODEC_SHAPE``, beside the byte bound,
``torch.index_select`` for decodes to 16 bits, PyTorch's cast over the
same bytes, posit8's computed decode) with the fused fake-quant's time
beside, and the card's rates for plain float32 streams of the same size
(read, write, copy), and fake-quant with bf16 output beside its own byte
bound; then, on this checkout's kernels alone, ``chip_smoke.py`` phase
34's ``wide_times`` (the float64 decode from uint32 words at n = 32, and
at n = 40 and 64 the 64-bit words' decode to float32 and float64, the
encode, and fake-quant to float32, bfloat16 and float64, each beside its
byte bound and PyTorch's cast over the same bytes; keys ``<format>
wide``). Only ``codec.cu`` and ``fake_quant.cu`` are built. ``--against
DIR`` also builds those two sources of another checkout's ``csrc``
directory (its own headers; the same C entry points) and times both in
turns on the same inputs (against, this, this, against), their outputs
compared bit for bit. ``--sass`` counts the SASS
instructions of every codec and fake-quant kernel (``cuobjdump -sass``):
each kernel's total and the span of the longest backward branch whose
body loads from global memory (its main loop, with the rare paths it
branches over) and, for fake-quant's loop, the instructions that an
iteration runs when both its vectors take the value path
(``value_path``), of this build and of ``--against``'s; the listings go
to ``chiprun_out/sass_<source>[_against].txt``.

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
# --codec: the fake-quant calls of phases 26 and 27's set-up, takum8
# with the leaf's power-of-two scale: granite-moe-3b-a800m's expert stack
# [E 40, d 1536, f 512] f32 (the whole stack one launch) and a slice of
# kimi-k2's [384, 7168, 2048] bf16 stacks (4 experts a launch: the
# engine's 2^26-element slices)
SERVED_LEAVES = {"granite-moe expert stack": ((40, 1536, 512), "float32"),
                 "kimi-k2 expert slice": ((4, 7168, 2048), "bfloat16")}


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


def append_times(torch, dev, names=KV_FORMATS[:6]):
    """{"<format> paged|contiguous": ms} of the fused K/V append at
    ``chip_smoke.kv_append_inputs``' two shapes (a decode step into the
    paged pool, a prefill chunk into a contiguous cache) from bf16 K/V,
    replayed from a CUDA graph."""
    from chip_smoke import kv_append_inputs
    from repro_torch import formats
    from repro_torch.kernels import takum_codec
    out = {}
    for name in names:
        spec = formats.get(name)
        for mode in ("paged", "contiguous"):
            k, v, kc, vc, where = kv_append_inputs(
                torch, dev, spec, None, torch.bfloat16, mode, 99)
            out[f"{name} {mode}"] = graph_or_none(
                torch, lambda: takum_codec.kv_append(k, v, kc, vc, spec,
                                                     **where), iters=200)
            del k, v, kc, vc
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


def plan_lookup_us(torch, dev, calls=100_000):
    """Host microseconds a call of ``cost.is_fake`` on a card tensor plus
    ``autotune.resolved_plan`` at phase 5's decode matmul (see
    ``--plan-lookup``), or None where the tree has no autotuner."""
    import time
    try:
        from repro_torch.kernels import autotune, cost
    except ImportError:
        return None
    from repro_torch import formats
    spec = formats.get("takum8")
    x = torch.zeros((4, 5120), device=dev)
    shape = (4, 5120, 17920)
    autotune.resolved_plan("qmatmul", spec, shape)
    t0 = time.perf_counter()
    for _ in range(calls):
        cost.is_fake(x)
        autotune.resolved_plan("qmatmul", spec, shape)
    return (time.perf_counter() - t0) / calls * 1e6


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
    from chip_smoke import MOE_PHASES, PHASE5_PLENS, served_cfg, served_params
    out = {}
    for n, (arch, layers) in zip((26, 27), MOE_PHASES):
        cfg = served_cfg(arch, layers)
        params = served_params(torch, dev, cfg, torch.float32
                               if layers is None else torch.bfloat16)[0]
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
    from repro_torch.kernels import lns_matmul, quantize
    from repro_torch.kernels import takum_attention, takum_codec, takum_matmul
    sigs = {"qmatmul": takum_matmul._SIGNATURES,
            "codec": takum_codec._SIGNATURES,
            "fake_quant": quantize._SIGNATURES,
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


def codec_times(torch, dev, against=None):
    """The fused fake-quant at ``chip_smoke.WIDTHS_TIMED`` for each kind,
    f32 and bf16 out, at ``chip_smoke.CODEC_SHAPE``, on seeded normals
    (``randn``) and on weights (``randn`` x 0.02, linear takum scaled by
    ``FormatSpec.fake_quant``'s power of two, taken once), and takum8 at
    ``SERVED_LEAVES`` in the leaf's dtype (in and out), scaled as served;
    the bf16 leaf also as the kernel alone on its f32 cast and as the
    cast alone. With ``against`` (another checkout's ``csrc``) both
    trees in turns (against, this, this, against) on the same inputs,
    the outputs held equal bit for bit: {"<spec> <dtype> <input>": row}
    with ``ms``[, ``ms_against``, ``bit_equal``] and ``bound_ms`` (the
    bytes read and written over ``chip_smoke.HBM_BW``), and
    ``device_ms``[, ``device_ms_against``] from CUDA graph replays: the
    card's time with no host between the calls (events over calls of
    0.1-0.3 ms also count the host's wrapper where it is the slower side,
    and spread by up to 30% between identical kernels)."""
    from chip_smoke import CODEC_KINDS, CODEC_SHAPE, WIDTHS_TIMED, bound
    from repro_torch import formats
    from repro_torch.core import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize as kquant
    mine = build.build_all(CODEC_SOURCES)
    other = build_against(build, against) if against else None
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(CODEC_SHAPE, generator=g, device=dev)

    def exp_of(spec, v):
        # FormatSpec.fake_quant's power of two, taken once, outside the
        # timed call
        return (int(quant.scale_exponent(
            v.to(torch.float32), quant.QuantSpec(fmt="takum", n=spec.n)))
            if spec.kind == "linear" else 0)

    calls = {}
    for n in WIDTHS_TIMED:
        for kind in CODEC_KINDS:
            spec = formats.resolve(kind, n)
            for dt in (torch.float32, torch.bfloat16):
                for src, v, served in (("randn", x, False),
                                       ("weights", x * 0.02, True)):
                    k = exp_of(spec, v) if served else 0
                    calls[f"{spec.name} {str(dt)[6:]} {src}"] = (
                        lambda v=v, spec=spec, dt=dt, k=k: kquant.fake_quant(
                            v, spec, dtype=dt, scale_exp=k),
                        bound(v.numel() * (4 + dt.itemsize), 0)[0])
    t8 = formats.get("takum8")
    for name, (shape, dtn) in SERVED_LEAVES.items():
        dt = getattr(torch, dtn)
        v = (torch.randn(shape, generator=g, device=dev) * 0.02).to(dt)
        k = exp_of(t8, v)
        calls[f"takum8 {dtn} {name}"] = (
            lambda v=v, dt=dt, k=k: kquant.fake_quant(v, t8, dtype=dt,
                                                      scale_exp=k),
            bound(v.numel() * 2 * dt.itemsize, 0)[0])
        if dt != torch.float32:
            v32 = v.to(torch.float32)
            calls[f"takum8 {dtn} {name}, kernel alone on the f32 cast"] = (
                lambda v=v32, dt=dt, k=k: kquant.fake_quant(
                    v, t8, dtype=dt, scale_exp=k),
                bound(v.numel() * (4 + dt.itemsize), 0)[0])
            calls[f"{name}: the cast to f32 alone"] = (
                lambda v=v: v.to(torch.float32),
                bound(v.numel() * (dt.itemsize + 4), 0)[0])
    turns = ["against", "this", "this", "against"] if other else ["this"]
    res, vals = {}, {}
    for who in turns:
        swap_in(build, other if who == "against" else mine)
        suffix = "_against" if who == "against" else ""
        for key, (fn, bnd) in calls.items():
            row = res.setdefault(key, {"bound_ms": bnd})
            row.setdefault("ms" + suffix, []).append(cuda_ms(torch, fn))
            row.setdefault("device_ms" + suffix, []).append(
                graph_or_none(torch, fn))
            if other and key not in vals.setdefault(who, {}):
                vals[who][key] = fn()
    swap_in(build, mine)
    for key, row in res.items():
        for k, v in row.items():
            if isinstance(v, list):
                row[k] = None if None in v else sum(v) / len(v)
        if other:
            row["bit_equal"] = torch.equal(
                vals["this"][key].view(torch.uint8),
                vals["against"][key].view(torch.uint8))
    return res


CODEC_SOURCES = ("codec", "fake_quant")


def build_against(build, csrc):
    """``csrc``'s codec and fake-quant sources (another checkout's, with
    its own headers) built into ``build/repro_torch/variants``:
    {source: library path}."""
    csrc = Path(csrc).resolve()
    dst = build.BUILD_DIR / "variants"
    dst.mkdir(parents=True, exist_ok=True)
    procs, paths = [], {}
    for src in CODEC_SOURCES:
        lib = dst / f"lib{src}-against.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(lib), str(csrc / f"{src}.cu")]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        paths[src] = lib
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {csrc / src}.cu failed:\n{log}")
    return paths


def codec_width_times(torch, dev, against=None):
    """``chip_smoke.width_times`` at ``WIDTHS_TIMED`` per kind, with the
    fused fake-quant's time and byte bound beside, and with ``against``'s
    libraries in turns when given (against, this, this, against; each
    tree's readings averaged, ``against``'s keys suffixed ``_against``),
    the outputs of both trees on the same inputs held equal bit for bit:
    {spec name: row}."""
    from chip_smoke import CODEC_KINDS, CODEC_SHAPE, WIDTHS_TIMED, bound
    from chip_smoke import width_times
    from repro_torch import formats
    from repro_torch.kernels import build, takum_codec
    from repro_torch.kernels import quantize as kquant
    mine = build.build_all(CODEC_SOURCES)
    other = build_against(build, against) if against else None
    turns = ["against", "this", "this", "against"] if other else ["this"]
    out = {}
    for n in WIDTHS_TIMED:
        for kind in CODEC_KINDS:
            spec = formats.resolve(kind, n)
            g = torch.Generator(device=dev).manual_seed(n)
            x = torch.randn(CODEC_SHAPE, generator=g, device=dev)
            row, outs = {}, {}
            for who in turns:
                swap_in(build, other if who == "against" else mine)
                suffix = "_against" if who == "against" else ""
                r = width_times(torch, dev, n, kind, plain=False)
                r["fake_quant_ms"] = cuda_ms(
                    torch, lambda: kquant.fake_quant(x, spec))
                r["fake_quant_bf16_ms"] = cuda_ms(
                    torch, lambda: kquant.fake_quant(
                        x, spec, dtype=torch.bfloat16))
                for k, v in r.items():
                    if isinstance(v, float) and not k.startswith("bound"):
                        row.setdefault(k + suffix, []).append(v)
                    else:
                        row[k] = v
                if other and who not in outs:
                    words = takum_codec.encode(x, spec)
                    outs[who] = {"encode": words,
                                 "decode": takum_codec.decode(words, spec),
                                 "fake_quant": kquant.fake_quant(x, spec),
                                 "fake_quant_bf16": kquant.fake_quant(
                                     x, spec, dtype=torch.bfloat16)}
            swap_in(build, mine)
            row = {k: sum(v) / len(v) if isinstance(v, list) else v
                   for k, v in row.items()}
            row["fq_bound_ms"] = bound(x.numel() * 8, 0)[0]
            row["fq_bf16_bound_ms"] = bound(x.numel() * 6, 0)[0]
            if other:
                row["equal"] = {op: torch.equal(
                    outs["this"][op].view(torch.uint8),
                    outs["against"][op].view(torch.uint8))
                    for op in outs["this"]}
            out[spec.name] = row
            del x, outs
    # phase 34's cases, this tree's kernels only: the float64 decode from
    # uint32 words (n = 32), and the 64-bit words' decode (float32 and
    # float64), encode and fake-quant (float32, bfloat16, float64 out)
    from chip_smoke import WIDTHS_64_TIMED, wide_times
    for n in (32,) + WIDTHS_64_TIMED:
        for kind in CODEC_KINDS:
            spec = formats.resolve(kind, n)
            out[f"{spec.name} wide"] = wide_times(torch, dev, n, kind,
                                                  plain=False)
    return out


def stream_times(torch, dev):
    """The card's rates for plain streams over ``chip_smoke.CODEC_SHAPE``
    float32 elements (the codec kernels' float side), by PyTorch's own
    calls: read only (``torch.sum``), write only (``zero_``) and a copy
    (``copy_``): {name: {"ms", "bytes", "tb_s"}}."""
    from chip_smoke import CODEC_SHAPE
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(CODEC_SHAPE, generator=g, device=dev)
    y = torch.empty_like(x)
    nb = x.numel() * 4
    out = {}
    for name, fn, nbytes in (("read (sum)", lambda: torch.sum(x), nb),
                             ("write (zero_)", lambda: y.zero_(), nb),
                             ("copy (copy_)", lambda: y.copy_(x), 2 * nb)):
        ms = cuda_ms(torch, fn)
        out[name] = {"ms": ms, "bytes": nbytes, "tb_s": nbytes / ms / 1e9}
    return out


def value_path(ins, span):
    """The instructions that a loop iteration runs when both its vectors
    take fake-quant's value path: from the loop's head to the path's
    branch (the first forward conditional branch after the vote, or
    after the last global load where each lane branches on its own, with
    a global store on one side only before that side's next branch),
    then the value side to the loop's backward branch, conditional
    branches taken as falling through (the second vector is there) and
    unconditional ones followed. None without such a branch. Where the
    value side calls ``logf``/``expf`` (LNS) their special-case branches
    fall through too, so the count is an upper bound there."""
    import re
    bra = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")
    head, end = span
    loop = [(a, o) for a, o in ins if head <= a <= end]
    at = {a: k for k, (a, _) in enumerate(loop)}

    def stores(k):
        for _, o in loop[k:]:
            if o.startswith("STG") or " STG" in o:
                return True
            if re.search(r"\bBRA\b", o):
                return False
        return False

    vote = next((k for k, (_, o) in enumerate(loop) if "VOTE.ALL" in o),
                None)
    start = vote if vote is not None else max(
        (k for k, (_, o) in enumerate(loop) if "LDG" in o), default=0)
    for k in range(start, len(loop)):
        o = loop[k][1]
        m = bra.search(o)
        t = at.get(int(m.group(1), 16)) if m and o.startswith("@") else None
        if t is not None and t > k and stores(k + 1) != stores(t):
            pc = k + 1 if stores(k + 1) else t
            break
    else:
        return None
    count = k + 1
    while pc < len(loop):
        o = loop[pc][1]
        count += 1
        m = bra.search(o)
        if pc == len(loop) - 1:
            break
        if m and not o.startswith("@") and int(m.group(1), 16) in at:
            pc = at[int(m.group(1), 16)]
        else:
            pc += 1
    return count


def sass_counts(build, against=None):
    """{library: {kernel: {"instructions", "loop"[, "value_path"]}}} of
    the codec and fake-quant libraries, this checkout's and
    ``against``'s, from ``cuobjdump -sass``:
    each kernel's instruction count, the span of its longest backward
    branch over a global load (the main loop's body, with every path it
    branches over) and, for fake-quant's loop, the instructions of an
    iteration on the value path (``value_path``), demangled where
    ``c++filt`` is found.
    The listings go to ``chiprun_out``."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = {src: p for src, p in build.build_all(CODEC_SOURCES).items()}
    if against:
        libs.update({f"{src}_against": p for src, p in
                     build_against(build, against).items()})
    outdir = Path(__file__).resolve().parents[1] / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(\S[^;]*);")
    res = {}
    for name, path in libs.items():
        text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        (outdir / f"sass_{name}.txt").write_text(text)
        kernels, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = kernels.setdefault(m.group(1), [])
                continue
            m = insn.search(line)
            if m and cur is not None:
                cur.append((int(m.group(1), 16), m.group(2).strip()))
        rows = {}
        for fn, ins in kernels.items():
            loop, span = 0, None
            for addr, op in ins:
                b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
                if not b or int(b.group(1), 16) >= addr:
                    continue
                body = [o for a, o in ins if int(b.group(1), 16) <= a <= addr]
                if (any(o.split()[0].lstrip("@!P0123456789T ").startswith("LDG")
                        or " LDG" in o for o in body) and len(body) > loop):
                    loop, span = len(body), (int(b.group(1), 16), addr)
            rows[fn] = {"instructions": len(ins), "loop": loop}
            path = (value_path(ins, span)
                    if span and name.startswith("fake_quant") else None)
            if path:
                rows[fn]["value_path"] = path
        filt = shutil.which("c++filt")
        if filt:
            names = subprocess.run([filt], input="\n".join(rows),
                                   capture_output=True, text=True,
                                   check=True).stdout.splitlines()
            rows = dict(zip(names, rows.values()))
        res[name] = rows
    return res


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


def lockstep_times(torch, dev, runs):
    """{"phase 20": [[prefill s, decode ms per step], ...], "phase 29":
    [...]}: ``runs`` lockstep runs each of chip_smoke.py's phase 20 and
    phase 29 batches on the ``--src`` tree (see ``--lockstep``)."""
    import gc
    from chip_smoke import (PHASE5_PLENS, RG_BATCH, RG_NEW, RG_PLEN,
                            full_width_cfg, full_width_params,
                            lockstep_traced, served_cfg, served_params)
    from repro_torch.serve.engine import CACHE_SLACK, ServeEngine
    out = {}
    cfg = full_width_cfg("takum8")
    params, _ = full_width_params(torch, dev, cfg, "takum8")
    g = torch.Generator().manual_seed(5)          # phase 5's prompts
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in PHASE5_PLENS]
    eng = ServeEngine(params, cfg, max_len=1280, page_size=256,
                      decode_batch=4, device=dev)
    out["phase 20"] = [list(lockstep_traced(torch, eng, prompts, 16)[2:])
                       for _ in range(runs)]
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = served_cfg("recurrentgemma-2b")
    params = served_params(torch, dev, cfg, None)[0]
    g = torch.Generator().manual_seed(29)
    prompts = [torch.randint(0, cfg.vocab, (RG_PLEN,), generator=g).tolist()
               for _ in range(RG_BATCH)]
    eng = ServeEngine(params, cfg, max_len=RG_PLEN + RG_NEW + CACHE_SLACK,
                      device=dev)
    out["phase 29"] = [list(lockstep_traced(torch, eng, prompts, RG_NEW,
                                            call=eng.generate)[2:])
                       for _ in range(runs)]
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--attention", action="store_true")
    ap.add_argument("--lns", action="store_true")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--serve", type=int, default=0, metavar="N")
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--plan-lookup", action="store_true")
    ap.add_argument("--lockstep", type=int, default=0, metavar="N")
    ap.add_argument("--step-trace", action="store_true")
    ap.add_argument("--moe-trace", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--codec", action="store_true")
    ap.add_argument("--codec-widths", action="store_true")
    ap.add_argument("--against", default=None, metavar="CSRC")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--no-matmul", action="store_true",
                    help="skip the default wire matmul times")
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
    res = {"src": str(Path(args.src).resolve()), "card": card}
    if not args.no_matmul:
        res["qmatmul_ms"] = matmul_times(torch, dev, formats, takum_codec,
                                         takum_matmul)
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
    if args.append:
        res["append_ms"] = append_times(torch, dev)
    if args.paged:
        res["paged_ms"] = paged_times(torch, dev)
    if args.serve:
        res["serve"] = serve_times(torch, dev, args.serve, args.eager)
    if args.plan_lookup:
        res["plan_lookup_us"] = plan_lookup_us(torch, dev)
    if args.lockstep:
        res["lockstep"] = lockstep_times(torch, dev, args.lockstep)
    if args.step_trace:
        res["step_trace"] = step_trace(torch, dev)
    if args.moe_trace:
        res["moe_trace"] = moe_trace(torch, dev)
    if args.variants:
        res["variants_ms"] = variant_times(torch, dev)
    if args.codec:
        res["codec_ms"] = codec_times(torch, dev, args.against)
    if args.codec_widths:
        res["codec_widths_ms"] = codec_width_times(torch, dev, args.against)
        res["stream_ms"] = stream_times(torch, dev)
    if args.sass:
        from repro_torch.kernels import build
        res["sass"] = sass_counts(build, args.against)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
