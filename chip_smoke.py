#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one summary line each; any failure exits non-zero:

1. device and build: the card, its power limit, and the nvcc build of
   every ``src/repro_torch/csrc/*.cu`` for sm_90a (registers and spills
   from ``-Xptxas -v``);
2. codec: the decode and encode kernels against the plain torch codec on
   the card, bit-exact, over every takum8/takum16 word and >= 1M floats
   (random, special, subnormal);
3. wire matmul at phi3-medium-14b shapes (decode M = 4 and prefill
   M = 256), takum8 and takum16, against decode + f32 matmul, within
   the worst-case f32 bound and a statistical one tight enough to catch
   x rounded to TF32 or bf16 (shown on control products in this run);
4. attention: a 1024-row prefill chunk (contiguous cache) and a paged
   decode step (B = 4, Hkv = 10, G = 4, hd = 128, page 256, varied pos,
   an idle slot with a stale pos, one NaR word) against their plain
   versions;
5. serving at the full width of phi3-medium-14b (40 layers, takum8
   wire weights and KV, random weights from a seeded generator on the
   card): 4 requests of about 77, 300, 520 and 1024 prompt tokens and
   16 new tokens each through ``ServeEngine.submit``/``run``, with every
   kernel's launch count from that run;
6. the reduced config served on the card and on the CPU (plain
   versions): identical greedy tokens, logits within tolerance.

Then the ``kernels`` line (each kernel's launches on the main path, its
check, its time, the plain version's time and the bound) and, last,
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
U32 = 2.0 ** -24                 # f32 unit roundoff
# statistical limit on two f32 sums of the same K products in different
# orders: |err| <= C_STAT * sqrt(K) * u * ||x_i * w_j||_2 elementwise. The
# reorder error of one sum has a standard deviation of about
# 0.4 sqrt(K) u ||t||_2 for these zero-mean random products, so C_STAT
# leaves a wide margin; x rounded to TF32 (10 mantissa bits) errs by about
# 2^13 / (1.7 sqrt(K)) >= 35 of these units per element at K <= 17920
C_STAT = 16.0
ATTN_ATOL = 2e-5                 # the reference's attention tolerance


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` warm launches (events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the larger of the two floors."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def round_mantissa(torch, x, drop: int):
    """f32 rounded to nearest-even with its ``drop`` low mantissa bits
    cleared (13: TF32, 16: bf16)."""
    b = x.contiguous().view(torch.int32)
    b = (b + ((1 << (drop - 1)) - 1) + ((b >> drop) & 1)) & -(1 << drop)
    return b.view(torch.float32)


def codec_err(torch, got, want) -> float:
    """Largest |got - want| over decoded values; equal infinities and
    NaNs in the same places count 0, any other NaN counts inf."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return float(torch.nan_to_num(diff, nan=float("inf")).max())


def phase(n: int, name: str, **fields) -> None:
    print(f"phase {n} {name}: " + json.dumps(fields, sort_keys=False))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on the card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    detail = {}
    t_start = time.perf_counter()

    from repro_torch import formats
    from repro_torch.configs import get_arch
    from repro_torch.core import takum
    from repro_torch.core.bitops import carrier, to_words
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import takum_attention as kattn
    from repro_torch.kernels import takum_codec, takum_matmul
    from repro_torch.models import layers as L
    from repro_torch.models import model, transformer
    from repro_torch.serve.engine import ServeEngine, quantize_weights

    # -- 1. device and build ---------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    builds = {}
    for src, info in build.BUILD_INFO.items():
        if info["log"] == "(cached)":     # built earlier: no ptxas log
            builds[src] = "cached"
            continue
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", info["log"])]
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", info["log"]))
        builds[src] = {"kernels": len(regs), "max_registers": max(regs or [0]),
                       "spill_bytes": spills, "seconds": round(info["seconds"], 2)}
    phase(1, "device+build", device=name, count=count, card=card,
          torch=torch.__version__, cuda=torch.version.cuda,
          nvcc="-gencode arch=compute_90a,code=sm_90a -O3 (src/repro_torch/csrc)",
          build_seconds=round(build_s, 2), builds=builds)
    detail["build"] = builds

    t8, t16 = formats.get("takum8"), formats.get("takum16")
    kernels = {}

    # -- 2. codec --------------------------------------------------------
    codec = {}
    codec_worst = 0.0
    for spec in (t8, t16):
        words = to_words(torch.arange(2 ** spec.n, device=dev),
                         spec.word_dtype)
        got = takum_codec.decode(words, spec)
        want = ref.decode_ref(words, spec)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"decode kernel differs from the plain codec ({spec.name})")
        dec_err = codec_err(torch, got, want)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(1 << 20, generator=g, device=dev)
        x = x * torch.pow(10.0, torch.randint(-45, 39, x.shape, device=dev,
                                              generator=g).float())
        raw = torch.randint(-2 ** 31, 2 ** 31, (1 << 18,), device=dev,
                            generator=g, dtype=torch.int64).to(torch.int32)
        sub = torch.randint(1, 2 ** 23, (1 << 16,), device=dev, generator=g,
                            dtype=torch.int32)
        special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                float("nan"), 1e-45, -1e-45, 1.1754942e-38,
                                3.4028235e38, -3.4028235e38], device=dev)
        xs = torch.cat([x, raw.view(torch.float32), sub.view(torch.float32),
                        -sub.view(torch.float32), special])
        gw = takum_codec.encode(xs, spec)
        ww = ref.encode_ref(xs, spec)
        check(torch.equal(carrier(gw), carrier(ww)),
              f"encode kernel differs from the plain codec ({spec.name})")
        enc_err = codec_err(torch, ref.decode_ref(gw, spec),
                            ref.decode_ref(ww, spec))
        codec_worst = max(codec_worst, dec_err, enc_err)
        codec[spec.name] = {"words": 2 ** spec.n, "floats": xs.numel(),
                            "bit_exact": True, "decode_max_abs_err": dec_err,
                            "encode_max_abs_err": enc_err}
    phase(2, "codec", **codec)

    # -- 3. wire matmul ---------------------------------------------------
    shapes = [(4, 5120, 5120), (4, 5120, 1280), (4, 5120, 17920),
              (4, 17920, 5120), (256, 5120, 5120), (256, 5120, 1280),
              (256, 5120, 17920), (256, 17920, 5120)]
    mm = []
    worst = 0.0
    ratio = {"kernel": 0.0, "tf32_x": float("inf"), "bf16_x": float("inf")}
    for spec in (t8, t16):
        for m, k, n in shapes:
            g = torch.Generator(device=dev).manual_seed(m + k + n)
            x = torch.randn((m, k), generator=g, device=dev)
            w = takum_codec.encode(torch.randn((k, n), generator=g,
                                               device=dev) / k ** 0.5, spec)
            wf = ref.decode_ref(w, spec)
            got = takum_matmul.qmatmul(x, w, spec)
            want = ref.qmatmul_ref(x, w, spec)
            # worst case: two f32 sums of the same K products in any order
            # differ by at most 2 K u sum|x_k w_k| (u = 2^-24), elementwise
            tol = 2 * k * U32 * (x.abs() @ wf.abs())
            # statistical: C_STAT sqrt(K) u ||x_i * w_j||_2 (see C_STAT)
            stat = C_STAT * k ** 0.5 * U32 * ((x * x) @ (wf * wf)).sqrt()
            err = (got - want).abs()
            check(bool((err <= tol).all()),
                  f"qmatmul {spec.name} {m}x{k}x{n}: error over the f32 bound")
            r_kernel = float((err / stat).max())
            check(r_kernel <= 1.0, f"qmatmul {spec.name} {m}x{k}x{n}: error "
                  f"{r_kernel:.3g} x the statistical limit")
            # controls: the plain product with x rounded to TF32 / bf16 must
            # break the statistical limit, or the limit could not see them
            ctrl = {}
            for key, drop in (("tf32_x", 13), ("bf16_x", 16)):
                xe = round_mantissa(torch, x, drop)
                e = (ref.qmatmul_ref(xe, w, spec) - want).abs()
                ctrl[key] = float((e / stat).max())
                check(ctrl[key] > 1.0, f"qmatmul {spec.name} {m}x{k}x{n}: a "
                      f"{key} product passes the statistical limit")
                ratio[key] = min(ratio[key], ctrl[key])
            ratio["kernel"] = max(ratio["kernel"], r_kernel)
            worst = max(worst, float(err.max()))
            mm.append({"fmt": spec.name, "m": m, "k": k, "n": n,
                       "max_abs_err": float(err.max()),
                       "max_err_over_bound": float((err / tol).max()),
                       "max_err_over_stat_limit": r_kernel,
                       "control_max_err_over_stat_limit": ctrl})
            del x, w, wf, got, want, tol, stat, err
    phase(3, "wire matmul", shapes=len(mm), max_abs_err=worst,
          tolerance="2*K*2^-24*(|x|@|w|) elementwise (worst case) and "
                    f"{C_STAT:g}*sqrt(K)*2^-24*sqrt((x*x)@(w*w)) (statistical): "
                    "f32 sums over K <= 17920 in another order",
          kernel_max_over_stat_limit=ratio["kernel"],
          tf32_x_control_min_over_stat_limit=ratio["tf32_x"],
          bf16_x_control_min_over_stat_limit=ratio["bf16_x"])
    detail["matmul_checks"] = mm

    # -- 4. attention -----------------------------------------------------
    hkv, grp, hd, ps = 10, 4, 128, 256
    g = torch.Generator(device=dev).manual_seed(4)
    # contiguous: the last 256-token chunk of a 1024-token prompt
    tq, pos0, tcache = 256, 768, 1280
    q = torch.randn((1, tq, hkv * grp, hd), generator=g, device=dev)
    kc = takum_codec.encode(torch.randn((1, tcache, hkv, hd), generator=g,
                                        device=dev), t8)
    vc = takum_codec.encode(torch.randn((1, tcache, hkv, hd), generator=g,
                                        device=dev), t8)
    start0 = torch.zeros(1, dtype=torch.int32, device=dev)
    q4 = kattn.to_rows(q, hkv).contiguous()
    got = kattn.attention(q4, kc, vc, pos0, start0, spec=t8, bk=ps, tq=tq)
    want = kattn.to_rows(ref.attention_ref(q, kc, vc, 8, t8, pos=pos0,
                                           start=start0), hkv)
    attn_err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and attn_err <= ATTN_ATOL,
          f"contiguous attention off by {attn_err}")
    # paged: 4 sequences, one idle slot with a stale pos, one NaR word
    npg, pool_pages = 5, 24
    kp = takum_codec.encode(torch.randn((pool_pages, ps, hkv, hd), generator=g,
                                        device=dev), t8)
    vp = takum_codec.encode(torch.randn((pool_pages, ps, hkv, hd), generator=g,
                                        device=dev), t8)
    table = torch.tensor([[1, 2, 0, 0, 0], [3, 4, 5, 0, 0],
                          [6, 7, 8, 9, 10], [0, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([76, 520, 1023, 4000], dtype=torch.int32, device=dev)
    startp = torch.zeros(4, dtype=torch.int32, device=dev)
    kp[4, 10, 3, 7] = takum.nar_word(8)       # seq 1, position 266, head 3
    qd = torch.randn((4, 1, hkv * grp, hd), generator=g, device=dev)
    qd4 = kattn.to_rows(qd, hkv).contiguous()
    gotp = kattn.paged_attention(qd4, kp, vp, pos, startp, table, spec=t8)
    wantp = kattn.to_rows(ref.paged_attention_ref(qd, kp, vp, table, t8,
                                                  pos=pos, start=startp), hkv)
    nan_ok = torch.equal(torch.isnan(gotp), torch.isnan(wantp))
    poisoned = bool(torch.isnan(gotp[1, 3]).all())
    clean = int(torch.isnan(gotp).sum()) == grp * hd
    fin = torch.isfinite(wantp)
    paged_err = float((gotp[fin] - wantp[fin]).abs().max())
    check(nan_ok and poisoned and clean and paged_err <= ATTN_ATOL,
          f"paged attention: nan_ok={nan_ok} poisoned={poisoned} "
          f"clean={clean} err={paged_err}")
    phase(4, "attention", contiguous_rows=q4.shape[2],
          contiguous_max_abs_err=attn_err, paged_max_abs_err=paged_err,
          nar_rows_poisoned=poisoned, tolerance=ATTN_ATOL)

    # -- kernel times at the main path's shapes ---------------------------
    # the codec pair (decode and encode kernels of codec.cu) is one entry:
    # on the serving path the encode kernel writes every K/V append (timed
    # here at one layer's K append of a prefill chunk); the decode kernel
    # is the standalone op, its device function inlined into the matmul
    # and attention kernels (timed at a weight-sized word tensor)
    def codec_times(fn, plain, x, nbytes, iters):
        b_ms, b_by = bound(nbytes, 0)
        return {"shape": list(x.shape), "ms": cuda_ms(torch, lambda: fn(x, t8),
                                                      iters=iters),
                "plain_ms": cuda_ms(torch, lambda: plain(x, t8), iters=3,
                                    warmup=1),
                "bound_ms": b_ms, "bound_by": b_by}

    kv_prefill = torch.randn((1, ps, hkv, hd), device=dev)
    kv_step = torch.randn((4, 1, hkv, hd), device=dev)
    w_f32 = torch.randn((5120, 17920), device=dev)
    w_t8 = takum_codec.encode(w_f32, t8)
    codec_t = {
        "encode_kv_prefill_chunk": codec_times(
            takum_codec.encode, ref.encode_ref, kv_prefill,
            kv_prefill.numel() * 5, 200),
        "encode_kv_decode_step": codec_times(
            takum_codec.encode, ref.encode_ref, kv_step,
            kv_step.numel() * 5, 200),
        "encode_weights": codec_times(
            takum_codec.encode, ref.encode_ref, w_f32,
            w_f32.numel() * 5, 20),
        "decode_weights": codec_times(
            takum_codec.decode, ref.decode_ref, w_t8,
            w_t8.numel() * 5, 20)}
    del w_f32, w_t8
    main_t = codec_t["encode_kv_prefill_chunk"]
    kernels["takum_codec"] = dict(
        route="cuda", source="src/repro_torch/csrc/codec.cu",
        replaces="src/repro/kernels/takum_codec.py:73",
        also_replaces="src/repro/kernels/takum_codec.py:56",
        max_abs_err=codec_worst, shape=main_t["shape"], ms=main_t["ms"],
        plain_ms=main_t["plain_ms"], bound_ms=main_t["bound_ms"],
        bound_by=main_t["bound_by"], library_ms=None, detail=codec_t)
    detail["codec_times"] = codec_t
    # qmatmul: every projection shape of a layer, decode and prefill
    mm_times = []
    for m, k, n in shapes:
        x = torch.randn((m, k), device=dev)
        w = takum_codec.encode(torch.randn((k, n), device=dev) / k ** 0.5, t8)
        b_ms, b_by = bound(m * k * 4 + k * n + m * n * 4, 2 * m * k * n)
        row = {"m": m, "k": k, "n": n,
               "ms": cuda_ms(torch, lambda: takum_matmul.qmatmul(x, w, t8)),
               "plain_ms": cuda_ms(torch, lambda: ref.qmatmul_ref(x, w, t8),
                                   iters=5),
               "bound_ms": b_ms, "bound_by": b_by}
        mm_times.append(row)
        del x, w
    detail["matmul_times_takum8"] = mm_times
    rep = next(r for r in mm_times if (r["m"], r["k"], r["n"]) == (4, 5120, 17920))
    kernels["qmatmul"] = dict(
        route="cuda", source="src/repro_torch/csrc/qmatmul.cu",
        replaces="src/repro/kernels/takum_matmul.py:105", max_abs_err=worst,
        shape=[4, 5120, 17920], ms=rep["ms"], plain_ms=rep["plain_ms"],
        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=None)
    # contiguous attention: the 1024-row chunk above
    keys_needed = sum(pos0 + r + 1 for r in range(tq)) * grp * hkv
    b_ms, b_by = bound(q4.numel() * 4 * 2 + 2 * (pos0 + tq) * hkv * hd,
                       4 * hd * keys_needed)
    kf = ref.decode_ref(kc, t8)[:, :pos0 + tq].transpose(1, 2)
    vf = ref.decode_ref(vc, t8)[:, :pos0 + tq].transpose(1, 2)
    qf = q.transpose(1, 2)
    causal = (torch.arange(pos0 + tq, device=dev)[None, :]
              <= (pos0 + torch.arange(tq, device=dev))[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernels["attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/attention.cu",
        replaces="src/repro/kernels/takum_attention.py:158",
        max_abs_err=attn_err, shape=list(q4.shape),
        ms=cuda_ms(torch, lambda: kattn.attention(q4, kc, vc, pos0, start0,
                                                  spec=t8, bk=ps, tq=tq)),
        plain_ms=cuda_ms(torch, lambda: ref.attention_ref(
            q, kc, vc, 8, t8, pos=pos0, start=start0), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, lambda: sdpa(qf, kf, vf, attn_mask=causal,
                                               enable_gqa=True)),
        library_call="scaled_dot_product_attention on K/V decoded to f32 "
                     "beforehand (decode not timed)")
    # paged attention: the decode step above (keys each sequence needs)
    need = [min(int(p) + 1, npg * ps) for p in pos.tolist()]
    b_ms, b_by = bound(qd4.numel() * 4 * 2 + sum(need) * hkv * hd * 2,
                       4 * hd * grp * hkv * sum(need))
    kernels["paged_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/attention.cu",
        replaces="src/repro/kernels/takum_attention.py:301",
        max_abs_err=paged_err, shape=list(qd4.shape),
        ms=cuda_ms(torch, lambda: kattn.paged_attention(
            qd4, kp, vp, pos, startp, table, spec=t8), iters=50),
        plain_ms=cuda_ms(torch, lambda: ref.paged_attention_ref(
            qd, kp, vp, table, t8, pos=pos, start=startp), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del kc, vc, kp, vp, kf, vf, q, q4, qd, qd4, got, want, gotp, wantp
    torch.cuda.empty_cache()

    # -- 5. serving at full width -----------------------------------------
    cfg = dataclasses.replace(get_arch("phi3-medium-14b").config,
                              kv_quant="takum8")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = L.embed_init(gen, cfg.vocab, cfg.d_model, dtype=torch.bfloat16,
                          device=dev)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dev)
    params["layers"] = []
    for _ in range(cfg.n_layers):
        layer = transformer.init_layer(gen, cfg, device=dev)
        params["layers"].append(quantize_weights(layer, "takum8",
                                                 mode="wire", verbose=False))
        del layer
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    eng = ServeEngine(params, cfg, max_len=1280, page_size=ps,
                      decode_batch=4, device=dev)
    sched = eng.scheduler()
    walls = {"prefill": 0.0, "decode": 0.0}
    steps = {"prefill": 0, "decode": 0}

    def timed(fn, key, state):
        def wrapped():
            busy = sum(1 for s in sched._slots
                       if s is not None and s.state == state)
            if key == "decode":
                busy = min(busy, 1)     # one packed step for all slots
            torch.cuda.synchronize()
            t = time.perf_counter()
            events = list(fn())
            torch.cuda.synchronize()
            walls[key] += time.perf_counter() - t
            steps[key] += busy
            yield from events
        return wrapped

    # host clock around each scheduler phase, synchronised on both sides
    sched._prefill_tick = timed(sched._prefill_tick, "prefill", "prefilling")
    sched._decode_step = timed(sched._decode_step, "decode", "active")
    g = torch.Generator().manual_seed(5)
    plens = (77, 300, 520, 1024)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in plens]
    wrappers = {"takum_decode": takum_codec.decode,
                "takum_encode": takum_codec.encode,
                "qmatmul": takum_matmul.qmatmul,
                "attention": kattn.attention,
                "paged_attention": kattn.paged_attention}
    entry_of = {"takum_decode": "takum_codec", "takum_encode": "takum_codec"}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, 16) for p in prompts]
    stamps = {r: [] for r in rids}       # host time of each streamed token
    for ev in eng.run():
        stamps[ev.rid].append(time.perf_counter() - t0)
    n_events = sum(len(v) for v in stamps.values())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    ttft = [round(stamps[r][0], 3) for r in rids]
    gaps = sorted(b - a for r in rids
                  for a, b in zip(stamps[r], stamps[r][1:]))
    launches = {k: fn.launches for k, fn in wrappers.items()}
    outs = [eng.result(r) for r in rids]
    check(n_events == 64, f"{n_events} tokens streamed, wanted 64")
    for p, o in zip(prompts, outs):
        check(o[:len(p)] == p and len(o) == len(p) + 16
              and all(0 <= t < cfg.vocab for t in o[len(p):]),
              "served output has the wrong shape or tokens out of vocab")
    for k in wrappers:
        entry = kernels[entry_of.get(k, k)]
        entry["launches"] = entry.get("launches", 0) + launches[k]
    for k, entry in kernels.items():
        check(entry["launches"] > 0, f"kernel {k} was not launched by the "
              "serving run")
    # the first served token of the shortest request is the argmax of a
    # fresh single-request prefill (serving is batch-invariant)
    cache = model.init_cache(cfg, 1, 2 * ps, device=dev)
    toks = torch.zeros((1, ps), dtype=torch.long)
    toks[0, :plens[0]] = torch.as_tensor(prompts[0])
    row, _ = model.prefill_chunk(eng.params, toks.to(dev), cfg, cache, pos=0,
                                 last_idx=plens[0] - 1)
    check(bool(torch.isfinite(row).all()), "prefill logits not finite")
    check(int(row.argmax()) == outs[0][plens[0]],
          "served first token differs from a fresh prefill's argmax")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serve = {"layers": cfg.n_layers, "d_model": cfg.d_model,
             "prompt_tokens": sum(plens), "generated_tokens": n_events,
             "weights_s": round(weights_s, 2), "serve_s": round(serve_s, 3),
             "prefill_s": round(walls["prefill"], 3),
             "prefill_chunks": steps["prefill"],
             "decode_s": round(walls["decode"], 3),
             "decode_steps": steps["decode"],
             "decode_ms_per_step": round(1e3 * walls["decode"]
                                         / max(steps["decode"], 1), 2),
             "ttft_s": ttft,
             "token_gap_ms_median": round(1e3 * gaps[len(gaps) // 2], 1),
             "token_gap_ms_max": round(1e3 * gaps[-1], 1),
             "peak_gb": round(peak_gb, 2), "launches": launches, "card": card}
    phase(5, "serving phi3-medium-14b full width", **serve)
    detail["serving"] = serve
    del eng, sched, params, cache
    torch.cuda.empty_cache()

    # -- 6. reduced model, card against CPU --------------------------------
    rcfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                               kv_quant="takum8")
    rparams = quantize_weights(model.init(torch.Generator().manual_seed(0),
                                          rcfg, device="cpu"), "takum8",
                               mode="wire", verbose=False)
    rng = torch.Generator().manual_seed(3)
    rprompts = [torch.randint(0, rcfg.vocab, (n,), generator=rng).tolist()
                for n in (16, 9, 4, 13)]
    toks_by = {}
    rows = {}
    for d in ("cpu", dev):
        e = ServeEngine(rparams, rcfg, max_len=48, page_size=16, device=d)
        toks_by[str(d)] = (e.generate(rprompts, 8), e.generate(rprompts, 8))
        c = model.init_cache(rcfg, 1, 32, device=d)
        t = torch.zeros((1, 16), dtype=torch.long)
        t[0, :13] = torch.as_tensor(rprompts[3])
        rows[str(d)], _ = model.prefill_chunk(e.params, t.to(d), rcfg, c,
                                              pos=0, last_idx=12)
    same = toks_by["cpu"] == toks_by[str(dev)]
    lerr = float((rows["cpu"] - rows[str(dev)].cpu()).abs().max())
    check(same, "reduced model: card and CPU tokens differ")
    check(lerr <= 1e-4, f"reduced model: card and CPU logits differ by {lerr}")
    phase(6, "reduced model card vs cpu", tokens_identical=same,
          logits_max_abs_err=lerr, tolerance=1e-4)

    # -- the kernels line and the last line --------------------------------
    order = ["takum_codec", "qmatmul", "attention", "paged_attention"]
    line = {"kernels": [dict(name=k, **kernels[k]) for k in order]}
    detail.update(kernels=line["kernels"], card=card, device=name,
                  seconds=time.perf_counter() - t_start)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
