#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one summary line each; any failure exits non-zero:

1. device and build: the card, its power limit, and the nvcc build of
   every ``src/repro_torch/csrc/*.cu`` for sm_90a (six libraries, one nvcc
   each, all started together; registers and spills from ``-Xptxas -v``);
2. codec: the decode and encode kernels against the plain torch codec on
   the card, bit-exact, over every takum8/takum16 word and >= 1M floats
   (random, special, subnormal);
3. wire matmul at phi3-medium-14b shapes (decode M = 4 through the
   streaming kernel, prefill M = 256 through the split-TF32 tensor-core
   kernel), takum8 and takum16, against decode + f32 matmul, within the
   worst-case f32 bound and a statistical one tight enough to catch x
   rounded to TF32 or bf16 (shown on control products in this run), and
   the same bits from two calls; times per shape, takum8 and takum16;
4. attention: a 1024-row prefill chunk (contiguous cache, the tensor-core
   kernel; then with a NaR K word at a valid position and a NaR V word at
   a masked position of a visited tile, NaN in the plain version's
   places) and a paged decode step (B = 4, Hkv = 10, G = 4, hd = 128,
   page 256, varied pos, an idle slot with a stale pos, one NaR word;
   the flash-decoding kernel: each sequence's in-band keys in partitions
   of 64, merged in order by the last block of each sequence and KV
   head) against their plain versions;
5. serving at the full width of phi3-medium-14b (40 layers, takum8
   wire weights and KV, random weights from a seeded generator on the
   card): 4 requests of about 77, 300, 520 and 1024 prompt tokens and
   16 new tokens each through ``ServeEngine.submit``/``run``, the decode
   step replayed from a CUDA graph (as in phases 10, 15 and 18: the
   graphs captured, the capture time and the replays are reported, and
   ``decode_ms_per_step`` leaves out the step that captured), with every
   kernel's launch count from that run (the K/V words through the fused
   append, one launch a layer call);
6. the reduced config served on the card and on the CPU (plain
   versions): identical greedy tokens, logits within tolerance;
7. LNS codec: every lns-takum8/16 word through the LNS parts (read back
   as the gauss LNS matmul's integer state, bit-exact) and the LNS decode
   kernel (within 2 ulp: one expf), and >= 1M seeded and special floats
   through the LNS encode kernel (the plain version's word or, at an
   ell_bar rounding tie of logf, its neighbour; the neighbours' share is
   reported and bounded);
8. LNS matmul (``csrc/lns_matmul.cu``: the streaming kernel for
   M <= 16, register-blocked tiles above) against its plain version: each
   product alone (K = 1, every lns-takum8 word pair) within 2 ulp;
   linear accumulation at the eight projection shapes (M = 4 and 256)
   within the worst-case f32 bound and a statistical one; controls in
   the same run that must break each (products rounded to TF32 or bf16,
   a rescaled exp2f); gauss accumulation at 4x5120x1280 and
   64x5120x5120 with the integer state bit-exact, NaR poisoning exactly
   its row and column in both accumulations; time, bound and plain time
   per shape, and at 4x5120x17920 and 256x5120x17920 the library call
   (``torch.matmul`` on both operands decoded to f32, TF32 off);
9. attention (contiguous and paged) over lns-takum8 KV words against
   the plain versions, every row compared;
10. serving at the full width of phi3-medium-14b with lns-takum8 wire
    weights (every projection through the LNS matmul) and an lns-takum8
    KV cache: requests of 100 and 200 prompt tokens, 8 new tokens each,
    with every kernel's launch count from that run (the LNS matmul > 0,
    the takum wire matmul 0);
11. the reduced config with lns-takum16 weights and lns-takum8 / takum8
    KV served on the card and on the CPU: identical greedy tokens; the
    prefill logits within 1e-4 once the card's encodes replay the CPU
    run's words, and free-running within a limit per KV format, with the
    first word that differed located;
12. posit codec: every posit8 word (computed and through the
    shared-memory table) and posit16 word through the decode kernel, and
    >= 1M seeded, special and saturating floats through the encode
    kernel, bit-exact against the plain codec; decode times at
    [5120, 17920] words, table and computed;
13. posit wire matmul at the eight projection shapes, posit8 (table and
    computed) and posit16, under phase 3's worst-case and statistical
    limits and its TF32/bf16 controls, with times beside takum8's;
14. attention (contiguous and paged, phase 4's shapes and NaR words) over
    posit8 (table and computed) and posit16 KV words against the plain
    versions, every row compared;
15. serving at the full width of phi3-medium-14b with posit8 wire weights
    and a posit8 KV cache: requests of 100 and 200 prompt tokens, 8 new
    tokens each, with every kernel's launch count from that run (the wire
    matmul > 0, the LNS matmul 0) and the posit8 decode it ran;
16. the reduced config with posit16 weights and a posit8 KV cache served
    on the card and on the CPU: identical greedy tokens, logits within
    1e-4;
17. fused fake-quant at [5120, 17920] (takum8 and takum16 scaled by
    ``FormatSpec.fake_quant``, posit8 with and without the table,
    posit16, lns-takum8 and lns-takum16; f32 and bf16 out) against the
    plain version (bit-exact; LNS: the codec kernels' round trip bit for
    bit and the plain version's words or their neighbours), times against
    the byte bound; then ``quantize_weights(mode="fake")`` over one
    full-width layer in posit8 (7 launches);
18. float (identity-codec) KV caches, the registered config's own
    ``kv_quant="none"``: contiguous and paged attention over bf16 and f32
    caches (phase 4's shapes, one NaN word) against the plain version on
    the cache's f32 values (every row, NaN in the same places) and, for
    bf16, against the plain identity branch as it is (einsums in bf16);
    the reduced config (f32 cache) served on the card and on the CPU; and
    phi3-medium-14b at full width with takum8 wire weights and a bf16
    cache, requests of 100 and 200 prompt tokens, 8 new tokens each, with
    every kernel's launch count (both attention kernels > 0);
19. the compiled decode step: the fused K/V append (``kv_append``, both
    modes, the six wire formats and the bf16/f32 caches, bf16 and f32
    inputs, an idle slot whose stale pos lies past its table) against
    its plain version, bit-exact, and its times at a decode step and a
    prefill chunk; then phi3-medium-14b at full width with takum8 and
    with lns-takum8: phase 5's and phase 10's requests served under
    ``disable_graphs()`` (the eager step time beside the graph time of
    phases 5 and 10, launch counts equal), and served twice more, replayed
    and eager, for at least 64 decode steps with a short request released
    and one more admitted mid-run: active-row logits bit-identical every
    step, K/V pools byte-identical, greedy tokens equal;
20. lockstep at full width (takum8 weights and KV, the weights built once
    more for phases 20-22): phase 5's prompts left-padded into one
    ``generate_lockstep`` batch, 16 new tokens each (prefill seconds and
    the eager ``decode_ms_per_step``, every forward synchronised); each
    prompt served alone through the paged scheduler gives the tokens of
    the same prompt alone through lockstep and of its row of the batch
    when that row has no padding (equal, or parting at a bf16 tie:
    ``TIE_REL``); a left-padded row sits at positions shifted by its
    start, where its rotated bf16 q and k round otherwise (the layer-0
    score change is reported), and is reported, not held; the
    fresh-prefill attention (``_sdpa_chunked``) on one 2048-token layer
    input against the unchunked ``_sdpa`` within ``FRESH_REL`` of the
    largest output; and contiguous attention at the lockstep step's shape
    (tq = 1, rows = G = 4, each row's left-pad ``start``) against its
    plain version, with its event and graph times, bound and SDPA's time;
21. the failure model at full width (decode batch 4, a pool of 8 pages
    of 256): a priority-5 request preempts, a request is cancelled and
    one passes its deadline on a fake clock; without faults the preempted
    request and its preemptor give their solo lockstep tokens (or part at
    a bf16 tie); a second run with one NaR word injected into a live page
    poisons that request alone, quarantines its pages and leaves every
    other request as the first run left it; the decode step is captured
    once through both runs;
22. telemetry: phase 5's requests under ``REPRO_OBS`` unset, 1 and 2
    give the same tokens; each request's span tree is closed; the trace
    exports as Chrome JSON (``chiprun_out/trace_obs*.json``); no capture
    after ``arm_steady``; at level 2 ``scan_nar`` counts exactly the NaR
    words injected into live pages; ``decode_ms_per_step`` per level;
23. the wire matmuls' gradients at full width: x [256, 5120] f32 through
    5120 x 17920 takum8, posit8 and lns-takum8 wire weights, forward by
    the wire or LNS matmul kernel, backward ``g @ decode(w)^T`` with the
    decode kernel (posit8 through its table): x.grad against the plain
    version's autograd gradient within phase 3's worst-case bound, the
    launch counters of each run, forward and backward times beside their
    bounds and the backward's ``torch.matmul``;
24. training phi3-medium-14b at full width (d_model 5120, 40/10 heads of
    128, d_ff 17920, vocab 100352; depth cut from 40 to ``TRAIN_LAYERS``,
    printed as ``reduced``): ``TRAIN_STEPS`` AdamW steps through
    ``trainer.make_train_step`` on one repeated ``SyntheticLM(seed=0)``
    batch of 1 x 2048 tokens (the chunked attention and the chunked cross
    entropy), remat per block, bf16 activations on f32 parameters; every
    loss and grad norm finite, the last loss below the first; per step
    the loss, grad norm, step ms, tokens/s and the forward+backward /
    optimizer split; ``peak_gb``;
25. the reduced config trained on the card and on the CPU from the same
    parameters (3 steps: losses within ``LOSS_REL``, each parameter leaf
    within ``PARAM_REL_L2`` relative L2, elementwise differences
    reported); microbatch 2 and remat against the full batch, the same
    way; a run saved at step 3 (uncompressed, and takum16), restored
    and resumed against the uninterrupted run (the same rounding done in
    memory for takum16); a SIGTERM turned into a save at the next step
    boundary; ``python -m repro_torch.launch.train`` and
    ``launch.serve`` as subprocesses, exit 0 with the audit line first;
26. serving granite-moe-3b-a800m at full width and depth (32 layers, d
    1536, 24/8 heads of 64, 40 experts top-8 of d_ff 512, capacity
    factor 1.25; f32 expert stacks fake-quantised to takum8 in place at
    set-up by the fake-quant kernel, bf16 compute copies; takum8 wire
    attention projections and KV): phase 5's requests, TTFT, token gaps,
    the replayed ``decode_ms_per_step``, prefill per chunk, ``peak_gb``
    and the launch counts; the replayed step against the eager one over
    >= 64 steps (phase 19's check, bit for bit); the reduced config
    served on the card and on the CPU (tokens equal, logits 1e-4);
27. serving kimi-k2-1t-a32b at full width, depth cut to 1 of 61 layers
    (d 7168, 64/8 heads of 112, 384 experts top-8 of d_ff 2048, capacity
    factor 1.0; one layer's expert stacks, 16.9 G parameters, made in
    bf16 and fake-quantised a slice at a time, printed as ``layers`` and
    ``layers_of``): phase 5's requests as in phase 26, ``peak_gb``; then
    hd 112 through the append and both attention kernels at the served
    shapes (a 256-token chunk at pos 768, a decode step of 4 over
    256-position pages), each against its plain version, with times,
    bounds and SDPA's time (the kernels line's ``hd112`` entries).

Then the ``kernels`` line (each kernel's launches on its serving path,
its check, its time, the plain version's time and the bound: bytes over
3.35 TB/s or operations over the rate of the units that do them, f32
FMAs at 67 TFLOP/s, or 2-3 TF32 tensor-core products per multiply-add at
495 TFLOP/s for the prefill matmul and contiguous attention; and, where
one PyTorch call computes the same function on operands decoded
beforehand, that call's time as ``library_ms`` with the call named in
``library_call``: the wire matmul and the LNS matmul against
``torch.matmul`` with TF32 off, both attention kernels against
``scaled_dot_product_attention``). ``ms`` and ``library_ms`` are CUDA
events over back-to-back calls; where a call takes tens of microseconds
the host is the slower side, so the wire matmul, paged attention and
the LNS matmul also carry ``device_ms`` and ``library_device_ms``, the
same calls replayed from a CUDA graph; so does ``kv_append``, the fused
append that took over the K/V encodes (kernel row 2); the codec's entry
is headed by the decode, with ``torch.index_select`` on a 256-entry table
as its library call (and the posit8 table's). Last,
``{"ok": true, "device": {...}}``. The codec's, the wire matmul's, the
LNS matmul's and the posit8 table's entries also carry
``launches_training``, their launches in phase 23; the append, the wire
matmul and both attention kernels ``launches_moe`` (phases 26 and 27),
fake-quant ``launches_moe_setup``. Details go to
``chiprun_out/chip_smoke.json``.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM TF32 on the tensor cores, dense
U32 = 2.0 ** -24                 # f32 unit roundoff
# statistical limit on two f32 sums of the same K products in different
# orders: |err| <= C_STAT * sqrt(K) * u * ||x_i * w_j||_2 elementwise. The
# reorder error of one sum has a standard deviation of about
# 0.4 sqrt(K) u ||t||_2 for these zero-mean random products, so C_STAT
# leaves a wide margin; x rounded to TF32 (10 mantissa bits) errs by about
# 2^13 / (1.7 sqrt(K)) >= 35 of these units per element at K <= 17920
C_STAT = 16.0
ATTN_ATOL = 2e-5                 # the reference's attention tolerance
# a bf16 float cache against the plain version's identity branch as it is:
# that branch rounds q.k, the probabilities and p.v to bf16 (relative
# 2^-9 each) where the kernels dot in f32, as the Pallas kernels do; with
# outputs up to about 4 in magnitude, a few bf16 units of 2^-9 * 4
BF16_ATTN_ATOL = 2e-2
# every projection shape of a phi3-medium-14b layer: decode (M = 4) and a
# prefill chunk (M = 256) of wq/wo, wk/wv, wg/w1, w2
MM_SHAPES = [(4, 5120, 5120), (4, 5120, 1280), (4, 5120, 17920),
             (4, 17920, 5120), (256, 5120, 5120), (256, 5120, 1280),
             (256, 5120, 17920), (256, 17920, 5120)]
# the shapes at which a library call is timed beside the matmul kernels:
# a decode step's and a prefill chunk's w1/wg
LIBRARY_SHAPES = [(4, 5120, 17920), (256, 5120, 17920)]
# the gauss LNS matmul: a decode step's and a prefill chunk's wk/wv and wq
GAUSS_SHAPES = [(4, 5120, 1280), (64, 5120, 5120)]
# LNS encode: share of words that are the plain version's neighbour (the
# logf of kernel and plain version on either side of an ell_bar rounding
# tie), bounded at the share measured between two f32 logs on the CPU
# (tests/test_torch_lns.py: 1.0e-5)
LNS_NEIGHBOUR_SHARE = 1.5e-5
# reduced model with lns-takum16 weights, card against CPU. Forced (the
# card's encodes replay the CPU run's words) the logits are held at 1e-4.
# Free-running, an activation within an ulp of a rounding boundary of the
# LNS grid takes the neighbouring word on one side, and later layers
# spread the step: the logits are held per KV format at what was measured
# on an H100 (NVIDIA H100 80GB HBM3, 700 W), and a difference over 1e-4 is
# accepted only with the differing word located
LNS_FREE_LOGITS_TOL = {"lns-takum8": 1e-4, "takum8": 5e-3}
# the card's encode inputs against the CPU run's, once both encode the
# same words upstream (f32 sums in another order)
ENCODE_INPUT_ATOL = 1e-5
# int32 operations per product of the Gauss-log fold, counted from the
# steps of core/lns.py::gauss_add_parts on nonzero operands, each once:
# the product (ell add, sign xor), the ordering (max, difference, base
# sign select, same-sign test), the table address (index shift, remainder
# mask, half select), the interpolation (slope subtract, multiply, shift,
# add) and the result (add, clip as min and max); the two table reads
# are shared-memory loads and not counted
GAUSS_INT_OPS = 16
LOG2E_F32 = 1.4426950408889634   # rounded to f32 where it is used
# the prompt lengths of the full-width serving phases: 5 (takum8), and 10,
# 15 and 18 (lns-takum8, posit8, a bf16 cache)
PHASE5_PLENS = (77, 300, 520, 1024)
PHASE10_PLENS = (100, 200)
WIRE_KV = ("takum8", "takum16", "lns-takum8", "lns-takum16", "posit8",
           "posit16")
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


def graph_ms(torch, fn, iters=20) -> float:
    """Mean device time of ``fn`` replayed from a CUDA graph: the card's
    time for the call with no host work between launches (``cuda_ms``
    also counts the host where it is the slower side, as for calls of a
    few tens of microseconds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS):
    """(ms, "bytes" | "operations"): the larger of the two floors, the
    operations at ``rate`` (f32 FMAs unless said otherwise)."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def tf32_products(spec, dtype=None) -> int:
    """TF32 tensor-core products per multiply-add in the split-operand
    kernels (the wire matmul's prefill regime, contiguous attention): 2
    where the decoded word is exact in TF32 (8-bit takum and posit words,
    a bf16 cache; the activation alone is split), 3 where it is split
    too (csrc/wire.cuh ``TF32_EXACT``)."""
    exact = ((spec.n == 8 and spec.kind != "lns")
             or (spec.is_identity and str(dtype) == "torch.bfloat16"))
    return 2 if exact else 3


def mm_bound(spec, m: int, k: int, n: int):
    """The wire matmul's bound at [m, k] x [k, n]: x, the weight words and
    the output once each, and 2 m k n operations as f32 FMAs (the
    streaming kernel of decode batches) or as TF32 tensor-core products,
    ``tf32_products`` each (the prefill kernel)."""
    from repro_torch.kernels import takum_matmul
    nbytes = m * k * 4 + k * n * spec.n // 8 + m * n * 4
    if takum_matmul.launch_plan(m, k, n, spec.n)[0] == 0:
        return bound(nbytes, 2 * m * k * n)
    return bound(nbytes, 2 * m * k * n * tf32_products(spec), TF32_FLOPS)


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


def table_library(torch, words, spec):
    """The library call of an 8-bit decode (every 8-bit format decodes
    through a 256-entry table): ``torch.index_select`` of the 256 values
    the plain codec decodes, on the words cast to int32 beforehand (the
    cast not timed). Its time and its largest difference from the decode
    kernel's floats (NaN by place), which must be 0."""
    from repro_torch.core.bitops import to_words
    from repro_torch.kernels import ref, takum_codec
    table = ref.decode_ref(to_words(torch.arange(256, device=words.device),
                                    spec.word_dtype), spec)
    idx = words.to(torch.int32).reshape(-1)
    got = torch.index_select(table, 0, idx).reshape(words.shape)
    err = codec_err(torch, got, takum_codec.decode(words, spec))
    check(err == 0.0, f"{spec.name}: the library's table decode differs "
          f"from the decode kernel by {err}")
    return {"library_ms": cuda_ms(torch, lambda: torch.index_select(
                table, 0, idx)),
            "library_max_abs_err": err,
            "library_call": "torch.index_select(table, 0, idx) of the 256 "
                            "f32 values the plain codec decodes, idx the "
                            "words cast to int32 beforehand (not timed)"}


def smi(*fields) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of card 0, as printed."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def ulps(torch, a, b):
    """|a - b| in float32 units in the last place (+0 and -0 are one
    value, and a sign change counts the steps through zero)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def wire_matmul_check(torch, dev, spec, m, k, n):
    """The wire matmul kernel at [m, k] x [k, n] against its plain version
    on seeded operands (``spec`` words of N(0, 1/k) weights): within the
    worst-case f32 bound and the statistical limit, with controls (x
    rounded to TF32 and bf16) that must break the latter."""
    from repro_torch.kernels import ref, takum_codec, takum_matmul
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=dev)
    w = takum_codec.encode(torch.randn((k, n), generator=g,
                                       device=dev) / k ** 0.5, spec)
    wf = ref.decode_ref(w, spec)
    got = takum_matmul.qmatmul(x, w, spec)
    again = takum_matmul.qmatmul(x, w, spec)
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"qmatmul {spec.name} {m}x{k}x{n}: two calls differ")
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
    return {"fmt": spec.name, "m": m, "k": k, "n": n,
            "variant": takum_matmul.launch_plan(m, k, n, spec.n)[0],
            "repeatable": True, "max_abs_err": float(err.max()),
            "max_err_over_bound": float((err / tol).max()),
            "max_err_over_stat_limit": r_kernel,
            "control_max_err_over_stat_limit": ctrl}


def full_width_params(torch, dev, cfg, wfmt):
    """phi3-medium-14b's weights at full width (all layers), random from a
    seeded generator on the card, every projection ``wfmt`` wire words,
    embeddings bf16: (params, seconds)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.serve.engine import quantize_weights
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = L.embed_init(gen, cfg.vocab, cfg.d_model, dtype=torch.bfloat16,
                          device=dev)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dev)
    params["layers"] = []
    for _ in range(cfg.n_layers):
        layer = transformer.init_layer(gen, cfg, device=dev)
        params["layers"].append(quantize_weights(layer, wfmt, mode="wire",
                                                 verbose=False))
        del layer
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def full_width_cfg(kv):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("phi3-medium-14b").config,
                               kv_quant=kv)


def eager_mode(eager: bool):
    """``disable_graphs()`` when ``eager``; a tree without graph replay
    (an older checkout timed by tools/torch_kernel_times.py) always runs
    its step eagerly."""
    if not eager:
        return contextlib.nullcontext()
    try:
        from repro_torch.serve.graphs import disable_graphs
    except ImportError:
        return contextlib.nullcontext()
    return disable_graphs()


def serve_full_width(torch, dev, *, wfmt, kv, plens, max_new, max_len,
                     wrappers, seed=5, eager=False, params=None, cfg=None):
    """Serve phi3-medium-14b at full width (all 40 layers, random weights
    from a seeded generator on the card, ``wfmt`` wire weights, a ``kv``
    KV cache, page size 256, decode batch 4): one request per prompt
    length, ``max_new`` new tokens each, through ``ServeEngine.submit``/
    ``run``, the decode step replayed from a CUDA graph (``eager``: under
    ``disable_graphs()``). Every wrapper's launch count is set to 0 just
    before the run and read just after. Checks the output's shape and that
    the shortest request's first token is the argmax of a fresh prefill.
    ``decode_ms_per_step`` leaves out the step that captured the graph
    (an eager step and the capture: ``capture_step_ms``). ``params``
    (from :func:`full_width_params`) are built here when not given;
    ``cfg`` (default phi3-medium-14b's with ``kv``) serves another model
    with the ``params`` given."""
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine
    ps = 256
    cfg = full_width_cfg(kv) if cfg is None else cfg
    torch.cuda.reset_peak_memory_stats()
    weights_s = 0.0
    if params is None:
        params, weights_s = full_width_params(torch, dev, cfg, wfmt)
    eng = ServeEngine(params, cfg, max_len=max_len, page_size=ps,
                      decode_batch=4, device=dev)
    sched = eng.scheduler()
    runner = getattr(sched, "step", None)      # None: a tree without graphs
    walls = {"prefill": 0.0, "decode": 0.0, "capture": 0.0}
    steps = {"prefill": 0, "decode": 0, "capture": 0}

    def timed(fn, key, state):
        def wrapped():
            busy = sum(1 for s in sched._slots
                       if s is not None and s.state == state)
            if key == "decode":
                busy = min(busy, 1)     # one packed step for all slots
            caps = getattr(runner, "captures", 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            events = list(fn())
            torch.cuda.synchronize()
            k = key if getattr(runner, "captures", 0) == caps else "capture"
            walls[k] += time.perf_counter() - t
            steps[k] += busy
            yield from events
        return wrapped

    # host clock around each scheduler phase, synchronised on both sides
    sched._prefill_tick = timed(sched._prefill_tick, "prefill", "prefilling")
    sched._decode_step = timed(sched._decode_step, "decode", "active")
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in plens]
    from repro_torch.kernels import lns_matmul as klns
    for fn in wrappers.values():
        fn.launches = 0
    klns.lns_matmul.split_launches = 0
    t0 = time.perf_counter()
    with eager_mode(eager):
        rids = [eng.submit(p, max_new) for p in prompts]
        stamps = {r: [] for r in rids}       # host time of each token
        for ev in eng.run():
            stamps[ev.rid].append(time.perf_counter() - t0)
    n_events = sum(len(v) for v in stamps.values())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    split_sums = klns.lns_matmul.split_launches
    ttft = [round(stamps[r][0], 3) for r in rids]
    gaps = sorted(b - a for r in rids
                  for a, b in zip(stamps[r], stamps[r][1:]))
    outs = [eng.result(r) for r in rids]
    check(n_events == len(plens) * max_new,
          f"{n_events} tokens streamed, wanted {len(plens) * max_new}")
    for p, o in zip(prompts, outs):
        check(o[:len(p)] == p and len(o) == len(p) + max_new
              and all(0 <= t < cfg.vocab for t in o[len(p):]),
              "served output has the wrong shape or tokens out of vocab")
    if "kv_append" in wrappers:      # one fused append a layer and step
        calls = cfg.n_layers * (steps["prefill"] + steps["decode"]
                                + steps["capture"])
        check(launches["kv_append"] == calls, f"{launches['kv_append']} "
              f"K/V appends for {calls} layer calls")
    graphs = getattr(runner, "captures", 0)
    check(eager or runner is None or (graphs == 1 and runner.replays > 0),
          f"the decode step was captured {graphs} times, not once")
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
    serve = {"arch": cfg.name, "weights": wfmt, "kv": kv,
             "layers": cfg.n_layers,
             "d_model": cfg.d_model, "prompt_tokens": sum(plens),
             "generated_tokens": n_events,
             "weights_s": round(weights_s, 2), "serve_s": round(serve_s, 3),
             "prefill_s": round(walls["prefill"], 3),
             "prefill_chunks": steps["prefill"],
             "decode_s": round(walls["decode"], 3),
             "decode_steps": steps["decode"],
             "decode_ms_per_step": round(1e3 * walls["decode"]
                                         / max(steps["decode"], 1), 2),
             "step": "cuda graph" if graphs else "eager",
             "graphs_captured": graphs,
             "capture_s": round(getattr(runner, "capture_s", 0.0), 3),
             "capture_step_ms": round(1e3 * walls["capture"], 2),
             "replays": getattr(runner, "replays", 0),
             "ttft_s": ttft,
             "token_gap_ms_median": round(1e3 * gaps[len(gaps) // 2], 1),
             "token_gap_ms_max": round(1e3 * gaps[-1], 1),
             "peak_gb": round(peak_gb, 2), "launches": launches,
             "lns_matmul_split_sum_launches": split_sums}
    # the timing wrappers and the scheduler reference each other: collect
    # the cycle so the model's memory is free before the next phase
    del eng, sched, runner, params, cache, row
    gc.collect()
    torch.cuda.empty_cache()
    return serve


@contextlib.contextmanager
def encode_tap(torch, replay=None):
    """Every ``takum_codec.encode`` call of the port (the activations
    entering each LNS matmul) and every K/V encode of
    ``takum_codec.kv_append`` (K, then V, through the plain append with
    the tapped encode: on the card the fused kernel would write its own
    words), in call order.

    Without ``replay``: yields the list of ``(format, input, words)`` on
    the CPU. With ``replay`` (such a list from another run): each call
    must match the recorded call's format and shape and its input must
    lie within ENCODE_INPUT_ATOL of the recorded one; it returns the
    recorded words. Yields a dict with the words encoded, the number that
    differed from the recorded ones and the first that did."""
    from repro_torch.core.bitops import carrier, to_words
    from repro_torch.core.takum import frac_width
    from repro_torch.kernels import ref, takum_codec
    orig, orig_kv = takum_codec.encode, takum_codec.kv_append
    calls = []
    seen = {"words": 0, "differ": 0, "max_input_diff": 0.0, "first": None}
    it = enumerate(replay or [])

    def tap(x, spec):
        own = orig(x, spec)
        if replay is None:
            calls.append((spec, x.detach().cpu().clone(), own.cpu()))
            return own
        i, (rspec, rx, rwords) = next(it)
        check(rspec.name == spec.name and rwords.shape == own.shape,
              f"forced run: encode call {i} is {spec.name} "
              f"{tuple(own.shape)}, the recorded one {rspec.name} "
              f"{tuple(rwords.shape)}")
        xc = x.detach().cpu().reshape(own.shape).float()
        dx = float((xc - rx.reshape(own.shape)).abs().max())
        check(dx <= ENCODE_INPUT_ATOL, f"forced run: encode call {i} "
              f"({spec.name}) input differs by {dx}")
        differ = carrier(own.cpu()) != carrier(rwords)
        nd = int(differ.sum())
        seen["words"] += own.numel()
        seen["differ"] += nd
        seen["max_input_diff"] = max(seen["max_input_diff"], dx)
        if nd and seen["first"] is None:
            j = int(differ.reshape(-1).nonzero()[0])
            xr, xd = float(rx.reshape(-1)[j]), float(xc.reshape(-1)[j])
            wr = int(carrier(rwords).reshape(-1)[j])
            wd = int(carrier(own.cpu()).reshape(-1)[j])
            first = {"call": i, "format": spec.name, "index": j,
                     "shape": list(own.shape), "x_cpu": xr, "x_card": xd,
                     "word_cpu": wr, "word_card": wd}
            if spec.has_lns_parts:   # 2 ln|x| against the words' ell_bar
                ells, _ = spec.lns_parts(to_words(torch.tensor([wr, wd]),
                                                  spec.word_dtype))
                sc = 2.0 ** -frac_width(spec.n)
                first.update(two_ln_abs_x_cpu=2 * math.log(abs(xr)),
                             two_ln_abs_x_card=2 * math.log(abs(xd)),
                             ell_cpu=int(ells[0]) * sc,
                             ell_card=int(ells[1]) * sc)
            seen["first"] = first
        return rwords.to(own.device)

    def tap_kv(k, v, k_cache, v_cache, spec, *, pos, table=None):
        if spec.is_identity:
            return orig_kv(k, v, k_cache, v_cache, spec, pos=pos, table=table)
        return ref.kv_append_ref(k, v, k_cache, v_cache, spec, pos=pos,
                                 table=table, encode=tap)

    tap.launches = tap_kv.launches = 0
    takum_codec.encode, takum_codec.kv_append = tap, tap_kv
    try:
        yield calls if replay is None else seen
    finally:
        takum_codec.encode, takum_codec.kv_append = orig, orig_kv
    if replay is not None:
        check(next(it, None) is None, "forced run: the card encoded fewer "
              "times than the CPU")


def reduced_card_vs_cpu(torch, dev, *, wfmt, kv, free_tol=1e-4, tol=1e-4,
                        arch="phi3-medium-14b"):
    """The reduced config of ``arch`` served on the card and on the CPU (plain
    versions): identical greedy tokens (two generate calls: prefix tree
    cold and warm), and the prefill logits of one prompt within ``tol``
    once the card's encodes replay the CPU run's words (``encode_tap``),
    and within ``free_tol`` free-running (a difference over 1e-4 is
    accepted only where a differing word was located)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine, quantize_weights
    rcfg = dataclasses.replace(get_arch(arch).reduced, kv_quant=kv)
    rparams = quantize_weights(model.init(torch.Generator().manual_seed(0),
                                          rcfg, device="cpu"), wfmt,
                               mode="wire", verbose=False)
    rng = torch.Generator().manual_seed(3)
    rprompts = [torch.randint(0, rcfg.vocab, (n,), generator=rng).tolist()
                for n in (16, 9, 4, 13)]
    t = torch.zeros((1, 16), dtype=torch.long)
    t[0, :13] = torch.as_tensor(rprompts[3])
    toks_by, engines = {}, {}
    for d in ("cpu", dev):
        e = ServeEngine(rparams, rcfg, max_len=48, page_size=16, device=d)
        toks_by[str(d)] = (e.generate(rprompts, 8), e.generate(rprompts, 8))
        engines[str(d)] = e

    def prefill(d):
        c = model.init_cache(rcfg, 1, 32, device=d)
        row, _ = model.prefill_chunk(engines[str(d)].params, t.to(d), rcfg,
                                     c, pos=0, last_idx=12)
        return row.cpu()

    with eager_mode(True), encode_tap(torch) as calls:
        cpu_row = prefill("cpu")
    card_free = prefill(dev)
    with eager_mode(True), encode_tap(torch, replay=calls) as seen:
        card_forced = prefill(dev)
    same = toks_by["cpu"] == toks_by[str(dev)]
    free_err = float((cpu_row - card_free).abs().max())
    forced_err = float((cpu_row - card_forced).abs().max())
    what = f"reduced {arch} ({wfmt} weights, {kv} KV)"
    check(same, f"{what}: card and CPU tokens differ")
    check(forced_err <= tol, f"{what}: card and CPU logits differ by "
          f"{forced_err} with the CPU's words forced")
    check(free_err <= free_tol, f"{what}: card and CPU logits differ by "
          f"{free_err} free-running")
    check(free_err <= 1e-4 or seen["differ"] > 0, f"{what}: free-running "
          f"logits differ by {free_err} and no encoded word differs")
    return {"arch": arch, "weights": wfmt, "kv": kv,
            "tokens_identical": same,
            "logits_max_abs_err": free_err, "tolerance": free_tol,
            "forced_logits_max_abs_err": forced_err, "forced_tolerance": tol,
            "encoded_words": seen["words"], "words_differing": seen["differ"],
            "max_encode_input_diff": seen["max_input_diff"],
            "first_differing_word": seen["first"]}


def lns_codec_phase(torch, dev):
    """Every lns-takum8/16 word through the LNS parts (takum::lns_parts,
    read back as the integer state of the gauss LNS matmul of the word
    column by the word 1.0: one fold from the empty sum copies the
    product's parts) and the decode kernel, and >= 1M seeded plus special
    floats through the LNS encode kernel, against the plain torch codec on
    the same card. Parts bit-exact, decoded values within 2 ulp (one
    expf), encoded words equal or (at an ell_bar rounding tie of logf)
    the neighbouring word."""
    from repro_torch import formats
    from repro_torch.core.bitops import carrier, to_words
    from repro_torch.kernels import lns_matmul as klns
    from repro_torch.kernels import ref, takum_codec
    out = {}
    worst = 0.0
    for name in ("lns-takum8", "lns-takum16"):
        spec = formats.get(name)
        words = to_words(torch.arange(2 ** spec.n, device=dev),
                         spec.word_dtype)
        one = takum_codec.encode(torch.ones((1, 1), device=dev), spec)
        _, ell, flags = klns.lns_matmul(words[:, None], one, spec, "gauss",
                                        state=True)
        pell, pflags = spec.lns_parts(words)
        check(torch.equal(ell[:, 0], pell) and torch.equal(flags[:, 0],
                                                            pflags),
              f"lns_parts on the card differs from the plain codec ({name})")
        got = takum_codec.decode(words, spec)
        want = ref.decode_ref(words, spec)
        check(torch.equal(torch.isnan(got), torch.isnan(want)),
              f"LNS decode NaNs differ ({name})")
        fin = ~torch.isnan(want)
        dec_ulps = int(ulps(torch, got[fin], want[fin]).max())
        check(dec_ulps <= 2, f"LNS decode {dec_ulps} ulp off ({name})")
        dec_err = codec_err(torch, got, want)
        g = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn(1 << 20, generator=g, device=dev)
        x = x * torch.pow(10.0, torch.randint(-45, 39, x.shape, device=dev,
                                              generator=g).float())
        sub = torch.randint(1, 2 ** 23, (1 << 16,), device=dev, generator=g,
                            dtype=torch.int32).view(torch.float32)
        # zero, infinities, NaN, the subnormal and normal f32 extremes
        # (e^+-128, the edge of the lns-takum range, lies beyond f32: +-inf
        # and the f32 extremes drive the saturating encode instead)
        special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                float("nan"), 1e-45, -1e-45, 1.1754944e-38,
                                -1.1754944e-38, 3.4028235e38, -3.4028235e38,
                                1.0, -1.0], device=dev)
        xs = torch.cat([x, sub, -sub, special])
        gw = takum_codec.encode(xs, spec)
        ww = ref.encode_ref(xs, spec)
        # 0: the same word; 1 or 2^n - 1: the neighbouring word
        step = (carrier(gw).long() - carrier(ww).long()) % (1 << spec.n)
        neighbour_only = bool(torch.isin(step, torch.tensor(
            [0, 1, (1 << spec.n) - 1], device=dev)).all())
        share = float((step != 0).double().mean())
        check(neighbour_only, f"LNS encode: a word other than the plain "
              f"version's or its neighbour ({name})")
        check(share <= LNS_NEIGHBOUR_SHARE, f"LNS encode: neighbour share "
              f"{share} over {LNS_NEIGHBOUR_SHARE} ({name})")
        check(bool((step[-len(special):] == 0).all()),
              f"LNS encode of the special floats differs ({name})")
        enc_err = codec_err(torch, ref.decode_ref(gw, spec),
                            ref.decode_ref(ww, spec))
        worst = max(worst, dec_err, enc_err)
        out[name] = {"words": 2 ** spec.n, "floats": xs.numel(),
                     "lns_parts_bit_exact": True, "decode_max_ulps": dec_ulps,
                     "decode_max_abs_err": dec_err,
                     "encode_neighbour_words": int((step != 0).sum()),
                     "encode_neighbour_share": share,
                     "encode_max_abs_err": enc_err}
    return out, worst


def lns_matmul_phase(torch, dev, sm_clock_hz):
    """The LNS matmul kernel against its plain version on the card.

    Linear, K = 1 (each output one product): every lns-takum8 word pair
    and every lns-takum16 word against 64 seeded words, within 2 ulp (one
    expf each); controls that must break it: each product rounded to TF32
    and to bf16, and exp2f of the argument rescaled by an f32 log2(e) (the
    fast-exp route). Linear at all eight projection shapes of a
    phi3-medium-14b layer (lns-takum8 operands, M = 4 and 256): within
    the worst-case f32 bound (2K+4) u sum|p| and the statistical limit
    C_STAT sqrt(K) u ||p||_2 elementwise; controls that must break the
    latter: each product rounded to TF32 and to bf16. Gauss at 4x5120x1280
    and 64x5120x5120: integer state bit-exact, the output within 2 ulp.
    NaR in x and in w: NaN in exactly its row and its column. Times,
    bounds and plain times per shape."""
    from repro_torch import formats
    from repro_torch.core.bitops import to_words
    from repro_torch.kernels import lns_matmul as klns
    from repro_torch.kernels import ref, takum_codec
    spec = formats.get("lns-takum8")
    sfu_rate = 16 * 132 * sm_clock_hz           # expf per second
    int_rate = 64 * 132 * sm_clock_hz           # int32 operations per second
    log2e = torch.tensor(LOG2E_F32, dtype=torch.float32, device=dev)
    controls = {"tf32_product": lambda a: round_mantissa(torch, a.exp(), 13),
                "bf16_product": lambda a: round_mantissa(torch, a.exp(), 16),
                "exp2f_rescaled": lambda a: torch.exp2(a * log2e)}

    def operands(m, k, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = takum_codec.encode(torch.randn((m, k), generator=g, device=dev),
                               spec)
        w = takum_codec.encode(torch.randn((k, n), generator=g, device=dev)
                               / k ** 0.5, spec)
        return x, w

    def max_ulps(got, want):
        check(torch.equal(torch.isnan(got), torch.isnan(want)),
              "lns_matmul K = 1: NaNs differ")
        fin = ~torch.isnan(want)
        return int(ulps(torch, got[fin], want[fin]).max())

    each_product = {}
    for name in ("lns-takum8", "lns-takum16"):
        sp = formats.get(name)
        x = to_words(torch.arange(2 ** sp.n, device=dev), sp.word_dtype)
        if sp.n == 8:
            w = x[None, :]
        else:
            g = torch.Generator(device=dev).manual_seed(13)
            w = takum_codec.encode(torch.randn((1, 64), generator=g,
                                               device=dev), sp)
        got = klns.lns_matmul(x[:, None], w, sp)
        want = ref.lns_matmul_plain(x[:, None], w, sp)
        row = {"products": got.numel(), "max_ulps": max_ulps(got, want)}
        check(row["max_ulps"] <= 2, f"lns_matmul K = 1 ({name}): "
              f"{row['max_ulps']} ulp off the plain version")
        for key, fn in controls.items():
            row[f"{key}_max_ulps"] = max_ulps(ref.lns_matmul_plain(
                x[:, None], w, sp, exp=fn), want)
            check(row[f"{key}_max_ulps"] > 2, f"lns_matmul K = 1 ({name}): "
                  f"the {key} control passes 2 ulp")
        each_product[name] = row
        del x, w, got, want

    linear = []
    worst = 0.0
    for m, k, n in MM_SHAPES:
        x, w = operands(m, k, n, m + k + n)
        got = klns.lns_matmul(x, w, spec)
        want = ref.lns_matmul_plain(x, w, spec)
        xd, wd = ref.decode_ref(x, spec), ref.decode_ref(w, spec)
        tol = (2 * k + 4) * U32 * (xd.abs() @ wd.abs())
        stat = C_STAT * k ** 0.5 * U32 * ((xd * xd) @ (wd * wd)).sqrt()
        err = (got - want).abs()
        check(bool(torch.isfinite(got).all()) and bool((err <= tol).all()),
              f"lns_matmul linear {m}x{k}x{n}: error over the f32 bound")
        r_kernel = float((err / stat).max())
        check(r_kernel <= 1.0, f"lns_matmul linear {m}x{k}x{n}: error "
              f"{r_kernel:.3g} x the statistical limit")
        ctrl = {}
        for key in ("tf32_product", "bf16_product"):
            e = (ref.lns_matmul_plain(x, w, spec, exp=controls[key])
                 - want).abs()
            ctrl[key] = float((e / stat).max())
            check(ctrl[key] > 1.0, f"lns_matmul linear {m}x{k}x{n}: the "
                  f"{key} control passes the statistical limit")
            del e
        products = m * k * n
        t_sfu = products / sfu_rate * 1e3
        t_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        iters = 5 if products > 5e9 else 20
        row = {"m": m, "k": k, "n": n, "max_abs_err": float(err.max()),
               "max_err_over_bound": float((err / tol).max()),
               "max_err_over_stat_limit": r_kernel,
               "control_max_err_over_stat_limit": ctrl,
               "ms": cuda_ms(torch, lambda: klns.lns_matmul(x, w, spec),
                             iters=iters),
               "plain_ms": cuda_ms(torch, lambda: ref.lns_matmul_plain(
                   x, w, spec), iters=1, warmup=1),
               "bound_ms": max(t_sfu, t_bytes),
               "bound_by": "operations" if t_sfu >= t_bytes else "bytes",
               "bound_note": "products / (16 expf per SM per clock x 132 "
                             "SMs x clocks.max.sm)"}
        if (m, k, n) in LIBRARY_SHAPES:
            # one PyTorch call on both operands decoded beforehand (the
            # reference's CPU route, lns_qmatmul_ref), TF32 off
            row["library_ms"] = cuda_ms(torch, lambda: torch.matmul(xd, wd),
                                        iters=iters)
            row["device_ms"] = graph_ms(
                torch, lambda: klns.lns_matmul(x, w, spec), iters=iters)
            row["library_device_ms"] = graph_ms(
                torch, lambda: torch.matmul(xd, wd), iters=iters)
        linear.append(row)
        worst = max(worst, row["max_abs_err"])
        del x, w, got, want, xd, wd, tol, stat, err
    gauss = []
    for m, k, n in GAUSS_SHAPES:
        x, w = operands(m, k, n, 3 * m + k + n)
        out, ell, flags = klns.lns_matmul(x, w, spec, "gauss", state=True)
        pout, pell, pflags = ref.lns_matmul_plain(x, w, spec, "gauss",
                                                  state=True)
        check(torch.equal(ell, pell) and torch.equal(flags, pflags),
              f"lns_matmul gauss {m}x{k}x{n}: integer state differs")
        check(torch.equal(torch.isnan(out), torch.isnan(pout)),
              f"lns_matmul gauss {m}x{k}x{n}: NaNs differ")
        fin = ~torch.isnan(pout)
        g_ulps = int(ulps(torch, out[fin], pout[fin]).max())
        check(g_ulps <= 2, f"lns_matmul gauss {m}x{k}x{n}: {g_ulps} ulp off")
        t0 = time.perf_counter()
        ref.lns_matmul_plain(x, w, spec, "gauss")
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        products = m * k * n
        t_int = products * GAUSS_INT_OPS / int_rate * 1e3
        t_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        gauss.append({"m": m, "k": k, "n": n, "state_bit_exact": True,
                      "max_ulps": g_ulps,
                      "ms": cuda_ms(torch, lambda: klns.lns_matmul(
                          x, w, spec, "gauss"), iters=3, warmup=1),
                      "plain_ms": plain_ms,
                      "bound_ms": max(t_int, t_bytes),
                      "bound_by": "operations" if t_int >= t_bytes
                      else "bytes",
                      "bound_note": f"products x {GAUSS_INT_OPS} int32 "
                                    "operations (the steps of "
                                    "gauss_add_parts) / (64 per SM per "
                                    "clock x 132 SMs x clocks.max.sm)"})
        del x, w, out, ell, flags, pout, pell, pflags
    # NaR words poison exactly their row (x) and column (w)
    nar = {}
    # the linear streaming kernel (M = 4), the register tiles (M = 64) and
    # the gauss fold
    for name, accum, m in (("linear", "linear", 4),
                           ("linear_prefill", "linear", 64),
                           ("gauss", "gauss", 4)):
        k, n = 5120, 1280
        x, w = operands(m, k, n, 11)
        x[2, 100] = spec.nar_word
        w[4000, 333] = spec.nar_word
        got = klns.lns_matmul(x, w, spec, accum)
        isnan = torch.isnan(got)
        exact = (bool(isnan[2].all()) and bool(isnan[:, 333].all())
                 and int(isnan.sum()) == m + n - 1)
        check(exact, f"lns_matmul {name}: NaR does not poison exactly its "
              "row and column")
        nar[name] = exact
    return {"each_product": each_product, "linear": linear, "gauss": gauss,
            "nar_row_column": nar, "max_abs_err": worst}


def contiguous_nar_check(torch, q, kc, vc, spec, pos0, start0):
    """The contiguous kernel at phase 4's chunk shape with a NaR word (NaN
    for a float cache) in K at position 100 of KV head 3, valid for every
    row, and in V at position 1000 of KV head 6, a visited tile's key that
    most rows mask (p = 0): NaN in the plain version's places (every row
    of head 3, column 2 of every row of head 6), the rest within
    ATTN_ATOL. Returns (NaN count, largest error on the finite rest)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import takum_attention as kattn
    hkv, tq = kc.shape[2], q.shape[1]
    nar = float("nan") if spec.is_identity else spec.nar_word
    kc, vc = kc.clone(), vc.clone()
    kc[0, 100, 3, 7] = nar
    vc[0, 1000, 6, 2] = nar
    q4 = kattn.to_rows(q, hkv).contiguous()
    got = kattn.attention(q4, kc, vc, pos0, start0, spec=spec, bk=256, tq=tq)
    if spec.is_identity:       # the kernels' semantics: f32 values, f32 dots
        q, kc, vc = q.float(), kc.float(), vc.float()
    want = kattn.to_rows(ref.attention_ref(q, kc, vc, spec.n, spec, pos=pos0,
                                           start=start0), hkv)
    nan = torch.isnan(got)
    rows, hd = got.shape[2], got.shape[3]
    check(torch.equal(nan, torch.isnan(want)) and bool(nan[0, 3].all())
          and bool(nan[0, 6, :, 2].all())
          and int(nan.sum()) == rows * hd + rows,
          f"contiguous attention over {spec.name} KV: NaR words poison "
          "other rows than the plain version's")
    fin = ~nan
    err = float((got[fin] - want[fin]).abs().max())
    check(err <= ATTN_ATOL, f"contiguous attention over {spec.name} KV with "
          f"NaR words: off by {err}")
    return int(nan.sum()), err


def wire_attention_phase(torch, dev, spec):
    """Contiguous and paged attention over ``spec`` KV words against their
    plain versions at the shapes of phase 4, every row compared (a NaR K
    word poisoning exactly its rows), and their times."""
    from repro_torch.core import takum
    from repro_torch.kernels import ref, takum_codec
    from repro_torch.kernels import takum_attention as kattn
    hkv, grp, hd, tq, pos0, tcache = 10, 4, 128, 256, 768, 1280
    g = torch.Generator(device=dev).manual_seed(12)
    q = torch.randn((1, tq, hkv * grp, hd), generator=g, device=dev)
    qd = torch.randn((4, 1, hkv * grp, hd), generator=g, device=dev)
    start0 = torch.zeros(1, dtype=torch.int32, device=dev)
    startp = torch.zeros(4, dtype=torch.int32, device=dev)
    table = torch.tensor([[1, 2, 0, 0, 0], [3, 4, 5, 0, 0],
                          [6, 7, 8, 9, 10], [0, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([76, 520, 1023, 4000], dtype=torch.int32, device=dev)
    kc = takum_codec.encode(torch.randn((1, tcache, hkv, hd), generator=g,
                                        device=dev), spec)
    vc = takum_codec.encode(torch.randn((1, tcache, hkv, hd), generator=g,
                                        device=dev), spec)
    q4 = kattn.to_rows(q, hkv).contiguous()
    got = kattn.attention(q4, kc, vc, pos0, start0, spec=spec, bk=256, tq=tq)
    want = kattn.to_rows(ref.attention_ref(q, kc, vc, spec.n, spec, pos=pos0,
                                           start=start0), hkv)
    attn_err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and attn_err <= ATTN_ATOL,
          f"contiguous attention over {spec.name} KV off by {attn_err}")
    nar_nans, nar_err = contiguous_nar_check(torch, q, kc, vc, spec, pos0,
                                             start0)
    kp = takum_codec.encode(torch.randn((24, 256, hkv, hd), generator=g,
                                        device=dev), spec)
    vp = takum_codec.encode(torch.randn((24, 256, hkv, hd), generator=g,
                                        device=dev), spec)
    kp[4, 10, 3, 7] = takum.nar_word(spec.n)   # seq 1, position 266, head 3
    qd4 = kattn.to_rows(qd, hkv).contiguous()
    gotp = kattn.paged_attention(qd4, kp, vp, pos, startp, table, spec=spec)
    wantp = kattn.to_rows(ref.paged_attention_ref(qd, kp, vp, table, spec,
                                                  pos=pos, start=startp), hkv)
    nan_ok = torch.equal(torch.isnan(gotp), torch.isnan(wantp))
    clean = (bool(torch.isnan(gotp[1, 3]).all())
             and int(torch.isnan(gotp).sum()) == grp * hd)
    fin = torch.isfinite(wantp)
    paged_err = float((gotp[fin] - wantp[fin]).abs().max())
    check(nan_ok and clean and paged_err <= ATTN_ATOL,
          f"paged attention over {spec.name} KV: nan_ok={nan_ok} "
          f"clean={clean} err={paged_err}")
    res = {"contiguous_max_abs_err": attn_err,
           "contiguous_nar_nans": nar_nans,
           "contiguous_nar_max_abs_err": nar_err,
           "paged_max_abs_err": paged_err,
           "nar_rows_poisoned": clean, "tolerance": ATTN_ATOL,
           "contiguous_ms": cuda_ms(torch, lambda: kattn.attention(
               q4, kc, vc, pos0, start0, spec=spec, bk=256, tq=tq)),
           "paged_ms": cuda_ms(torch, lambda: kattn.paged_attention(
               qd4, kp, vp, pos, startp, table, spec=spec), iters=50),
           "paged_device_ms": graph_ms(torch, lambda: kattn.paged_attention(
               qd4, kp, vp, pos, startp, table, spec=spec), iters=50)}
    del kc, vc, kp, vp, got, want, gotp, wantp
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def lut_switch(value: str):
    """``REPRO_LUT_DECODE`` = ``value`` inside ("1": posit8 through its
    shared-memory table, "0": the computed decode)."""
    old = os.environ.get("REPRO_LUT_DECODE")
    os.environ["REPRO_LUT_DECODE"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_LUT_DECODE")
        else:
            os.environ["REPRO_LUT_DECODE"] = old


# the posit decodes held and timed: posit8 through the table and computed,
# posit16 (no table)
POSIT_VARIANTS = (("posit8", "1", "posit8 table"),
                  ("posit8", "0", "posit8 computed"),
                  ("posit16", "0", "posit16"))


def same_floats(torch, a, b) -> bool:
    """Bit-equal where not NaN, NaN in the same places (PyTorch's NaN bits
    differ between its CPU and CUDA arithmetic)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    it = torch.int16 if a.element_size() == 2 else torch.int32
    return (torch.equal(na, nb)
            and torch.equal(a[~na].view(it), b[~nb].view(it)))


def posit_floats(torch, dev, seed):
    """>= 1M floats: seeded normals over the f32 range, raw bit patterns,
    subnormals, powers of two around the posit8/16 saturation edges
    (2^+-24, 2^+-56) and their neighbours, and the specials."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1 << 20, generator=g, device=dev)
    x = x * torch.pow(10.0, torch.randint(-45, 39, x.shape, device=dev,
                                          generator=g).float())
    raw = torch.randint(-2 ** 31, 2 ** 31, (1 << 18,), device=dev,
                        generator=g, dtype=torch.int64).to(torch.int32)
    sub = torch.randint(1, 2 ** 23, (1 << 16,), device=dev, generator=g,
                        dtype=torch.int32).view(torch.float32)
    edges = torch.pow(2.0, torch.arange(-64, 65, device=dev).float())
    edges = torch.cat([edges, torch.nextafter(edges, torch.zeros_like(edges)),
                       torch.nextafter(edges, torch.full_like(edges, 1e38))])
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-45, -1e-45, 1.1754942e-38,
                            3.4028235e38, -3.4028235e38, 1.0, -1.0],
                           device=dev)
    return torch.cat([x, raw.view(torch.float32), sub, -sub, edges, -edges,
                      special])


def posit_codec_phase(torch, dev):
    """Phase 12: every posit word through the decode kernel (posit8 with
    and without the table, posit16), >= 1M floats through the encode
    kernel, bit-exact against the plain codec on the card; the decode at
    [5120, 17920] words timed against its byte bound and its plain
    version, and the encode of one layer's K append of a prefill chunk."""
    from repro_torch import formats
    from repro_torch.core import posit
    from repro_torch.core.bitops import carrier, to_words
    from repro_torch.kernels import build, ref, takum_codec
    res, times = {}, {}
    g = torch.Generator(device=dev).manual_seed(21)
    w_f32 = torch.randn((5120, 17920), generator=g, device=dev) / 5120 ** 0.5
    kv_prefill = torch.randn((1, 256, 10, 128), generator=g, device=dev)
    for name, lut, label in POSIT_VARIANTS:
        spec = formats.get(name)
        with lut_switch(lut):
            table = build.format_code(spec, dev) == build.POSIT8_LUT
            check(table == (lut == "1" and spec.has_lut),
                  f"{label}: the kernels' format code ignores the switch")
            words = to_words(torch.arange(2 ** spec.n, device=dev),
                             spec.word_dtype)
            got = takum_codec.decode(words, spec)
            want = posit.posit_to_float(words, spec.n)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"{label}: decode kernel differs from the plain codec")
            row = {"words": 2 ** spec.n, "decode_bit_exact": True,
                   "decode_max_abs_err": codec_err(torch, got, want)}
            if spec.has_lut:
                plain_table = formats.posit8_lut_decode(words)
                check(torch.equal(plain_table.view(torch.int32),
                                  want.view(torch.int32)),
                      "the plain posit8 table differs from the computed "
                      "decode")
            if lut == "0":
                xs = posit_floats(torch, dev, 22 + spec.n)
                gw = takum_codec.encode(xs, spec)
                ww = posit.float_to_posit(xs, spec.n)
                check(torch.equal(carrier(gw), carrier(ww)),
                      f"{name}: encode kernel differs from the plain codec")
                row.update(floats=xs.numel(), encode_bit_exact=True)
                b_ms, _ = bound(kv_prefill.numel() * (4 + spec.n // 8), 0)
                times[f"{name} encode_kv_prefill_chunk"] = {
                    "shape": list(kv_prefill.shape),
                    "ms": cuda_ms(torch, lambda: takum_codec.encode(
                        kv_prefill, spec), iters=200),
                    "plain_ms": cuda_ms(torch, lambda: ref.encode_ref(
                        kv_prefill, spec), iters=3, warmup=1),
                    "bound_ms": b_ms, "bound_by": "bytes"}
                del xs, gw, ww
            wt = takum_codec.encode(w_f32, spec)
            b_ms, b_by = bound(wt.numel() * (4 + spec.n // 8), 0)
            times[f"{label} decode_weights"] = {
                "shape": list(wt.shape),
                "ms": cuda_ms(torch, lambda: takum_codec.decode(wt, spec)),
                "plain_ms": cuda_ms(torch, lambda: ref.decode_ref(wt, spec),
                                    iters=3, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by}
            if spec.n == 8:
                times[f"{label} decode_weights"].update(
                    table_library(torch, wt, spec))
            res[label] = row
            del wt
    del w_f32, kv_prefill
    torch.cuda.empty_cache()
    return res, times


def posit_matmul_phase(torch, dev):
    """Phase 13: the wire matmul over posit8 (table and computed) and
    posit16 weights at every projection shape, under phase 3's limits and
    controls, and its time per shape (the bound as phase 3's)."""
    from repro_torch import formats
    from repro_torch.kernels import takum_codec, takum_matmul
    rows, times = [], {}
    ratio = {"kernel": 0.0, "tf32_x": float("inf"), "bf16_x": float("inf")}
    for name, lut, label in POSIT_VARIANTS:
        spec = formats.get(name)
        with lut_switch(lut):
            for m, k, n in MM_SHAPES:
                row = wire_matmul_check(torch, dev, spec, m, k, n)
                row["decode"] = label
                ctrl = row["control_max_err_over_stat_limit"]
                for key in ("tf32_x", "bf16_x"):
                    ratio[key] = min(ratio[key], ctrl[key])
                ratio["kernel"] = max(ratio["kernel"],
                                      row["max_err_over_stat_limit"])
                x = torch.randn((m, k), device=dev)
                w = takum_codec.encode(torch.randn((k, n), device=dev)
                                       / k ** 0.5, spec)
                b_ms, b_by = mm_bound(spec, m, k, n)
                row.update(ms=cuda_ms(torch, lambda: takum_matmul.qmatmul(
                    x, w, spec)), bound_ms=b_ms, bound_by=b_by)
                times[f"{label} {m}x{k}x{n}"] = row["ms"]
                rows.append(row)
                del x, w
    return rows, times, ratio


def fake_quant_phase(torch, dev):
    """Phase 17: the fused fake-quant kernel at [5120, 17920] for every
    wire format (linear takum scaled by FormatSpec.fake_quant's power of
    two, posit8 with and without the table), f32 and bf16 out, against the
    plain version on the card: bit-exact (NaNs by place), LNS the codec
    kernels' round trip bit for bit and the plain version's words or
    their neighbours; times against the byte bound."""
    from repro_torch import formats
    from repro_torch.core import quant
    from repro_torch.core.bitops import carrier
    from repro_torch.kernels import quantize, ref, takum_codec
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((5120, 17920), generator=g, device=dev) * 0.02
    # specials; a per-tensor scale needs a finite absmax, so the scaled
    # linear-takum rows see zeros and subnormals only
    specials = torch.tensor([0.0, -0.0, 1e-40, -1e-40, float("inf"),
                             -float("inf"), float("nan"), 3e38], device=dev)
    variants = [("takum8", "0", "takum8 scaled"),
                ("takum16", "0", "takum16 scaled"), *POSIT_VARIANTS,
                ("lns-takum8", "0", "lns-takum8"),
                ("lns-takum16", "0", "lns-takum16")]
    rows = {}
    for name, lut, label in variants:
        spec = formats.get(name)
        x[0, :8] = specials if spec.kind != "linear" else specials[:4].repeat(2)
        k = (int(quant.scale_exponent(x, quant.QuantSpec(fmt="takum",
                                                          n=spec.n)))
             if spec.kind == "linear" else 0)
        with lut_switch(lut):
            for dtype in (torch.float32, torch.bfloat16):
                got = spec.fake_quant(x, dtype=dtype)
                key = f"{label} {str(dtype)[6:]}"
                row = {"scale_exp": k}
                if spec.kind == "lns":
                    comp = takum_codec.decode(takum_codec.encode(x, spec),
                                              spec).to(dtype)
                    check(same_floats(torch, got, comp), f"fake_quant {key}: "
                          "not the codec kernels' round trip")
                    mod = 1 << spec.n
                    step = (carrier(takum_codec.encode(x, spec)).long()
                            - carrier(ref.encode_ref(x, spec)).long()) % mod
                    check(bool(torch.isin(step, torch.tensor(
                        [0, 1, mod - 1], device=dev)).all()),
                        f"fake_quant {key}: a word other than the plain "
                        "version's or its neighbour")
                    share = float((step != 0).double().mean())
                    check(share <= LNS_NEIGHBOUR_SHARE, f"fake_quant {key}: "
                          f"neighbour share {share}")
                    row["neighbour_share"] = share
                    del comp, step
                want = ref.fake_quant_ref(x, spec, dtype=dtype, scale_exp=k)
                if spec.kind != "lns":
                    check(same_floats(torch, got, want),
                          f"fake_quant {key}: differs from the plain version")
                    row["bit_exact"] = True
                row["max_abs_err"] = codec_err(torch, got.float(),
                                               want.float())
                del want
                nbytes = x.numel() * (4 + got.element_size())
                b_ms, b_by = bound(nbytes, 0)
                row.update(
                    ms=cuda_ms(torch, lambda: quantize.fake_quant(
                        x, spec, dtype=dtype, scale_exp=k)),
                    plain_ms=cuda_ms(torch, lambda: ref.fake_quant_ref(
                        x, spec, dtype=dtype, scale_exp=k), iters=2,
                        warmup=1),
                    bound_ms=b_ms, bound_by=b_by)
                rows[key] = row
                del got
    del x
    torch.cuda.empty_cache()
    return rows


def quantize_layer_fake(torch, dev, fmt):
    """``quantize_weights(layer, fmt, mode="fake")`` over one full-width
    phi3-medium-14b layer (f32 weights from a seeded generator on the
    card), the fake-quant kernel's launch count set to 0 just before and
    read just after; every matrix against the plain version."""
    from repro_torch import formats
    from repro_torch.configs import get_arch
    from repro_torch.kernels import quantize, ref
    from repro_torch.models import transformer
    from repro_torch.serve.engine import quantize_weights
    cfg = get_arch("phi3-medium-14b").config
    layer = transformer.init_layer(torch.Generator(device=dev).manual_seed(18),
                                   cfg, device=dev)
    spec = formats.get(fmt)
    torch.cuda.synchronize()
    quantize.fake_quant.launches = 0
    t0 = time.perf_counter()
    out = quantize_weights(layer, fmt, mode="fake", verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = quantize.fake_quant.launches
    for part in ("attn", "mlp"):
        for name, w in layer[part].items():
            got = out[part][name]
            check(got.dtype == w.dtype and got.shape == w.shape
                  and same_floats(torch, got, ref.fake_quant_ref(w, spec)),
                  f"quantize_weights fake {fmt}: {part}/{name} differs from "
                  "the plain version")
    elems = sum(w.numel() for part in ("attn", "mlp")
                for w in layer[part].values())
    del layer, out
    torch.cuda.empty_cache()
    return {"format": fmt, "matrices": 7, "elements": elems,
            "launches": launches, "wall_s": wall}


def float_kv_attention_phase(torch, dev):
    """Phase 18, attention: the contiguous and paged kernels over the
    identity codec's bf16 and f32 caches at phase 4's shapes, q in the
    cache dtype as served. Against the plain version on the cache's f32
    values (the kernels cast the words to f32 and dot at f32 precision,
    as the Pallas kernels do): ATTN_ATOL, every row, a NaN word poisoning
    the plain version's rows (contiguous: contiguous_nar_check; paged:
    one NaN K word). Against the plain identity branch as it is (einsums
    in the cache dtype): ATTN_ATOL for f32, BF16_ATTN_ATOL for bf16."""
    from repro_torch import formats
    from repro_torch.kernels import ref
    from repro_torch.kernels import takum_attention as kattn
    spec = formats.get("none")
    hkv, grp, hd, tq, pos0, tcache = 10, 4, 128, 256, 768, 1280
    g = torch.Generator(device=dev).manual_seed(19)
    q32 = torch.randn((1, tq, hkv * grp, hd), generator=g, device=dev)
    qd32 = torch.randn((4, 1, hkv * grp, hd), generator=g, device=dev)
    kf = torch.randn((1, tcache, hkv, hd), generator=g, device=dev)
    vf = torch.randn((1, tcache, hkv, hd), generator=g, device=dev)
    kpf = torch.randn((24, 256, hkv, hd), generator=g, device=dev)
    vpf = torch.randn((24, 256, hkv, hd), generator=g, device=dev)
    start0 = torch.zeros(1, dtype=torch.int32, device=dev)
    startp = torch.zeros(4, dtype=torch.int32, device=dev)
    table = torch.tensor([[1, 2, 0, 0, 0], [3, 4, 5, 0, 0],
                          [6, 7, 8, 9, 10], [0, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([76, 520, 1023, 4000], dtype=torch.int32, device=dev)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        q, qd = q32.to(dt), qd32.to(dt)
        kc, vc = kf.to(dt), vf.to(dt)
        q4 = kattn.to_rows(q, hkv).contiguous()
        got = kattn.attention(q4, kc, vc, pos0, start0, spec=spec, bk=256,
                              tq=tq)
        want = kattn.to_rows(ref.attention_ref(
            q.float(), kc.float(), vc.float(), 0, spec, pos=pos0,
            start=start0), hkv)
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= ATTN_ATOL,
              f"contiguous attention over a {name} cache off by {err}")
        plain = kattn.to_rows(ref.attention_ref(q, kc, vc, 0, spec, pos=pos0,
                                                start=start0), hkv)
        plain_err = float((got - plain.float()).abs().max())
        plain_tol = BF16_ATTN_ATOL if dt == torch.bfloat16 else ATTN_ATOL
        check(plain_err <= plain_tol, f"contiguous attention over a {name} "
              f"cache off the plain identity branch by {plain_err}")
        nar_nans, nar_err = contiguous_nar_check(torch, q, kc, vc, spec, pos0,
                                                 start0)
        kp, vp = kpf.to(dt), vpf.to(dt)
        kp[4, 10, 3, 7] = float("nan")   # seq 1, position 266, head 3
        qd4 = kattn.to_rows(qd, hkv).contiguous()
        gotp = kattn.paged_attention(qd4, kp, vp, pos, startp, table,
                                     spec=spec)
        wantp = kattn.to_rows(ref.paged_attention_ref(
            qd.float(), kp.float(), vp.float(), table, spec, pos=pos,
            start=startp), hkv)
        nan_ok = torch.equal(torch.isnan(gotp), torch.isnan(wantp))
        clean = (bool(torch.isnan(gotp[1, 3]).all())
                 and int(torch.isnan(gotp).sum()) == grp * hd)
        fin = torch.isfinite(wantp)
        paged_err = float((gotp[fin] - wantp[fin]).abs().max())
        check(nan_ok and clean and paged_err <= ATTN_ATOL,
              f"paged attention over a {name} cache: nan_ok={nan_ok} "
              f"clean={clean} err={paged_err}")
        res[name] = {
            "contiguous_max_abs_err": err,
            "contiguous_plain_branch_max_abs_err": plain_err,
            "contiguous_plain_branch_tolerance": plain_tol,
            "contiguous_nar_nans": nar_nans,
            "contiguous_nar_max_abs_err": nar_err,
            "paged_max_abs_err": paged_err, "nan_rows_poisoned": clean,
            "tolerance": ATTN_ATOL,
            "contiguous_ms": cuda_ms(torch, lambda: kattn.attention(
                q4, kc, vc, pos0, start0, spec=spec, bk=256, tq=tq)),
            "paged_ms": cuda_ms(torch, lambda: kattn.paged_attention(
                qd4, kp, vp, pos, startp, table, spec=spec), iters=50),
            "paged_device_ms": graph_ms(
                torch, lambda: kattn.paged_attention(
                    qd4, kp, vp, pos, startp, table, spec=spec), iters=50)}
        del kc, vc, kp, vp, got, want, plain, gotp, wantp
    torch.cuda.empty_cache()
    return res


def same_cache(torch, got, want) -> bool:
    """Bit-exact cache contents; NaN by place in a float cache (NaN
    payloads differ between casts)."""
    from repro_torch.core.bitops import carrier
    if got.dtype in (torch.bfloat16, torch.float32):
        nan = torch.isnan(want)
        ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        return (torch.equal(torch.isnan(got), nan)
                and torch.equal(got.view(ints[got.dtype])[~nan],
                                want.view(ints[got.dtype])[~nan]))
    return torch.equal(carrier(got), carrier(want))


def kv_append_inputs(torch, dev, spec, dtype, in_dtype, mode, seed,
                     hkv=10, hd=128):
    """Fresh K/V at the main path's shapes (a decode step [4, 1, 10, 128]
    into a 24-page pool of 256 positions, or a prefill chunk [1, 256, 10,
    128] into a 1280-position cache; ``hkv``/``hd`` another model's heads)
    with zeros, infinities and a NaN among them, stale cache words, and
    where they go: the paged table and pos of phase 4 (an idle slot whose
    stale pos 4000 lies past its table), or position 256 of the
    contiguous cache."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (4, 1, hkv, hd) if mode == "paged" else (1, 256, hkv, hd)
    cshape = (24, 256, hkv, hd) if mode == "paged" else (1, 1280, hkv, hd)
    k, v = (torch.randn(shape, generator=g, device=dev)
            * torch.pow(2.0, torch.randint(-20, 20, shape, generator=g,
                                           device=dev).float())
            for _ in range(2))
    k.view(-1)[:5] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                   float("nan")], device=dev)
    caches = []
    for _ in range(2):
        x = torch.randn(cshape, generator=g, device=dev)
        caches.append(x.to(dtype) if spec.is_identity
                      else spec.encode_tile(x))
    where = {"pos": 256}
    if mode == "paged":
        where = {"table": torch.tensor(
                     [[1, 2, 0, 0, 0], [3, 4, 5, 0, 0], [6, 7, 8, 9, 10],
                      [0, 0, 0, 0, 0]], dtype=torch.int32, device=dev),
                 "pos": torch.tensor([76, 520, 1023, 4000],
                                     dtype=torch.int32, device=dev)}
    return k.to(in_dtype), v.to(in_dtype), caches[0], caches[1], where


def kv_append_phase(torch, dev):
    """Phase 19, the append: ``takum_codec.kv_append`` against
    ``ref.kv_append_ref`` on the card, both modes, the six wire formats and
    the bf16 / f32 caches, bf16 and f32 inputs: every word of both caches
    bit-exact (NaN by place). The LNS formats are held bit-exact to the
    plain append with the encode kernel's words (one device function),
    and to the plain codec's words or their neighbours (logf against the
    plain log at an ell_bar tie, phase 7)."""
    from repro_torch import formats
    from repro_torch.core.bitops import carrier
    from repro_torch.kernels import ref, takum_codec
    res = {}
    kinds = [(n, None) for n in WIRE_KV] + [("none", torch.bfloat16),
                                            ("none", torch.float32)]
    for name, dtype in kinds:
        spec = formats.get(name)
        label = name if dtype is None else f"{name}-{str(dtype)[6:]}"
        row = {"cases": 0, "bit_exact": True, "neighbour_words": 0}
        for in_dtype in (torch.bfloat16, torch.float32):
            for mode in ("paged", "contiguous"):
                k, v, kc, vc, where = kv_append_inputs(
                    torch, dev, spec, dtype, in_dtype, mode,
                    len(res) * 8 + row["cases"])
                gk, gv = kc.clone(), vc.clone()
                n0 = takum_codec.kv_append.launches
                takum_codec.kv_append(k, v, gk, gv, spec, **where)
                check(takum_codec.kv_append.launches == n0 + 1,
                      f"kv_append {label} {mode}: not one launch")
                enc = (takum_codec.encode if spec.kind == "lns"
                       else ref.encode_ref)
                wk, wv = kc.clone(), vc.clone()
                ref.kv_append_ref(k, v, wk, wv, spec, encode=enc, **where)
                ok = same_cache(torch, gk, wk) and same_cache(torch, gv, wv)
                check(ok, f"kv_append {label} {mode} {in_dtype}: differs "
                      "from the plain append")
                if spec.kind == "lns":
                    pk, pv = kc.clone(), vc.clone()
                    ref.kv_append_ref(k, v, pk, pv, spec, **where)
                    mod = 1 << spec.n
                    step = torch.cat([
                        ((carrier(a).long() - carrier(b).long()) % mod
                         ).reshape(-1) for a, b in ((gk, pk), (gv, pv))])
                    check(bool(torch.isin(step, torch.tensor(
                        [0, 1, mod - 1], device=dev)).all()),
                          f"kv_append {label}: a word more than one step "
                          "from the plain codec's")
                    row["neighbour_words"] += int((step != 0).sum())
                row["cases"] += 1
                del k, v, kc, vc, gk, gv, wk, wv
        res[label] = row
    torch.cuda.empty_cache()
    return res


def kv_append_times(torch, dev):
    """The append at the main path's two shapes, takum8 words from bf16
    K/V (the activations' dtype at full width): CUDA events over
    back-to-back calls, CUDA-graph replays, the plain version, and the
    bound: K and V read once, the words written once, pos and the table
    read once, over 3.35 TB/s."""
    from repro_torch import formats
    from repro_torch.kernels import ref, takum_codec
    t8 = formats.get("takum8")
    out = {}
    for mode in ("paged", "contiguous"):
        k, v, kc, vc, where = kv_append_inputs(
            torch, dev, t8, None, torch.bfloat16, mode, 99)
        nbytes = 2 * k.numel() * (2 + 1) + sum(
            x.numel() * 4 for x in where.values()
            if isinstance(x, torch.Tensor))

        def call():
            takum_codec.kv_append(k, v, kc, vc, t8, **where)

        b_ms, b_by = bound(nbytes, 0)
        out[mode] = {
            "shape": list(k.shape), "cache": list(kc.shape),
            "ms": cuda_ms(torch, call, iters=200),
            "device_ms": graph_ms(torch, call, iters=200),
            "plain_ms": cuda_ms(torch, lambda: ref.kv_append_ref(
                k, v, kc, vc, t8, **where), iters=5),
            # the two encode launches the append replaces, by events
            "two_encodes_ms": cuda_ms(torch, lambda: (
                takum_codec.encode(k, t8), takum_codec.encode(v, t8)),
                iters=200),
            "bound_ms": b_ms, "bound_by": b_by}
        del k, v, kc, vc
    return out


def graph_vs_eager(torch, dev, params, cfg, *, plens, max_new, late_at,
                   late_plen, late_new, seed=19):
    """Phase 19, the step: the same requests served twice at full width
    through ``ServeEngine.submit``/``run``, the decode step replayed from
    a CUDA graph and under ``disable_graphs()``: one request per prompt
    length with its own ``max_new`` (a short one finishes early and
    releases its slot), and one more submitted after ``late_at`` streamed
    tokens (admitted mid-run: a prefill and a ``push_tables`` between
    replays). Every step's active rows of logits bit-identical, the K/V
    pools (and table / pos / start) byte-identical at the end, the greedy
    tokens equal."""
    from repro_torch.core.bitops import carrier
    from repro_torch.serve.engine import ServeEngine
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in plens + (late_plen,)]
    runs = {}
    for mode in ("graph", "eager"):
        eng = ServeEngine(params, cfg, max_len=1280, page_size=256,
                          decode_batch=4, device=dev)
        sched = eng.scheduler()
        runner, rows, pushes = sched.step, [], []

        def rec(tok, pos, runner=runner, rows=rows, sched=sched):
            logits, head = runner(tok, pos)
            act = [i for i, s in enumerate(sched._slots)
                   if s is not None and s.state == "active"]
            rows.append((act, logits[act].clone()))
            return logits, head

        def push(orig=sched.pool.push_tables, rows=rows, pushes=pushes):
            pushes.append(len(rows))
            orig()

        sched.step, sched.pool.push_tables = rec, push
        t0 = time.perf_counter()
        with eager_mode(mode == "eager"):
            rids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
            for n, _ in enumerate(eng.run()):
                if n + 1 == late_at:
                    rids.append(eng.submit(prompts[-1], late_new))
        torch.cuda.synchronize()
        runs[mode] = {"toks": [eng.result(r) for r in rids], "rows": rows,
                      "cache": sched.pool.cache, "runner": runner,
                      "pushes": pushes, "s": time.perf_counter() - t0}
        del eng, sched
    gr, er = runs["graph"], runs["eager"]
    steps = len(gr["rows"])
    check(len(rids) == len(plens) + 1, "the late request was not submitted")
    check(gr["toks"] == er["toks"], "graph and eager greedy tokens differ")
    check(steps == len(er["rows"]) and steps >= 64,
          f"{steps} graph steps against {len(er['rows'])} eager (>= 64)")
    for i, ((ag, lg), (ae, le)) in enumerate(zip(gr["rows"], er["rows"])):
        check(ag == ae and torch.equal(lg.view(torch.int32),
                                       le.view(torch.int32)),
              f"step {i}: graph and eager logits of the active rows differ")
    for lg, le in zip(gr["cache"], er["cache"]):
        for key in ("k", "v", "table", "pos", "start"):
            a, b = carrier(lg[key]), carrier(le[key])
            if a.dtype in (torch.bfloat16, torch.float32):
                a, b = (x.view(torch.int16 if x.dtype == torch.bfloat16
                               else torch.int32) for x in (a, b))
            check(torch.equal(a, b), f"graph and eager pools differ ({key})")
    between = [n for n in gr["pushes"] if 1 <= n < steps]
    check(len(between) >= 2, "no admission and release between replays")
    runner = gr["runner"]
    check(runner.captures == 1 and runner.replays == steps - 1,
          f"{runner.captures} captures, {runner.replays} replays for "
          f"{steps} steps")
    out = {"weights_kv": cfg.kv_quant, "decode_steps": steps,
           "replays": runner.replays, "requests": len(rids),
           "push_tables_between_replays": len(between),
           "active_rows_compared": sum(len(a) for a, _ in gr["rows"]),
           "logits_bit_identical": True, "pools_identical": True,
           "tokens_equal": True, "graph_run_s": round(gr["s"], 2),
           "eager_run_s": round(er["s"], 2)}
    del runs, gr, er
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the bf16 tie rule of tests/test_torch_serve.py: two greedy streams of
# bf16 activations computed through other kernels may part only where the
# reference stream's two best logits lie within 2^-5 of its largest logit
# (a few bf16 units), and the other stream took the second of them
TIE_REL = 2.0 ** -5
# the fresh-prefill attention (bf16 q/k/v, the online softmax over two key
# blocks, its accumulator in bf16) against the unchunked _sdpa on the same
# inputs: both outputs are bf16, rounded at other points (p, p.v, the
# accumulator after each block), so they may differ by a bf16 unit or two
# at the largest output: |diff| <= FRESH_REL * max|out| (2^-6 relative is
# 2 to 4 units of bf16's 8-bit significand)
FRESH_REL = 2.0 ** -6


class FakeClock:
    """A scheduler clock that moves only when told (deadlines)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def lockstep_traced(torch, eng, prompts, max_new):
    """``eng.generate_lockstep`` with each forward timed (synchronised on
    both sides) and its logits' two best values and tokens kept: (tokens,
    [(top2 values [B, 2], top2 ids [B, 2]) per forward], prefill s, decode
    ms per step)."""
    from repro_torch.models import model
    orig_prefill, orig_step = model.prefill, model.decode_step
    tops, walls = [], {"prefill": 0.0, "decode": 0.0, "steps": 0}

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls[key] += time.perf_counter() - t0
            walls["steps"] += key == "decode"
            top = torch.topk(logits.float(), 2, dim=-1)
            tops.append((top.values.cpu(), top.indices.cpu()))
            return logits, cache
        return wrapped

    model.prefill = timed(orig_prefill, "prefill")
    model.decode_step = timed(orig_step, "decode")
    try:
        toks = eng.generate_lockstep(prompts, max_new)
    finally:
        model.prefill, model.decode_step = orig_prefill, orig_step
    return (toks, tops, walls["prefill"],
            1e3 * walls["decode"] / max(walls["steps"], 1))


def tie_equal(want, tops, row, got, plen):
    """Whether ``got`` equals the lockstep stream ``want`` (row ``row`` of
    a traced lockstep run), or leaves it at a bf16 tie of the lockstep's
    logits: "equal", "tie at i (gap g)" with g the two best logits'
    difference over the largest, or None."""
    if got == want:
        return "equal"
    i = next(i for i, (a, b) in enumerate(zip(want[plen:], got[plen:]))
             if a != b)
    vals, ids = tops[i]
    v, t = vals[row].tolist(), ids[row].tolist()
    if (v[0] - v[1] <= TIE_REL * abs(v[0])
            and got[plen + i] == t[1] and want[plen + i] == t[0]):
        return f"tie at {i} (gap {(v[0] - v[1]) / abs(v[0]):.2e})"
    return None


def lockstep_phase(torch, dev, params, cfg, wrappers, plens, max_new):
    """Phase 20: phase 5's prompts left-padded into one lockstep batch at
    full width; each prompt served alone through the paged scheduler
    against the same prompt alone through lockstep (equal, or parting at
    a bf16 tie), and against its row of the batch (the unpadded row must
    agree so; the padded rows, whose positions are shifted by their
    start, are reported with the layer-0 score change the shift makes);
    the fresh-prefill attention against the unchunked ``_sdpa`` on one
    2048-token layer input; contiguous attention at the lockstep decode
    step's shape (tq = 1) timed against its bound and SDPA."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import takum_attention as kattn
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import CACHE_SLACK, ServeEngine
    g = torch.Generator().manual_seed(5)       # phase 5's prompts
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in plens]
    eng = ServeEngine(params, cfg, max_len=1280, page_size=256,
                      decode_batch=4, device=dev)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks, tops, prefill_s, step_ms = lockstep_traced(torch, eng, prompts,
                                                     max_new)
    lock_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for k in ("kv_append", "qmatmul", "attention"):
        check(launches[k] > 0, f"lockstep launched no {k}")
    check(launches["paged_attention"] == 0,
          "lockstep launched paged attention")
    check(launches["attention"] == cfg.n_layers * (1 + max_new),
          f"{launches['attention']} contiguous attention launches for "
          f"{cfg.n_layers} layers x {1 + max_new} forwards")
    # each prompt served alone through the scheduler, and alone through
    # lockstep (no padding: the scheduler's positions); the batch's rows
    # against the scheduler: a left-padded row sits at positions shifted
    # by its start, and its rotated q/k round to other bf16 values there
    # (measured below), so only rows without padding must give the
    # scheduler's stream; the padded rows are reported
    solo, batch_rows = {}, {}
    for i, p in enumerate(prompts):
        got = eng.generate([p], max_new)[0]
        alone, tops1, _, _ = lockstep_traced(torch, eng, [p], max_new)
        verdict = tie_equal(alone[0], tops1, 0, got, len(p))
        check(verdict is not None, f"solo lockstep tokens of the {len(p)}-"
              "token prompt differ from its scheduler run, not at a tie")
        solo[len(p)] = verdict
        row = tie_equal(toks[i], tops, i, got, len(p))
        if len(p) == max(plens):
            check(row is not None, "the unpadded lockstep row differs from "
                  "its scheduler run, not at a tie")
        first = next((j for j, (a, b) in enumerate(zip(toks[i], got))
                      if a != b), None)
        batch_rows[len(p)] = {"start": max(plens) - len(p), "verdict": row,
                              "first_differing_token": (None if first is None
                                                        else first - len(p))}
    # the mechanism: layer 0's rotated q and k of the shortest prompt at
    # its padded positions against positions from 0, as bf16 scores
    p0 = eng.params["layers"][0]
    x = L.embed(eng.params, torch.tensor([prompts[0]], device=dev),
                torch.bfloat16)
    xn = L.rmsnorm(p0["ln1"], x)
    shift = max(plens) - plens[0]
    scores = []
    for off in (0, shift):
        positions = torch.arange(plens[0], device=dev)[None] + off
        q, k, _ = L._proj_qkv(p0["attn"], xn, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, cfg.rope_base, positions)
        # one query head of each KV head against that KV head's keys
        scores.append(torch.einsum(
            "bqhd,bkhd->bhqk",
            q[:, :, ::cfg.n_heads // cfg.n_kv_heads].float(), k.float()))
    rel = ((scores[0] - scores[1]).abs()
           / scores[0].abs().clamp(min=1e-3)).median()
    rope_shift = {"prompt": plens[0], "shift": shift,
                  "layer0_score_rel_diff_median": float(rel)}
    del x, xn, q, k, scores
    check(all(len(o) == len(p) + max_new for o, p in zip(toks, prompts)),
          "lockstep output has the wrong shape")
    # the fresh branch: one layer's q/k/v at 2048 tokens, chunked against
    # the unchunked attention under the causal mask
    gx = torch.Generator(device=dev).manual_seed(20)
    x = torch.randn((1, L.ATTN_CHUNK_T, cfg.d_model), device=dev,
                    generator=gx).to(torch.bfloat16)
    p0 = eng.params["layers"][0]
    positions = torch.arange(L.ATTN_CHUNK_T, device=dev)[None]
    q, k, v = L._proj_qkv(p0["attn"], L.rmsnorm(p0["ln1"], x), cfg.n_heads,
                          cfg.n_kv_heads, cfg.hd, cfg.rope_base, positions)
    fresh = L._sdpa_chunked(q, k, v)
    full = L._sdpa(q, k, v, L.causal_mask(L.ATTN_CHUNK_T, L.ATTN_CHUNK_T,
                                          device=dev))
    fresh_err = float((fresh.float() - full.float()).abs().max())
    fresh_max = float(full.float().abs().max())
    check(bool(torch.isfinite(fresh).all())
          and fresh_err <= FRESH_REL * fresh_max,
          f"fresh-prefill attention off the unchunked one by {fresh_err} "
          f"(largest output {fresh_max})")
    fresh_ms = cuda_ms(torch, lambda: L._sdpa_chunked(q, k, v), iters=5)
    del x, q, k, v, fresh, full
    # contiguous attention at the lockstep decode step: B 4, rows G = 4
    # per KV head, tq = 1, the cache rounded to 256-key tiles, each row's
    # start its left padding
    t8 = eng.params["layers"][0]["attn"]["wq"].spec
    hkv, grp, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    plen = max(plens)
    tmax = -(-(plen + max_new + CACHE_SLACK) // 256) * 256
    pos = plen + max_new - 1
    gd = torch.Generator(device=dev).manual_seed(20)
    qd = torch.randn((4, 1, hkv * grp, hd), generator=gd, device=dev)
    kc = ref.encode_ref(torch.randn((4, tmax, hkv, hd), generator=gd,
                                    device=dev), t8)
    vc = ref.encode_ref(torch.randn((4, tmax, hkv, hd), generator=gd,
                                    device=dev), t8)
    start = torch.tensor([plen - n for n in plens], dtype=torch.int32,
                         device=dev)
    q4 = kattn.to_rows(qd, hkv).contiguous()

    def kernel():
        return kattn.attention(q4, kc, vc, pos, start, spec=t8, tq=1)

    got = kattn.from_rows(kernel(), 1)
    want = ref.attention_ref(qd, kc, vc, 8, t8, pos=pos, start=start)
    err = float((got - want).abs().max())
    check(err <= ATTN_ATOL, f"contiguous attention at tq = 1 off by {err}")
    keys = [pos - int(s) + 1 for s in start.tolist()]
    b_ms, b_by = bound(q4.numel() * 4 * 2 + sum(keys) * hkv * hd * 2,
                       4 * hd * grp * hkv * sum(keys) * tf32_products(t8),
                       TF32_FLOPS)
    kf = ref.decode_ref(kc, t8)[:, :pos + 1].transpose(1, 2)
    vf = ref.decode_ref(vc, t8)[:, :pos + 1].transpose(1, 2)
    j = torch.arange(pos + 1, device=dev)
    keep = (j[None, :] >= start[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qf = qd.transpose(1, 2)

    def library():
        return sdpa(qf, kf, vf, attn_mask=keep, enable_gqa=True)

    lib_err = float((library().transpose(1, 2) - got).abs().max())
    tq1 = {"shape": list(q4.shape), "cache": [4, tmax, hkv, hd],
           "pos": pos, "start": start.tolist(), "max_abs_err": err,
           "ms": cuda_ms(torch, kernel, iters=100),
           "device_ms": graph_ms(torch, kernel, iters=100),
           "plain_ms": cuda_ms(torch, lambda: ref.attention_ref(
               qd, kc, vc, 8, t8, pos=pos, start=start), iters=5),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms(torch, library, iters=100),
           "library_device_ms": graph_ms(torch, library, iters=100),
           "library_max_abs_err": lib_err,
           "library_call": "scaled_dot_product_attention(enable_gqa=True) "
                           "on K/V decoded to f32 beforehand (not timed), "
                           "boolean start mask",
           "launches_lockstep": launches["attention"]}
    del kc, vc, kf, vf, qd, q4, got, want
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"prompts": list(plens), "max_new": max_new,
            "generate_lockstep_s": round(lock_s, 3),
            "prefill_s": round(prefill_s, 3),
            "decode_ms_per_step": round(step_ms, 2),
            "step": "eager (the contiguous attention takes pos as a host int)",
            "solo_lockstep_vs_scheduler": solo,
            "batch_rows_vs_scheduler": batch_rows,
            "rope_shift": rope_shift, "launches": launches,
            "fresh_branch": {"shape": [1, L.ATTN_CHUNK_T, cfg.n_heads, cfg.hd],
                             "max_abs_err": fresh_err,
                             "max_abs_out": fresh_max,
                             "tolerance": f"{FRESH_REL:g} x max|out|",
                             "ms": fresh_ms},
            "attention_tq1": tq1}


def failure_phase(torch, dev, params, cfg):
    """Phase 21: the failure model at full width on one scheduler (decode
    batch 4, 256-position pages, a pool of 8 allocatable pages: the four
    first requests hold 7, the priority-5 one needs 5 and must preempt,
    and whichever request a fault poisons, the pages left after its
    quarantine still serve the rest): run A without faults, run B with
    one NaR word injected into a live page; both with a cancelled request
    and one past its deadline on a fake clock."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import FaultInjector
    g = torch.Generator().manual_seed(21)
    lens = {"low": 300, "mid": 520, "deadline": 77, "cancel": 100,
            "high": 1024}
    prompts = {k: torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for k, n in lens.items()}
    max_new = 16
    clock = FakeClock()
    eng = ServeEngine(params, cfg, max_len=1100, page_size=256,
                      decode_batch=4, num_pages=9, prefix_cache=False,
                      now_fn=clock, device=dev)
    sched = eng.scheduler()
    runs = {}
    captures = []
    for run in ("A", "B"):
        clock.t = 0.0
        rids = {k: eng.submit(prompts[k], max_new,
                              deadline_ms=5000.0 if k == "deadline" else None)
                for k in ("low", "mid", "deadline", "cancel")}
        preempt0 = sched.preemptions
        seen = {k: 0 for k in rids}
        by_rid = {r: k for k, r in rids.items()}
        injected = []
        for ev in eng.run():
            k = by_rid.get(ev.rid)
            if k is not None and ev.status == "ok":
                seen[k] += 1
            if k == "low" and seen["low"] == 2 and "high" not in rids:
                rids["high"] = eng.submit(prompts["high"], max_new,
                                          priority=5)
                by_rid[rids["high"]] = "high"
                seen["high"] = 0
            if k == "cancel" and seen["cancel"] == 2:
                eng.cancel(rids["cancel"])
            if "high" in rids and seen["high"] == 1 and clock.t == 0.0:
                clock.t = 10.0            # past the 5 s deadline
            if (run == "B" and "high" in rids and seen["high"] == 3
                    and sched.injector is None and not injected):
                sched.injector = FaultInjector(sched.pool, rate=1.0, seed=4,
                                               kind="nar", target="live",
                                               max_faults=1)
                injected = sched.injector.injected
            if sched.step.captures:
                captures.append(sched.step.captures)
        sched.injector = None
        status = {k: eng.status(r) for k, r in rids.items()}
        outs = {k: (eng.result(r) if status[k] == "done" else None)
                for k, r in rids.items()}
        runs[run] = {"status": status, "outs": outs,
                     "preemptions": sched.preemptions - preempt0,
                     "injected": [dataclasses.asdict(r) for r in injected],
                     "quarantined": sorted(sched.pool.quarantined_pages())}
        for r in rids.values():
            eng.forget(r)
    a, b = runs["A"], runs["B"]
    check(a["preemptions"] >= 1, "run A: the priority-5 request preempted "
          "nothing")
    check(a["status"] == {"low": "done", "mid": "done", "deadline": "timeout",
                          "cancel": "cancelled", "high": "done"},
          f"run A statuses {a['status']}")
    ties = {}
    for k in ("low", "high"):
        toks, tops, _, _ = lockstep_traced(torch, eng, [prompts[k]], max_new)
        verdict = tie_equal(toks[0], tops, 0, a["outs"][k], lens[k])
        check(verdict is not None, f"run A: the {k} request's tokens differ "
              "from its solo lockstep run, not at a tie")
        ties[k] = verdict
    poisoned = [k for k, st in b["status"].items() if st == "poisoned"]
    check(len(b["injected"]) == 1 and len(poisoned) == 1,
          f"run B: {len(b['injected'])} faults, poisoned {poisoned}")
    check(b["injected"][0]["page"] in b["quarantined"],
          "run B: the corrupted page is not quarantined")
    for k, st in a["status"].items():
        if k in poisoned:
            continue
        check(b["status"][k] == st and b["outs"][k] == a["outs"][k],
              f"run B: the {k} request moved ({st} -> {b['status'][k]})")
    check(captures and len(set(captures)) == 1 and captures[-1] == 1,
          f"the decode step was captured again: {sorted(set(captures))}")
    out = {"pool_pages": 8, "page_size": 256, "decode_batch": 4,
           "requests": lens, "max_new": max_new,
           "run_a": {"status": a["status"], "preemptions": a["preemptions"]},
           "run_b": {"status": b["status"], "preemptions": b["preemptions"],
                     "fault": b["injected"][0],
                     "quarantined_pages": b["quarantined"]},
           "solo_lockstep": ties, "captures": sched.step.captures,
           "replays": sched.step.replays}
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return out


def telemetry_phase(torch, dev, params, cfg, plens, max_new):
    """Phase 22: phase 5's requests served with ``REPRO_OBS`` unset, 1 and
    2 (new engines, the same weights): the same tokens; every request's
    span tree closed and rooted at ``request``; the trace exported as
    Chrome JSON; no capture after ``arm_steady``; at level 2, ``scan_nar``
    counts exactly the NaR words written into live pages."""
    from repro_torch.obs import export
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import FaultInjector
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in plens]
    saved = os.environ.get("REPRO_OBS")
    runs = {}
    try:
        for lvl in ("0", "1", "2"):
            os.environ["REPRO_OBS"] = lvl
            eng = ServeEngine(params, cfg, max_len=1280, page_size=256,
                              decode_batch=4, device=dev)
            sched = eng.scheduler()
            wall = {"s": 0.0, "n": 0}
            step = sched._decode_step

            def timed_step(step=step, wall=wall, sched=sched):
                busy = any(s is not None and s.state == "active"
                           for s in sched._slots)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                events = list(step())
                torch.cuda.synchronize()
                if busy and sched.step.replays:     # the capture left out
                    wall["s"] += time.perf_counter() - t0
                    wall["n"] += 1
                yield from events

            sched._decode_step = timed_step
            rids = [eng.submit(p, max_new) for p in prompts]
            armed = False
            for _ in eng.run():
                if eng.obs is not None and not armed and sched.step.replays:
                    eng.obs.arm_steady()
                    armed = True
            runs[lvl] = {"toks": [eng.result(r) for r in rids],
                         "decode_ms_per_step": round(
                             1e3 * wall["s"] / max(wall["n"], 1), 2)}
            if lvl != "0":
                tr = eng.obs.tracer
                for r in rids:
                    spans = tr.track_spans(r)
                    check(tr.open_depth(r) == 0 and spans
                          and spans[0].name == "request"
                          and [s.depth for s in spans].count(0) == 1
                          and all(s.t1 is not None and s.t1 >= s.t0
                                  for s in spans),
                          f"REPRO_OBS={lvl}: request {r}'s spans are "
                          "incomplete")
                check(eng.obs.steady_state_recompiles == 0,
                      f"REPRO_OBS={lvl}: {eng.obs.steady_state_recompiles} "
                      "captures after warm-up")
                recs = eng.trace_records({"phase": 22, "obs": lvl})
                doc = json.loads(json.dumps(export.chrome_trace(recs)))
                out = ROOT / "chiprun_out"
                out.mkdir(exist_ok=True)
                (out / f"trace_obs{lvl}.json").write_text(json.dumps(doc))
                runs[lvl].update(trace_events=len(doc["traceEvents"]),
                                 spans=len(tr.spans),
                                 instants=len(tr.instants))
            if lvl == "2":
                # a new request, then NaR words into its live pages
                rid = eng.submit(prompts[1], max_new)
                stream = eng.run()
                next(stream)                     # its prefill is in pages
                before = sched.pool.scan_nar()
                inj = FaultInjector(sched.pool, rate=3.0, seed=8,
                                    kind="nar", target="live")
                recs = inj.step(sched._tick)
                sites = {(r.page, r.rep, r.key, r.offset) for r in recs}
                after = sched.pool.scan_nar()
                for _ in stream:
                    pass
                check(after - before == len(sites) == 3,
                      f"scan_nar counted {after - before} of {len(sites)} "
                      "injected words")
                check(eng.status(rid) == "poisoned",
                      "the NaR words did not poison their request")
                runs[lvl].update(nar_injected=len(sites),
                                 nar_scanned=after - before,
                                 captures=sched.step.captures)
            eng.obs is not None and eng.obs.close()
            del eng, sched
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("REPRO_OBS", None)
        else:
            os.environ["REPRO_OBS"] = saved
    check(runs["1"]["toks"] == runs["0"]["toks"] == runs["2"]["toks"],
          "tokens differ between REPRO_OBS levels")
    return {"tokens_equal_across_levels": True,
            "decode_ms_per_step": {f"obs{k}": v["decode_ms_per_step"]
                                   for k, v in runs.items()},
            **{f"obs{k}": {kk: vv for kk, vv in v.items()
                           if kk not in ("toks", "decode_ms_per_step")}
               for k, v in runs.items() if k != "0"}}


# training: the wire matmuls' VJP at full width (phase 23)
GRAD_FMTS = ("takum8", "posit8", "lns-takum8")
GRAD_SHAPE = (256, 5120, 17920)   # x [M, K] through w [K, N]: wg/w1
# the reduced model trained on the card against the CPU (phase 25): losses
# within LOSS_REL, and each parameter leaf within PARAM_REL_L2 of the
# other's in relative L2 norm. Elementwise, AdamW divides m by sqrt(v) + eps,
# so a gradient element within a few eps of 0 turns its summation-order
# error into an O(1) relative error of its update: those elements are
# reported against tests/test_substrate.py's reordered-sum tolerance
# (REORDER_*), not held. The same program run twice (resume) is held
# elementwise within RESUME_RTOL / RESUME_ATOL
LOSS_REL = 1e-5
PARAM_REL_L2 = 1e-5
REORDER_RTOL, REORDER_ATOL = 2e-4, 2e-6
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-7
TRAIN_LAYERS = 2          # phase 24's depth, cut from 40
TRAIN_T = 2048            # phase 24's tokens: both chunked paths
TRAIN_STEPS = 6
# AdamW moves every weight by about lr a step; at d_model 5120 (weights
# of std 0.014) lr 1e-3 diverged on the card (loss 12.23 -> 15.38 in six
# steps, PERF.md section 6); 1e-4 is the usual rate at this width
TRAIN_LR = 1e-4


def wire_grad_phase(torch, dev, wrappers, sm_clock_hz):
    """Phase 23: x [256, 5120] f32 through 5120 x 17920 wire weights of each
    ``GRAD_FMTS``, forward (rows 3 / 7) and backward (``g @ decode(w)^T``,
    the decode through row 1, posit8 through its table, row 8): x.grad
    against the plain version's autograd gradient (``x @ decode_ref(w)``
    differentiated), bit for bit: both are one f32 ``torch.matmul`` (TF32
    off, checked) of the same ``g`` with a bit-exact decode, so a limit
    of 0, where phase 3's statistical limit holds a product that is not
    the same; the launch counters of the run; forward and backward by
    CUDA events."""
    from repro_torch import formats
    from repro_torch.kernels import ops, ref
    m, k, n = GRAD_SHAPE
    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 23 needs TF32 off: the backward's product is f32")
    g0 = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn((m, k), generator=g0, device=dev)
    g = torch.randn((m, n), generator=g0, device=dev)
    wf = torch.randn((k, n), generator=g0, device=dev) / k ** 0.5
    out = {}
    total = {key: 0 for key in wrappers}
    for name in GRAD_FMTS:
        spec = formats.get(name)
        w = ops.takum_encode(wf, spec)
        fn = ops.lns_matmul if spec.has_lns_parts else ops.quant_matmul
        for f in wrappers.values():
            f.launches = 0
        xt = x.clone().requires_grad_(True)
        y = fn(xt, w, spec)
        y.backward(g)
        launches = {key: f.launches for key, f in wrappers.items()}
        for key in total:
            total[key] += launches[key]
        mm = "lns_matmul" if spec.has_lns_parts else "qmatmul"
        check(launches[mm] == 1 and launches["takum_decode"] == 1,
              f"{name}: the gradient run launched {launches}")
        if name == "posit8":
            check(launches["posit8_lut"] >= 1,
                  "posit8: the backward's decode missed the table")
        wd = ref.decode_ref(w, spec)
        xp = x.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(xp @ wd, xp, g)
        err = (xt.grad - want).abs()
        check(bool(torch.isfinite(xt.grad).all()), f"{name}: x.grad not "
              "finite")
        check(torch.equal(xt.grad, want), f"{name}: x.grad differs from "
              f"the plain gradient by up to {float(err.max())}")
        fwd_ms = cuda_ms(torch, lambda: fn(x, w, spec), iters=10)
        xr = x.clone().requires_grad_(True)
        yr = fn(xr, w, spec)
        bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            yr, xr, g, retain_graph=True), iters=10)
        # the backward: the decode (words in, f32 out) and the product
        # (g, w f32 and x.grad once each; 2 m k n f32 FMAs, TF32 off)
        nbytes = (k * n * spec.n // 8 + k * n * 4
                  + m * n * 4 + k * n * 4 + m * k * 4)
        b_ms, b_by = bound(nbytes, 2 * m * k * n)
        if spec.has_lns_parts:   # one expf a product (phase 8's bound)
            t_sfu = m * k * n / (16 * 132 * sm_clock_hz) * 1e3
            t_bytes = (m * k * 4 + k * n + 4 * m * n) / HBM_BYTES_PER_S * 1e3
            f_ms, f_by = ((t_sfu, "operations") if t_sfu >= t_bytes
                          else (t_bytes, "bytes"))
        else:
            f_ms, f_by = mm_bound(spec, m, k, n)
        out[name] = {"shape": [m, k, n], "max_abs_err": float(err.max()),
                     "bit_equal_to_plain": True,
                     "launches": launches, "forward_ms": fwd_ms,
                     "forward_bound_ms": f_ms, "forward_bound_by": f_by,
                     "backward_ms": bwd_ms, "backward_bound_ms": b_ms,
                     "backward_bound_by": b_by,
                     "backward_library_ms": cuda_ms(
                         torch, lambda: torch.matmul(g, wd.T), iters=10)}
        del w, y, yr, xr, xt, xp, want, wd, err
    del x, g, wf
    torch.cuda.empty_cache()
    return out, total


def train_cfg(layers):
    """phi3-medium-14b's registered config, its depth cut to ``layers``
    (None: as registered)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("phi3-medium-14b").config
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def full_width_training(torch, dev):
    """Phase 24: phi3-medium-14b at full width, depth cut to
    ``TRAIN_LAYERS``, ``TRAIN_STEPS`` AdamW steps on one repeated
    ``SyntheticLM(seed=0)`` batch of 1 x ``TRAIN_T`` tokens, remat per
    block, each step ``trainer.make_train_step``'s three calls
    (``_grads_fn``, ``clip_by_global_norm``, ``apply_update``) timed one
    by one (phase 25 drives ``make_train_step`` itself); per step the
    loss, the grad norm, the step's host time (synchronised) and its
    split into the forward+backward and the optimizer (clip + AdamW)."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.models import model
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves
    cfg = train_cfg(TRAIN_LAYERS)
    full_layers = train_cfg(None).n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    state = opt.init_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=0, schedule="const")
    grads_of = trainer._grads_fn(cfg, RuntimeConfig(remat="block"))
    batch = dp.SyntheticLM(cfg.vocab, TRAIN_T, 1, seed=0).batch_at(0)
    batch = trainer._device_batch(batch, dev)
    rows = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, met, grads = grads_of(params, batch)
        torch.cuda.synchronize()
        t_mid = time.perf_counter()
        grads, gnorm = opt.clip_by_global_norm(grads, ocfg.clip_norm)
        params, state = opt.apply_update(params, grads, state, ocfg)
        del grads
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows.append({"step": i, "loss": float(met["loss"]),
                     "grad_norm": float(gnorm),
                     "step_ms": 1e3 * (t1 - t),
                     "fwd_bwd_ms": 1e3 * (t_mid - t),
                     "optimizer_ms": 1e3 * (t1 - t_mid),
                     "tokens_per_s": TRAIN_T / (t1 - t)})
    for r in rows:
        check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
              f"training step {r['step']}: loss or grad norm not finite")
    check(rows[-1]["loss"] < rows[0]["loss"],
          f"training loss did not fall: {rows[0]['loss']} -> "
          f"{rows[-1]['loss']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = rows[1:]
    res = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "reduced": {"n_layers": f"{full_layers} -> {TRAIN_LAYERS}"},
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "params": n_params, "batch": [1, TRAIN_T], "remat": "block",
           "optimizer": f"AdamW lr {TRAIN_LR:g} const, clip 1.0",
           "init_s": init_s, "steps": rows,
           "loss_first_last": [rows[0]["loss"], rows[-1]["loss"]],
           "step_ms_steady_mean": sum(r["step_ms"] for r in steady)
           / len(steady),
           "tokens_per_s_steady_mean": sum(r["tokens_per_s"] for r in steady)
           / len(steady),
           "peak_gb": peak_gb}
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _max_diffs(torch, a_tree, b_tree):
    from repro_torch.tree import tree_leaves
    abs_, rel, rel_l2 = 0.0, 0.0, 0.0
    ok_reorder, ok_resume = True, True
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        d = (a - b).abs()
        abs_ = max(abs_, float(d.max()))
        rel = max(rel, float((d / b.abs().clamp(min=1e-30)).max()))
        rel_l2 = max(rel_l2, float(d.norm() / b.norm().clamp(min=1e-30)))
        ok_reorder &= bool((d <= REORDER_ATOL + REORDER_RTOL * b.abs()).all())
        ok_resume &= bool((d <= RESUME_ATOL + RESUME_RTOL * b.abs()).all())
    return {"max_abs": abs_, "max_rel": rel, "max_leaf_rel_l2": rel_l2,
            "bit_equal": abs_ == 0.0, "within_reorder_tol": ok_reorder,
            "within_resume_tol": ok_resume}


def reduced_training(torch, dev, tmp):
    """Phase 25: the reduced config (f32) trained on the card and on the
    CPU from the same parameters; microbatch 2 and remat against the full
    batch on the card; a takum16 checkpoint saved, restored and resumed
    against the same rounding done in memory, and an uncompressed one
    against the uninterrupted run; SIGTERM through ``PreemptionGuard``;
    both launchers as subprocesses."""
    import signal
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.core import takum
    from repro_torch.data import pipeline as dp
    from repro_torch.models import model
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    from repro_torch.tree import tree_map
    cfg = get_arch("phi3-medium-14b").reduced
    cpu_params = model.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    ds = dp.SyntheticLM(cfg.vocab, 64, 4, seed=3)
    # tests/test_substrate.py's two settings: no clipping where two
    # reductions are compared (clipping shrinks every gradient element
    # towards AdamW's eps, where the update is most sensitive to it), and
    # its resume run
    reorder_cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="const",
                                  clip_norm=1e9)
    resume_cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="const")

    def run(rt, params, state, s0, s1, ocfg=reorder_cfg):
        step = trainer.make_train_step(cfg, ocfg, rt)
        losses = []
        for s in range(s0, s1):
            params, state, met = step(params, state, ds.batch_at(s))
            losses.append(float(met["loss"]))
        return params, state, losses

    res = {}
    block = RuntimeConfig(remat="block")
    card_params = tree_map(lambda t: t.to(dev), cpu_params)
    runs = {d: run(block, p, opt.init_state(p), 0, 3)
            for d, p in (("cpu", cpu_params), ("card", card_params))}
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"][2],
                                                  runs["cpu"][2]))
    check(rel <= LOSS_REL, f"reduced training: card losses {runs['card'][2]} "
          f"against the CPU's {runs['cpu'][2]}")
    pd = _max_diffs(torch, runs["card"][0], runs["cpu"][0])
    check(pd["max_leaf_rel_l2"] <= PARAM_REL_L2, f"reduced training: card "
          f"parameters differ from the CPU's by {pd}")
    res["card_vs_cpu"] = {"losses_card": runs["card"][2],
                          "losses_cpu": runs["cpu"][2],
                          "loss_max_rel": rel, "params": pd}

    full = run(RuntimeConfig(remat="none"), card_params,
               opt.init_state(card_params), 0, 1)
    for key, rt in (("microbatch_2", RuntimeConfig(remat="none",
                                                   microbatch=2)),
                    ("remat", block)):
        got = run(rt, card_params, opt.init_state(card_params), 0, 1)
        d = _max_diffs(torch, got[0], full[0])
        check(d["max_leaf_rel_l2"] <= PARAM_REL_L2
              and abs(got[2][0] - full[2][0]) <= LOSS_REL * abs(full[2][0]),
              f"reduced training: {key} differs from the full batch: {d}")
        res[key] = dict(d, loss=got[2][0], loss_full=full[2][0])

    plain = RuntimeConfig(remat="none")
    p_a, _, _ = run(plain, card_params, opt.init_state(card_params), 0, 6,
                    resume_cfg)
    p_b, st_b, _ = run(plain, card_params, opt.init_state(card_params), 0, 3,
                       resume_cfg)
    tree = {"params": p_b, "m": st_b.m, "v": st_b.v}
    for codec in ("none", "takum16"):
        d = str(tmp / f"ck_{codec}")
        ckpt.save(3, tree, d, codec=codec)
        got, s = ckpt.restore(d, tree, device=dev)
        st = opt.AdamWState(got["m"], got["v"],
                            torch.tensor(s, dtype=torch.int32, device=dev))
        p_c, _, _ = run(plain, got["params"], st, 3, 6, resume_cfg)
        if codec == "none":
            want = p_a
        else:
            rt = tree_map(lambda t: takum.takum_to_float(
                takum.float_to_takum(t, 16), 16), tree)
            want, _, _ = run(plain, rt["params"], opt.AdamWState(
                rt["m"], rt["v"], torch.tensor(3, dtype=torch.int32,
                                               device=dev)), 3, 6,
                             resume_cfg)
        dd = _max_diffs(torch, p_c, want)
        check(dd["within_resume_tol"], f"resume through a {codec} "
              f"checkpoint differs from the uninterrupted run: {dd}")
        res[f"resume_{codec}"] = dd

    old = signal.getsignal(signal.SIGTERM)
    try:
        mgr = ckpt.CheckpointManager(str(tmp / "preempt"), codec="takum16",
                                     save_interval=100)
        params, state = card_params, opt.init_state(card_params)
        step = trainer.make_train_step(cfg, resume_cfg, plain)
        saved = []
        for s in range(4):
            params, state, _ = step(params, state, ds.batch_at(s))
            if s == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            if mgr.maybe_save(s, {"params": params}):
                saved.append(s)
        mgr.wait()
    finally:
        signal.signal(signal.SIGTERM, old)
    check(saved == [1] and ckpt.latest_step(str(tmp / "preempt")) == 1,
          f"SIGTERM at step 1 saved at steps {saved}")
    res["preemption"] = {"sigterm_at": 1, "saved_at": saved}

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    launchers = {}
    for name, argv in (("train", ["--arch", "phi3-medium-14b", "--reduced",
                                  "--steps", "5"]),
                       ("serve", ["--arch", "phi3-medium-14b", "--reduced",
                                  "--weights", "takum8", "--kv-quant",
                                  "takum8"])):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.launch.{name}"] + argv,
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        lines = proc.stdout.splitlines()
        check(proc.returncode == 0, f"launch.{name} exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        check(bool(lines) and lines[0].startswith("# repro-config "),
              f"launch.{name} printed no audit line first")
        launchers[name] = {"rc": proc.returncode, "audit": lines[0],
                           "last": lines[-1], "wall_s":
                           time.perf_counter() - t}
    res["launchers"] = launchers
    return res


# -- phases 26-27: the moe family -----------------------------------------------

# (arch, layers served: None = all) of phases 26 and 27; kimi-k2's depth is
# cut to 1 of 61 layers (one layer's experts are 16.9 G parameters, 33.8 GB
# in bf16), its widths are the config's
MOE_PHASES = (("granite-moe-3b-a800m", None), ("kimi-k2-1t-a32b", 1))
MOE_LATE = (72, 24, 72, 72)      # phase 19's requests for graph vs eager


def moe_cfg(arch, layers):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).config
    return dataclasses.replace(cfg, kv_quant="takum8",
                               n_layers=layers or cfg.n_layers)


def moe_params(torch, dev, cfg, dtype):
    """A moe model's weights at full width, random from a seeded
    generator on the card (embeddings bf16, the layers in ``dtype``:
    None = the config's ``param_dtype``), through ``quantize_weights(params, "takum8",
    mode="wire", in_place=True)``: the attention projections wired, the
    router and the expert stacks fake-quantised in place (one exponent a
    leaf over every layer, as the reference's stacked leaf; a slice of
    the expert axis at a time). Returns (params, seconds, fake-quant
    launches)."""
    from repro_torch.kernels import quantize as kquant
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.serve.engine import quantize_weights
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = L.embed_init(gen, cfg.vocab, cfg.d_model, dtype=torch.bfloat16,
                          device=dev)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dev)
    params["layers"] = [transformer.init_layer(gen, cfg, device=dev, dtype=dtype)
                        for _ in range(cfg.n_layers)]
    kquant.fake_quant.launches = 0
    params = quantize_weights(params, "takum8", mode="wire", verbose=False,
                              in_place=True)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0, kquant.fake_quant.launches


def attention_check(torch, dev, hkv, grp, hd, seed):
    """Both attention kernels at Hkv ``hkv``, G ``grp``, head dim ``hd``
    over takum8 words, at the shapes a serving run gives them: the last
    256-token chunk of a 1024-token prompt (pos 768 of a 1280-position
    cache), and a decode step of 4 sequences (pos 76, 520, 1023 and an
    idle slot at a stale 4000) over 256-position pages. Each is held to
    its plain version on the same inputs (ATTN_ATOL), with NaR words: a K
    word of the paged pool (seq 1, position 266, head 3: that row NaN,
    every other finite, as the plain version's) and the contiguous
    kernel's :func:`contiguous_nar_check`. Each is timed beside its bound
    and its library call, scaled_dot_product_attention on K/V decoded
    beforehand. Returns (contiguous entry, paged entry, NaR fields)."""
    from repro_torch import formats
    from repro_torch.core import takum
    from repro_torch.kernels import ref, takum_codec
    from repro_torch.kernels import takum_attention as kattn
    t8 = formats.get("takum8")
    ps, tq, pos0, tcache = 256, 256, 768, 1280
    g = torch.Generator(device=dev).manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # contiguous
    q = torch.randn((1, tq, hkv * grp, hd), generator=g, device=dev)
    kc = takum_codec.encode(torch.randn((1, tcache, hkv, hd), generator=g,
                                        device=dev), t8)
    vc = takum_codec.encode(torch.randn((1, tcache, hkv, hd), generator=g,
                                        device=dev), t8)
    start0 = torch.zeros(1, dtype=torch.int32, device=dev)
    q4 = kattn.to_rows(q, hkv).contiguous()

    def contiguous():
        return kattn.attention(q4, kc, vc, pos0, start0, spec=t8, bk=ps,
                               tq=tq)

    got = contiguous()
    want = kattn.to_rows(ref.attention_ref(q, kc, vc, 8, t8, pos=pos0,
                                           start=start0), hkv)
    c_err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and c_err <= ATTN_ATOL,
          f"hd {hd} contiguous attention off by {c_err}")
    nar_nans, nar_err = contiguous_nar_check(torch, q, kc, vc, t8, pos0,
                                             start0)
    keys_needed = sum(pos0 + r + 1 for r in range(tq)) * grp * hkv
    b_ms, b_by = bound(q4.numel() * 4 * 2 + 2 * (pos0 + tq) * hkv * hd,
                       4 * hd * keys_needed * tf32_products(t8), TF32_FLOPS)
    kf = ref.decode_ref(kc, t8)[:, :pos0 + tq].transpose(1, 2)
    vf = ref.decode_ref(vc, t8)[:, :pos0 + tq].transpose(1, 2)
    qf = q.transpose(1, 2)
    causal = (torch.arange(pos0 + tq, device=dev)[None, :]
              <= (pos0 + torch.arange(tq, device=dev))[:, None])
    cont = {"shape": list(q4.shape), "max_abs_err": c_err,
            "ms": cuda_ms(torch, contiguous),
            "plain_ms": cuda_ms(torch, lambda: ref.attention_ref(
                q, kc, vc, 8, t8, pos=pos0, start=start0), iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, lambda: sdpa(
                qf, kf, vf, attn_mask=causal, enable_gqa=True))}
    del kc, vc, kf, vf, qf, q, q4, got, want
    # paged
    npg, pool_pages = 5, 24
    kp = takum_codec.encode(torch.randn((pool_pages, ps, hkv, hd),
                                        generator=g, device=dev), t8)
    vp = takum_codec.encode(torch.randn((pool_pages, ps, hkv, hd),
                                        generator=g, device=dev), t8)
    table = torch.tensor([[1, 2, 0, 0, 0], [3, 4, 5, 0, 0],
                          [6, 7, 8, 9, 10], [0, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([76, 520, 1023, 4000], dtype=torch.int32, device=dev)
    startp = torch.zeros(4, dtype=torch.int32, device=dev)
    kp[4, 10, 3, 7] = takum.nar_word(8)       # seq 1, position 266, head 3
    qd = torch.randn((4, 1, hkv * grp, hd), generator=g, device=dev)
    qd4 = kattn.to_rows(qd, hkv).contiguous()

    def paged():
        return kattn.paged_attention(qd4, kp, vp, pos, startp, table, spec=t8)

    gotp = paged()
    wantp = kattn.to_rows(ref.paged_attention_ref(qd, kp, vp, table, t8,
                                                  pos=pos, start=startp), hkv)
    nan_ok = torch.equal(torch.isnan(gotp), torch.isnan(wantp))
    poisoned = bool(torch.isnan(gotp[1, 3]).all())
    clean = int(torch.isnan(gotp).sum()) == grp * hd
    fin = torch.isfinite(wantp)
    p_err = float((gotp[fin] - wantp[fin]).abs().max())
    check(nan_ok and poisoned and clean and p_err <= ATTN_ATOL,
          f"hd {hd} paged attention: nan_ok={nan_ok} poisoned={poisoned} "
          f"clean={clean} err={p_err}")
    need = [min(int(p) + 1, npg * ps) for p in pos.tolist()]
    b_ms, b_by = bound(qd4.numel() * 4 * 2 + sum(need) * hkv * hd * 2,
                       4 * hd * grp * hkv * sum(need))
    # the library call: each sequence's in-band pages gathered and decoded
    # beforehand, padded to the longest, under its own boolean mask
    lens = [min(int(p) // ps, npg - 1) * ps + ps for p in pos.tolist()]
    kg = torch.zeros((4, hkv, max(lens), hd), device=dev)
    vg = torch.zeros_like(kg)
    keep = torch.zeros((4, 1, 1, max(lens)), dtype=torch.bool, device=dev)
    for i, n_keys in enumerate(lens):
        pages = table[i, :n_keys // ps].long()
        kg[i, :, :n_keys] = ref.decode_ref(kp[pages], t8).reshape(
            n_keys, hkv, hd).transpose(0, 1)
        vg[i, :, :n_keys] = ref.decode_ref(vp[pages], t8).reshape(
            n_keys, hkv, hd).transpose(0, 1)
        j = torch.arange(n_keys, device=dev)
        keep[i, 0, 0, :n_keys] = (j <= pos[i]) & (j >= startp[i])
    qg = qd.transpose(1, 2)                  # [B, H, 1, hd]

    def paged_library():
        return sdpa(qg, kg, vg, attn_mask=keep, enable_gqa=True)

    lib_out = kattn.to_rows(paged_library().transpose(1, 2), hkv)
    lib_fin = torch.isfinite(lib_out) & torch.isfinite(gotp)
    pag = {"shape": list(qd4.shape), "max_abs_err": p_err,
           "partition_keys": kattn.paged_partition_keys(hd, 8),
           "ms": cuda_ms(torch, paged, iters=100),
           "device_ms": graph_ms(torch, paged, iters=100),
           "plain_ms": cuda_ms(torch, lambda: ref.paged_attention_ref(
               qd, kp, vp, table, t8, pos=pos, start=startp), iters=5),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms(torch, paged_library, iters=100),
           "library_device_ms": graph_ms(torch, paged_library, iters=100),
           "library_max_abs_err": float(
               (lib_out - gotp)[lib_fin].abs().max())}
    del kp, vp, kg, vg, keep, qg, qd, qd4, gotp, wantp, lib_out, lib_fin
    torch.cuda.empty_cache()
    return cont, pag, {"contiguous_nar_nans": nar_nans,
                       "contiguous_nar_max_abs_err": nar_err,
                       "nar_rows_poisoned": poisoned}


def hd_attention_check(torch, dev, cfg):
    """Both attention kernels (:func:`attention_check`) and the append at
    ``cfg``'s heads (kimi-k2: Hkv 8, G 8, hd 112), takum8 words: the
    append of a decode step and of a chunk held bit for bit to the plain
    append, and timed."""
    from repro_torch import formats
    from repro_torch.kernels import ref, takum_codec
    t8 = formats.get("takum8")
    hkv, hd = cfg.n_kv_heads, cfg.hd
    grp = cfg.n_heads // hkv
    cont, pag, nar = attention_check(torch, dev, hkv, grp, hd, seed=27)
    # the append, both modes, against the plain append
    app = {}
    for mode in ("paged", "contiguous"):
        k, v, kc, vc, where = kv_append_inputs(
            torch, dev, t8, None, torch.bfloat16, mode, 270, hkv=hkv, hd=hd)
        gk, gv = kc.clone(), vc.clone()
        takum_codec.kv_append(k, v, gk, gv, t8, **where)
        wk, wv = kc.clone(), vc.clone()
        ref.kv_append_ref(k, v, wk, wv, t8, **where)
        ok = same_cache(torch, gk, wk) and same_cache(torch, gv, wv)
        check(ok, f"hd {hd} kv_append {mode}: differs from the plain append")
        app[mode] = {"shape": list(k.shape), "bit_exact": True,
                     "ms": cuda_ms(torch, lambda: takum_codec.kv_append(
                         k, v, gk, gv, t8, **where), iters=100)}
        del k, v, kc, vc, gk, gv, wk, wv
    torch.cuda.empty_cache()
    return {"hd": hd, "hkv": hkv, "group": grp, "contiguous": cont,
            "paged": pag, "nar": nar, "kv_append": app,
            "tolerance": ATTN_ATOL}


def moe_phase(torch, dev, arch, layers, wrappers):
    """Phases 26 and 27: ``arch`` at full width (``layers`` of it: None =
    all) with takum8 wire attention and a takum8 KV cache, phase 5's
    requests served through the scheduler, the decode step replayed from
    a CUDA graph; every wrapper's launches from that run. granite-moe
    (26): the replayed step against the eager one over >= 64 steps, bit
    for bit, and the reduced config card against CPU. kimi-k2 (27): its
    hd 112 through both attention kernels and the append, each held to
    its plain version at the served shapes (:func:`hd_attention_check`)."""
    from repro_torch.configs import get_arch
    cfg = moe_cfg(arch, layers)
    # a full-width kimi-k2 layer's expert stacks fit the card only in bf16
    dtype = None if layers is None else torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    params, weights_s, fq = moe_params(torch, dev, cfg, dtype)
    check(fq > 0, f"{arch}: quantize_weights launched no fake-quant kernel")
    serve = serve_full_width(torch, dev, wfmt="takum8", kv="takum8",
                             plens=PHASE5_PLENS, max_new=16, max_len=1280,
                             wrappers=wrappers, params=params, cfg=cfg)
    serve["weights_s"] = round(weights_s, 2)
    serve["experts"] = {"n": cfg.n_experts, "top_k": cfg.top_k,
                        "d_ff": cfg.d_ff,
                        "capacity_factor": cfg.capacity_factor,
                        "dtype": str(params["layers"][0]["moe"]
                                     ["experts_w1"].dtype)[6:]}
    serve["layers_of"] = get_arch(arch).config.n_layers
    serve["fake_quant_launches_setup"] = fq
    launches = serve["launches"]
    for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
        check(launches[k] > 0, f"{arch}: kernel {k} was not launched by the "
              "serving run")
    check(launches["takum_encode"] == 0 and launches["takum_decode"] == 0,
          f"{arch}: the serving run launched the standalone codec")
    out = {"serving": serve}
    if layers is None:
        out["graph_vs_eager"] = graph_vs_eager(
            torch, dev, params, cfg, plens=PHASE5_PLENS, max_new=MOE_LATE,
            late_at=40, late_plen=150, late_new=32)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["reduced_card_vs_cpu"] = reduced_card_vs_cpu(
            torch, dev, wfmt="takum8", kv="takum8", arch=arch)
    else:
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["hd_kernels"] = hd_attention_check(torch, dev, cfg)
    return out


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
    from repro_torch.core.bitops import carrier, to_words
    from repro_torch.kernels import build
    from repro_torch.kernels import lns_matmul as klns
    from repro_torch.kernels import ref
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import takum_attention as kattn
    from repro_torch.kernels import takum_codec, takum_matmul

    # -- 1. device and build ---------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi("name", "power.limit")
    print(card)
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
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
        # the (mangled) kernels that spill, for chip_smoke.json
        spilling = re.findall(r"Function properties for (\S+)\s+\S.*?(\d+) "
                              r"bytes spill stores, (\d+) bytes spill loads",
                              info["log"])
        detail.setdefault("spilling_kernels", {})[src] = [
            k for k, a, b in spilling if int(a) + int(b)]
    phase(1, "device+build", device=name, count=count, card=card,
          clocks_max_sm_mhz=sm_clock_mhz,
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
    shapes = MM_SHAPES
    mm = []
    worst = 0.0
    ratio = {"kernel": 0.0, "tf32_x": float("inf"), "bf16_x": float("inf")}
    for spec in (t8, t16):
        for m, k, n in shapes:
            row = wire_matmul_check(torch, dev, spec, m, k, n)
            ctrl = row["control_max_err_over_stat_limit"]
            for key in ("tf32_x", "bf16_x"):
                ratio[key] = min(ratio[key], ctrl[key])
            ratio["kernel"] = max(ratio["kernel"],
                                  row["max_err_over_stat_limit"])
            worst = max(worst, row["max_abs_err"])
            mm.append(row)
    phase(3, "wire matmul", shapes=len(mm), max_abs_err=worst,
          tolerance="2*K*2^-24*(|x|@|w|) elementwise (worst case) and "
                    f"{C_STAT:g}*sqrt(K)*2^-24*sqrt((x*x)@(w*w)) (statistical): "
                    "f32 sums over K <= 17920 in another order",
          kernel_max_over_stat_limit=ratio["kernel"],
          tf32_x_control_min_over_stat_limit=ratio["tf32_x"],
          bf16_x_control_min_over_stat_limit=ratio["bf16_x"])
    detail["matmul_checks"] = mm

    # -- 4. attention -----------------------------------------------------
    att, patt, att_nar = attention_check(torch, dev, hkv=10, grp=4, hd=128,
                                         seed=4)
    phase(4, "attention", contiguous_rows=att["shape"][2],
          contiguous_max_abs_err=att["max_abs_err"],
          contiguous_nar_nans=att_nar["contiguous_nar_nans"],
          contiguous_nar_max_abs_err=att_nar["contiguous_nar_max_abs_err"],
          paged_max_abs_err=patt["max_abs_err"],
          nar_rows_poisoned=att_nar["nar_rows_poisoned"], tolerance=ATTN_ATOL)

    # -- kernel times at the main path's shapes ---------------------------
    # the codec pair (decode and encode kernels of codec.cu) is one entry,
    # headed by the decode at a weight-sized word tensor (the standalone
    # op; its device function is inlined into the matmul and attention
    # kernels), with its library call; the standalone encode writes the
    # wire weights and the activations entering each LNS matmul (the K/V
    # words of every layer call are the fused append's, phase 19)
    def codec_times(fn, plain, x, nbytes, iters, spec=t8):
        b_ms, b_by = bound(nbytes, 0)
        return {"shape": list(x.shape),
                "ms": cuda_ms(torch, lambda: fn(x, spec), iters=iters),
                "plain_ms": cuda_ms(torch, lambda: plain(x, spec), iters=3,
                                    warmup=1),
                "bound_ms": b_ms, "bound_by": b_by}

    w_f32 = torch.randn((5120, 17920), device=dev)
    w_t8 = takum_codec.encode(w_f32, t8)
    codec_t = {
        "encode_weights": codec_times(
            takum_codec.encode, ref.encode_ref, w_f32,
            w_f32.numel() * 5, 20),
        "decode_weights": codec_times(
            takum_codec.decode, ref.decode_ref, w_t8,
            w_t8.numel() * 5, 20)}
    codec_t["decode_weights"].update(table_library(torch, w_t8, t8))
    del w_f32, w_t8
    main_t = codec_t["decode_weights"]
    kernels["takum_codec"] = dict(
        route="cuda", source="src/repro_torch/csrc/codec.cu",
        replaces="src/repro/kernels/takum_codec.py:56",
        also_replaces="src/repro/kernels/takum_codec.py:73 (the standalone "
                      "encode; the KV append is the kv_append entry)",
        max_abs_err=codec_worst, shape=main_t["shape"], ms=main_t["ms"],
        plain_ms=main_t["plain_ms"], bound_ms=main_t["bound_ms"],
        bound_by=main_t["bound_by"], library_ms=main_t["library_ms"],
        library_call=main_t["library_call"],
        encode_library_call="none: no single PyTorch op rounds to takum or "
                            "posit words",
        launches_path="the standalone decode and encode launches of the "
                      "serving runs, phases 5 / 10 / 15 / 18 (the LNS "
                      "activations of phase 10)",
        detail=codec_t)
    detail["codec_times"] = codec_t
    # qmatmul: every projection shape of a layer, decode and prefill, for
    # takum8 (the plain version timed beside it) and takum16
    for spec in (t8, t16):
        mm_times = []
        for m, k, n in shapes:
            x = torch.randn((m, k), device=dev)
            w = takum_codec.encode(torch.randn((k, n), device=dev) / k ** 0.5,
                                   spec)
            b_ms, b_by = mm_bound(spec, m, k, n)
            row = {"m": m, "k": k, "n": n,
                   "ms": cuda_ms(torch, lambda: takum_matmul.qmatmul(
                       x, w, spec)),
                   "bound_ms": b_ms, "bound_by": b_by}
            if spec is t8:
                row["plain_ms"] = cuda_ms(torch, lambda: ref.qmatmul_ref(
                    x, w, spec), iters=5)
            if spec is t8 and (m, k, n) in LIBRARY_SHAPES:
                # one PyTorch call on the weights decoded beforehand, TF32
                # off (the kernel keeps f32 products)
                wd = ref.decode_ref(w, spec)
                row["library_ms"] = cuda_ms(torch, lambda: torch.matmul(
                    x, wd))
                row["device_ms"] = graph_ms(
                    torch, lambda: takum_matmul.qmatmul(x, w, spec))
                row["library_device_ms"] = graph_ms(
                    torch, lambda: torch.matmul(x, wd))
                del wd
            mm_times.append(row)
            del x, w
        detail[f"matmul_times_{spec.name}"] = mm_times
    mm_times = detail["matmul_times_takum8"]
    rep = next(r for r in mm_times if (r["m"], r["k"], r["n"]) == (4, 5120, 17920))
    pre = next(r for r in mm_times
               if (r["m"], r["k"], r["n"]) == (256, 5120, 17920))
    kernels["qmatmul"] = dict(
        route="cuda", source="src/repro_torch/csrc/qmatmul.cu",
        replaces="src/repro/kernels/takum_matmul.py:105",
        redesigned="streaming kernel for M <= 16, split-TF32 tensor cores "
                   "above",
        max_abs_err=worst,
        shape=[4, 5120, 17920], ms=rep["ms"], plain_ms=rep["plain_ms"],
        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
        library_ms=rep["library_ms"], device_ms=rep["device_ms"],
        library_device_ms=rep["library_device_ms"],
        library_call="torch.matmul(x, w) with w decoded to f32 beforehand "
                     "(decode not timed), "
                     "torch.backends.cuda.matmul.allow_tf32 = False",
        bound_note="M = 4 streams on f32 FMAs (67 TFLOP/s); the prefill "
                   f"bound counts {tf32_products(t8)} TF32 tensor-core "
                   "products per multiply-add at 495 TFLOP/s",
        prefill={"shape": [256, 5120, 17920], "ms": pre["ms"],
                 "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
                 "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
                 "device_ms": pre["device_ms"],
                 "library_device_ms": pre["library_device_ms"]})
    # the attention kernels at phase 4's shapes (attention_check): the
    # contiguous one on the tensor cores, tf32_products per multiply-add
    kernels["attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/takum_attention.py:158",
        redesigned="split-TF32 tensor cores",
        bound_note=f"{tf32_products(t8)} TF32 tensor-core products per "
                   "multiply-add at 495 TFLOP/s over the keys each row needs",
        library_call="scaled_dot_product_attention on K/V decoded to f32 "
                     "beforehand (decode not timed)", **att)
    kernels["paged_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/attention.cu",
        replaces="src/repro/kernels/takum_attention.py:301",
        redesigned="flash-decoding: partitions of (bits / 2) x 4 x "
                   "(32 // lanes a key) keys (8192 / hd at a power-of-two "
                   "hd, 64 at hd 112), merged in order by the last block of "
                   "each (sequence, KV head)",
        library_call="scaled_dot_product_attention(enable_gqa=True) over "
                     "each sequence's in-band pages gathered and decoded to "
                     "f32 beforehand (not timed), padded to the longest, "
                     "with that sequence's boolean causal/start mask",
        timing_note="ms: CUDA events over back-to-back calls (the host's "
                    "time where it is the slower side); device_ms: the same "
                    "calls replayed from a CUDA graph", **patt)

    # -- 5. serving at full width -----------------------------------------
    wrappers = {"takum_decode": takum_codec.decode,
                "takum_encode": takum_codec.encode,
                "kv_append": takum_codec.kv_append,
                "qmatmul": takum_matmul.qmatmul,
                "lns_matmul": klns.lns_matmul,
                "attention": kattn.attention,
                "paged_attention": kattn.paged_attention,
                "fake_quant": kquant.fake_quant,
                "posit8_lut": build.posit8_lut}
    serve = serve_full_width(torch, dev, wfmt="takum8", kv="takum8",
                             plens=PHASE5_PLENS, max_new=16,
                             max_len=1280, wrappers=wrappers)
    serve["card"] = card
    launches = serve["launches"]
    # the kernels of this path: the K/V words through the fused append,
    # none through the standalone codec
    for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
        check(launches[k] > 0, f"kernel {k} was not launched by the "
              "serving run")
    check(launches["takum_encode"] == 0 and launches["takum_decode"] == 0,
          "the takum8 serving run launched the standalone codec")
    for k in ("qmatmul", "attention", "paged_attention"):
        kernels[k]["launches"] = launches[k]
    kernels["takum_codec"]["launches"] = (launches["takum_decode"]
                                          + launches["takum_encode"])
    kv_append_launches = {"5": launches["kv_append"]}
    phase(5, "serving phi3-medium-14b full width", **serve)
    detail["serving"] = serve

    # -- 6. reduced model, card against CPU --------------------------------
    red = reduced_card_vs_cpu(torch, dev, wfmt="takum8", kv="takum8")
    phase(6, "reduced model card vs cpu", **red)

    # -- 7. LNS codec ------------------------------------------------------
    lns_codec, lns_codec_worst = lns_codec_phase(torch, dev)
    phase(7, "lns codec", **lns_codec,
          tolerance="lns_parts bit-exact; decode within 2 ulp (expf); "
                    "encode equal or neighbour words (logf at an ell_bar "
                    f"rounding tie), share <= {LNS_NEIGHBOUR_SHARE:g}")
    detail["lns_codec"] = lns_codec
    lns8 = formats.get("lns-takum8")
    kv_prefill = torch.randn((1, 256, 10, 128), device=dev)
    x_prefill = torch.randn((256, 17920), device=dev)
    w_lns8 = takum_codec.encode(torch.randn((5120, 17920), device=dev), lns8)
    lns_codec_t = {
        "encode_kv_prefill_chunk": codec_times(
            takum_codec.encode, ref.encode_ref, kv_prefill,
            kv_prefill.numel() * 5, 200, lns8),
        "encode_activations_prefill_w2": codec_times(
            takum_codec.encode, ref.encode_ref, x_prefill,
            x_prefill.numel() * 5, 50, lns8),
        "decode_weights": codec_times(
            takum_codec.decode, ref.decode_ref, w_lns8, w_lns8.numel() * 5,
            20, lns8)}
    del kv_prefill, x_prefill, w_lns8
    kernels["takum_codec"]["lns"] = dict(
        lns_codec_t, max_abs_err=lns_codec_worst,
        decode_max_ulps=max(v["decode_max_ulps"] for v in lns_codec.values()),
        encode_neighbour_share=max(v["encode_neighbour_share"]
                                   for v in lns_codec.values()))

    # -- 8. LNS matmul -----------------------------------------------------
    lmm = lns_matmul_phase(torch, dev, sm_clock_mhz * 1e6)
    phase(8, "lns matmul", each_product=lmm["each_product"],
          linear_shapes=len(lmm["linear"]),
          linear_max_abs_err=lmm["max_abs_err"],
          linear_max_err_over_bound=max(r["max_err_over_bound"]
                                        for r in lmm["linear"]),
          kernel_max_over_stat_limit=max(r["max_err_over_stat_limit"]
                                         for r in lmm["linear"]),
          control_min_over_stat_limit={
              key: min(r["control_max_err_over_stat_limit"][key]
                       for r in lmm["linear"])
              for key in ("tf32_product", "bf16_product")},
          gauss=[{k: r[k] for k in ("m", "k", "n", "state_bit_exact",
                                    "max_ulps")} for r in lmm["gauss"]],
          nar_row_column=lmm["nar_row_column"],
          ms={f"{a} {r['m']}x{r['k']}x{r['n']}": r["ms"]
              for a in ("linear", "gauss") for r in lmm[a]},
          tolerance="linear K = 1: 2 ulp (one expf per product); linear: "
                    "(2K+4)*2^-24*(|x|@|w|) (worst case) and "
                    f"{C_STAT:g}*sqrt(K)*2^-24*sqrt((x*x)@(w*w)) "
                    "(statistical) elementwise; gauss: integer state "
                    "bit-exact, output within 2 ulp")
    detail["lns_matmul"] = lmm
    rep = next(r for r in lmm["linear"]
               if (r["m"], r["k"], r["n"]) == (4, 5120, 17920))
    pre = next(r for r in lmm["linear"]
               if (r["m"], r["k"], r["n"]) == (256, 5120, 17920))
    kernels["lns_matmul"] = dict(
        route="cuda", source="src/repro_torch/csrc/lns_matmul.cu",
        replaces="src/repro/kernels/lns_matmul.py:246",
        redesigned="streaming column strips for M <= 16, register-blocked "
                   "tiles above; lv operands, the sign by XOR, one expf a "
                   "product",
        max_abs_err=lmm["max_abs_err"], shape=[4, 5120, 17920],
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
        bound_by=rep["bound_by"], library_ms=rep["library_ms"],
        device_ms=rep["device_ms"],
        library_device_ms=rep["library_device_ms"],
        library_call="torch.matmul on x and w both decoded to f32 beforehand "
                     "(decode not timed), "
                     "torch.backends.cuda.matmul.allow_tf32 = False: the "
                     "reference's CPU route (lns_qmatmul_ref), one more "
                     "rounding per product than the kernel",
        prefill={"shape": [256, 5120, 17920], "ms": pre["ms"],
                 "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
                 "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
                 "device_ms": pre["device_ms"],
                 "library_device_ms": pre["library_device_ms"]})

    # -- 9. attention over LNS KV -------------------------------------------
    lattn = wire_attention_phase(torch, dev, lns8)
    phase(9, "attention over lns-takum8 kv", **lattn)
    kernels["attention"]["lns_ms"] = lattn["contiguous_ms"]
    kernels["paged_attention"]["lns_ms"] = lattn["paged_ms"]
    kernels["paged_attention"]["lns_device_ms"] = lattn["paged_device_ms"]

    # -- 10. LNS serving at full width ----------------------------------------
    lserve = serve_full_width(torch, dev, wfmt="lns-takum8", kv="lns-takum8",
                              plens=PHASE10_PLENS, max_new=8, max_len=512,
                              wrappers=wrappers)
    lserve["card"] = card
    ll = lserve["launches"]
    lpath = {"takum_codec": ll["takum_decode"] + ll["takum_encode"],
             "kv_append": ll["kv_append"],
             "lns_matmul": ll["lns_matmul"], "attention": ll["attention"],
             "paged_attention": ll["paged_attention"]}
    for k, v in lpath.items():
        check(v > 0, f"kernel {k} was not launched by the LNS serving run")
    check(ll["qmatmul"] == 0, "the LNS serving run launched the takum "
          "wire matmul")
    kernels["lns_matmul"]["launches"] = lpath["lns_matmul"]
    kernels["takum_codec"]["launches"] += lpath["takum_codec"]
    kv_append_launches["10"] = lpath["kv_append"]
    for k in ("takum_codec", "attention", "paged_attention"):
        kernels[k]["launches_lns_serving"] = lpath[k]
    phase(10, "serving phi3-medium-14b full width, lns-takum8", **lserve)
    detail["serving_lns"] = lserve

    # -- 11. reduced model with LNS weights, card against CPU ---------------
    lred = [reduced_card_vs_cpu(torch, dev, wfmt="lns-takum16", kv=kv,
                                free_tol=LNS_FREE_LOGITS_TOL[kv])
            for kv in ("lns-takum8", "takum8")]
    phase(11, "reduced model lns-takum16 weights card vs cpu", cases=lred)

    # -- 12. posit codec ---------------------------------------------------
    pcodec, pcodec_t = posit_codec_phase(torch, dev)
    phase(12, "posit codec", **pcodec,
          ms={k: v["ms"] for k, v in pcodec_t.items()},
          tolerance="bit-exact (integer codec); the table equals the "
                    "computed decode on every word")
    detail["posit_codec"] = {"checks": pcodec, "times": pcodec_t}
    kernels["takum_codec"]["posit"] = pcodec_t

    # -- 13. posit wire matmul ---------------------------------------------
    pmm, pmm_t, pratio = posit_matmul_phase(torch, dev)
    t8_ms = {f"{r['m']}x{r['k']}x{r['n']}": r["ms"] for r in mm_times}
    phase(13, "posit wire matmul", shapes=len(pmm),
          max_abs_err=max(r["max_abs_err"] for r in pmm),
          kernel_max_over_stat_limit=pratio["kernel"],
          tf32_x_control_min_over_stat_limit=pratio["tf32_x"],
          bf16_x_control_min_over_stat_limit=pratio["bf16_x"],
          ms=pmm_t, takum8_ms=t8_ms,
          tolerance="as phase 3: worst-case f32 bound and the statistical "
                    "limit, TF32 and bf16 controls breaking it")
    detail["posit_matmul"] = pmm
    rep = "4x5120x17920"
    kernels["qmatmul"]["posit_ms"] = {label: pmm_t[f"{label} {rep}"]
                                      for _, _, label in POSIT_VARIANTS}

    # -- 14. attention over posit KV -----------------------------------------
    pattn = {}
    for pname, lut, label in POSIT_VARIANTS:
        with lut_switch(lut):
            pattn[label] = wire_attention_phase(torch, dev,
                                                formats.get(pname))
    phase(14, "attention over posit kv", **pattn)
    kernels["attention"]["posit_ms"] = {k: v["contiguous_ms"]
                                        for k, v in pattn.items()}
    kernels["paged_attention"]["posit_ms"] = {k: v["paged_ms"]
                                              for k, v in pattn.items()}
    kernels["paged_attention"]["posit_device_ms"] = {
        k: v["paged_device_ms"] for k, v in pattn.items()}

    # -- 15. posit serving at full width --------------------------------------
    p8 = formats.get("posit8")
    pserve = serve_full_width(torch, dev, wfmt="posit8", kv="posit8",
                              plens=PHASE10_PLENS, max_new=8, max_len=512,
                              wrappers=wrappers)
    pserve["card"] = card
    pserve["posit8_decode"] = "table" if p8.lut_decode(dev) else "computed"
    pl = pserve["launches"]
    ppath = {"kv_append": pl["kv_append"],
             "qmatmul": pl["qmatmul"], "attention": pl["attention"],
             "paged_attention": pl["paged_attention"],
             "posit8_lut": pl["posit8_lut"]}
    for k, v in ppath.items():
        if k != "posit8_lut" or p8.lut_decode(dev):
            check(v > 0, f"kernel {k} was not launched by the posit serving "
                  "run")
    check(pl["lns_matmul"] == 0, "the posit serving run launched the LNS "
          "matmul")
    kernels["takum_codec"]["launches"] += (pl["takum_decode"]
                                           + pl["takum_encode"])
    for k in ("qmatmul", "attention", "paged_attention"):
        kernels[k]["launches_posit_serving"] = ppath[k]
    kv_append_launches["15"] = ppath["kv_append"]
    phase(15, "serving phi3-medium-14b full width, posit8", **pserve)
    detail["serving_posit"] = pserve

    # -- 16. reduced model with posit weights, card against CPU ---------------
    pred = reduced_card_vs_cpu(torch, dev, wfmt="posit16", kv="posit8")
    phase(16, "reduced model posit16 weights card vs cpu", **pred)

    # -- 17. fused fake-quant ----------------------------------------------
    fq = fake_quant_phase(torch, dev)
    fq_layer = quantize_layer_fake(torch, dev, "posit8")
    check(fq_layer["launches"] == 7, f"quantize_weights(mode='fake') over "
          f"one layer launched the fake-quant kernel {fq_layer['launches']} "
          "times, not 7")
    phase(17, "fake-quant", ms={k: v["ms"] for k, v in fq.items()},
          bound_ms={k: v["bound_ms"] for k, v in fq.items()},
          quantize_weights_layer=fq_layer,
          tolerance="bit-exact against the plain version (NaNs by place); "
                    "LNS: the codec kernels' round trip bit for bit, the "
                    "plain version's words or their neighbours, share <= "
                    f"{LNS_NEIGHBOUR_SHARE:g}")
    detail["fake_quant"] = {"rows": fq, "quantize_weights_layer": fq_layer}
    main_fq = fq["posit8 table float32"] if p8.lut_decode(dev) \
        else fq["posit8 computed float32"]
    kernels["fake_quant"] = dict(
        route="cuda", source="src/repro_torch/csrc/fake_quant.cu",
        replaces="src/repro/kernels/quantize.py:36",
        max_abs_err=max(v["max_abs_err"] for v in fq.values()),
        shape=[5120, 17920], ms=main_fq["ms"], plain_ms=main_fq["plain_ms"],
        bound_ms=main_fq["bound_ms"], bound_by=main_fq["bound_by"],
        library_ms=None,
        library_call="none: no PyTorch call rounds to a takum or posit grid",
        launches=fq_layer["launches"],
        launches_path="quantize_weights(layer, 'posit8', mode='fake') over "
                      "one full-width layer",
        detail={k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms")}
                for k, v in fq.items()})
    lut_t = pcodec_t["posit8 table decode_weights"]
    kernels["posit8_lut"] = dict(
        route="cuda", source="src/repro_torch/csrc/wire.cuh",
        replaces="src/repro/formats/registry.py:270",
        max_abs_err=pcodec["posit8 table"]["decode_max_abs_err"],
        shape=lut_t["shape"], ms=lut_t["ms"], plain_ms=lut_t["plain_ms"],
        bound_ms=lut_t["bound_ms"], bound_by=lut_t["bound_by"],
        computed_ms=pcodec_t["posit8 computed decode_weights"]["ms"],
        library_ms=lut_t["library_ms"], library_call=lut_t["library_call"],
        launches=ppath["posit8_lut"],
        launches_path="the kernels of the posit8 serving run (phase 15) "
                      "that decoded through the table",
        note="a decode path inside the codec, wire-matmul, attention and "
             "fake-quant kernels; timed in the codec's decode kernel")

    # -- 18. float (identity-codec) KV caches -------------------------------
    fattn = float_kv_attention_phase(torch, dev)
    fred = reduced_card_vs_cpu(torch, dev, wfmt="takum8", kv="none")
    fserve = serve_full_width(torch, dev, wfmt="takum8", kv="none",
                              plens=PHASE10_PLENS, max_new=8, max_len=512,
                              wrappers=wrappers)
    fserve["card"] = card
    fl = fserve["launches"]
    for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
        check(fl[k] > 0, f"kernel {k} was not launched by the float-KV "
              "serving run")
    check(fl["takum_encode"] == 0 and fl["lns_matmul"] == 0,
          "the float-KV serving run encoded words or ran the LNS matmul")
    kernels["takum_codec"]["launches"] += fl["takum_decode"]
    kv_append_launches["18"] = fl["kv_append"]
    phase(18, "float kv caches", attention=fattn, reduced_card_vs_cpu=fred,
          serving=fserve)
    detail["float_kv"] = {"attention": fattn, "reduced": fred,
                          "serving": fserve}
    for k in ("attention", "paged_attention"):
        kernels[k]["float_kv_ms"] = {
            dt: v["contiguous_ms" if k == "attention" else "paged_ms"]
            for dt, v in fattn.items()}
        kernels[k]["launches_float_kv_serving"] = fl[k]
    kernels["paged_attention"]["float_kv_device_ms"] = {
        dt: v["paged_device_ms"] for dt, v in fattn.items()}

    # -- 19. the compiled decode step --------------------------------------
    app = kv_append_phase(torch, dev)
    app_t = kv_append_times(torch, dev)
    compiled = {}
    for wfmt, plens, max_new, late, ref_serve in (
            ("takum8", PHASE5_PLENS, 16, (72, 24, 72, 72), serve),
            ("lns-takum8", PHASE10_PLENS, 8, (72, 24), lserve)):
        cfg19 = full_width_cfg(wfmt)
        params19, _ = full_width_params(torch, dev, cfg19, wfmt)
        eager = serve_full_width(torch, dev, wfmt=wfmt, kv=wfmt, plens=plens,
                                 max_new=max_new,
                                 max_len=1280 if wfmt == "takum8" else 512,
                                 wrappers=wrappers, eager=True,
                                 params=params19)
        check(eager["launches"] == ref_serve["launches"],
              f"{wfmt}: launch counts under replay {ref_serve['launches']} "
              f"differ from the eager run's {eager['launches']}")
        cmp = graph_vs_eager(torch, dev, params19, cfg19, plens=plens,
                             max_new=late, late_at=40 if wfmt == "takum8"
                             else 10, late_plen=150, late_new=32)
        compiled[wfmt] = dict(
            cmp, decode_ms_per_step=ref_serve["decode_ms_per_step"],
            decode_ms_per_step_eager=eager["decode_ms_per_step"],
            token_gap_ms_median=ref_serve["token_gap_ms_median"],
            token_gap_ms_median_eager=eager["token_gap_ms_median"],
            prefill_s=ref_serve["prefill_s"],
            prefill_s_eager=eager["prefill_s"],
            launches_equal_to_eager=True)
        detail[f"serving_eager_{wfmt}"] = eager
        del params19
        gc.collect()
        torch.cuda.empty_cache()
    phase(19, "compiled decode step", kv_append=app, kv_append_times=app_t,
          **compiled, card=card,
          tolerance="kv_append bit-exact against the plain append (NaN by "
                    "place; LNS words through the encode kernel, and each "
                    "within one step of the plain codec's); graph against "
                    "eager: active-row logits and pools bit for bit, "
                    "tokens equal")
    detail["compiled_step"] = {"kv_append": app, "times": app_t, **compiled}
    dec = app_t["paged"]
    kernels["kv_append"] = dict(
        route="cuda", source="src/repro_torch/csrc/codec.cu",
        replaces="src/repro/kernels/takum_codec.py:73",
        redesigned="fused K/V append, graph-replayed: one launch writes a "
                   "layer's K and V words to their pages from device "
                   "indices (was two encodes and two index_put)",
        max_abs_err=0.0, shape=dec["shape"], ms=dec["ms"],
        device_ms=dec["device_ms"], plain_ms=dec["plain_ms"],
        bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
        library_ms=None,
        library_call="none: no single PyTorch op rounds to takum or posit "
                     "words",
        two_encodes_ms=dec["two_encodes_ms"],
        launches=kv_append_launches["5"],
        launches_by_phase=kv_append_launches,
        prefill={k: app_t["contiguous"][k] for k in
                 ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                  "bound_by", "two_encodes_ms")})

    # -- 20-22. lockstep, the failure model, telemetry ---------------------
    cfg20 = full_width_cfg("takum8")
    params20, _ = full_width_params(torch, dev, cfg20, "takum8")
    lock = lockstep_phase(torch, dev, params20, cfg20, wrappers,
                          PHASE5_PLENS, 16)
    phase(20, "lockstep phi3-medium-14b full width", **lock, card=card,
          tolerance=f"solo lockstep and the unpadded batch row: tokens "
                    f"equal to the solo scheduler's, or parting at a bf16 "
                    f"tie (best two logits within {TIE_REL:g} of the "
                    f"largest); fresh branch within {FRESH_REL:g} x its "
                    f"largest output of _sdpa; "
                    f"attention at tq = 1 within {ATTN_ATOL} of the plain "
                    "version")
    detail["lockstep"] = lock
    kernels["attention"]["lockstep_tq1"] = lock["attention_tq1"]
    kernels["attention"]["launches_lockstep"] = lock["launches"]["attention"]
    fail_ = failure_phase(torch, dev, params20, cfg20)
    phase(21, "failure model phi3-medium-14b full width", **fail_)
    detail["failure_model"] = fail_
    tel = telemetry_phase(torch, dev, params20, cfg20, PHASE5_PLENS, 16)
    phase(22, "telemetry", **tel, card=card)
    detail["telemetry"] = tel
    del params20
    gc.collect()
    torch.cuda.empty_cache()

    # -- 23-25. training ---------------------------------------------------
    grads, grad_launches = wire_grad_phase(torch, dev, wrappers,
                                           sm_clock_mhz * 1e6)
    phase(23, "wire matmul gradients at full width", **grads, card=card,
          tolerance="x.grad within 2*N*2^-24*(|g|@|decode(w)|^T) "
                    "elementwise of the plain version's autograd gradient "
                    "(phase 3's worst-case f32 bound, over N = 17920), "
                    "TF32 off")
    detail["wire_grads"] = grads
    for k, key in (("takum_codec", "takum_decode"), ("qmatmul", "qmatmul"),
                   ("lns_matmul", "lns_matmul"),
                   ("posit8_lut", "posit8_lut")):
        check(grad_launches[key] > 0, f"the gradient runs launched no {key}")
        kernels[k]["launches_training"] = grad_launches[key]
    kernels["takum_codec"]["launches_training_encode"] = grad_launches[
        "takum_encode"]
    train = full_width_training(torch, dev)
    phase(24, "training phi3-medium-14b full width", **train, card=card)
    detail["training"] = train
    tmp = ROOT / "chiprun_out" / "train_ckpt"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    red_train = reduced_training(torch, dev, tmp)
    shutil.rmtree(tmp)
    phase(25, "reduced training card vs cpu", **red_train,
          tolerance=f"losses {LOSS_REL:g} relative; parameters card vs cpu, "
                    f"microbatch and remat: each leaf within {PARAM_REL_L2:g} "
                    f"relative L2 (elementwise against rtol "
                    f"{REORDER_RTOL:g} atol {REORDER_ATOL:g} reported); "
                    f"resume elementwise rtol {RESUME_RTOL:g} atol "
                    f"{RESUME_ATOL:g}")
    detail["reduced_training"] = red_train

    # -- 26-27. the moe family -------------------------------------------
    for n, (arch, layers) in zip((26, 27), MOE_PHASES):
        res = moe_phase(torch, dev, arch, layers, wrappers)
        launches = res["serving"]["launches"]
        for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
            kernels[k].setdefault("launches_moe", {})[str(n)] = launches[k]
        kernels["fake_quant"].setdefault("launches_moe_setup", {})[str(n)] = \
            res["serving"]["fake_quant_launches_setup"]
        kernels["kv_append"]["launches_by_phase"][str(n)] = \
            launches["kv_append"]
        what = (f"serving {arch} full width" if layers is None else
                f"serving {arch} full width, {layers} of "
                f"{res['serving']['layers_of']} layers")
        phase(n, what, **res, card=card)
        detail[f"moe_{arch}"] = res
        if "hd_kernels" in res:
            hk = res["hd_kernels"]
            for k, key in (("attention", "contiguous"),
                           ("paged_attention", "paged")):
                kernels[k][f"hd{hk['hd']}"] = dict(
                    hk[key], hkv=hk["hkv"], group=hk["group"])
            kernels["kv_append"][f"hd{hk['hd']}"] = hk["kv_append"]

    # -- the kernels line and the last line --------------------------------
    order = ["takum_codec", "kv_append", "qmatmul", "attention",
             "paged_attention", "lns_matmul", "fake_quant", "posit8_lut"]
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
