#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one summary line each; any failure exits non-zero:

1. device and build: the card, its power limit, and the nvcc build of
   every ``src/repro_torch/csrc/*.cu`` for sm_90a (seven libraries, one nvcc
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
    the byte bound (8 bytes an element f32 out, 6 bf16); every float32
    bit pattern through the kernel at n = 8 and 16 (linear takum at
    k = 0 and +-4, LNS, posit; f32 and bf16 out) bit for bit against the
    plain version (LNS: the codec kernels' round trip), and at posit8
    once more through its other decode (``REPRO_LUT_DECODE`` flipped:
    the table or the computed decode of the word path); then
    ``quantize_weights(mode="fake")`` over one full-width
    layer in posit8 (7 launches);
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
    bounds and SDPA's time (the kernels line's ``hd112`` entries);
28. serving nemotron-4-340b at full width (d 18432, 96/8 heads of 192,
    d_ff 73728, relu2, vocab 256000), depth cut to ``NEMOTRON_LAYERS`` of
    96 (each layer made in bf16 and encoded to takum8 wire words; printed
    as ``layers`` and ``layers_of``), a takum8 KV cache: phase 5's
    requests as in phase 26 (TTFT, token gaps, the replayed
    ``decode_ms_per_step``, prefill per chunk, ``peak_gb``, launch
    counts), the replayed step against the eager one bit for bit, the
    wire matmul at the relu2 MLP's shapes (``NEMOTRON_MM``: K up to 73728,
    M 4 and 256) against its plain version under phase 3's limits and
    controls, hd 192 through the append and both attention kernels at the
    served shapes (Hkv 8, G 12) with NaR words, and the reduced config
    card vs CPU;
29. serving recurrentgemma-2b at full width and depth (26 layers of
    (rec, rec, attn), d 2560, MQA 10/1 heads of 256, window 2048, RG-LRU
    width 2560, gelu, tied vocab 256000; takum8 wire attention and MLP,
    the RG-LRU matrices fake-quantised at set-up, a takum8 KV cache):
    ``RG_BATCH`` prompts of ``RG_PLEN`` tokens, ``RG_NEW`` new each,
    through ``ServeEngine.generate``, which routes the family to lockstep
    (prefill seconds, the eager ``decode_ms_per_step``, ``peak_gb``); the
    wire matmul at the prefill's MLP shapes (``RG_MM``, M 9200) as in
    phase 28; hd 256 through the append and both attention kernels under the window
    (phase 4's shapes, NaR words), the contiguous kernel at the served
    shapes (tq 2300 from pos 0 and tq 1, Hkv 1, G 10, window 2048)
    against its plain version with its bound and SDPA's time (the kernels
    line's ``hd192``/``hd256`` entries); and the reduced
    recurrentgemma-2b, minitron-4b and starcoder2-15b served on the card
    and on the CPU (tokens equal, logits 1e-4).

33. the codec at every width: the decode and encode kernels of every
    width 6..32 for linear takum, LNS takum and posit against the plain
    codec on the card (every word for n <= 16, 2^24 seeded words at n =
    17, 20, 24, 28, 29, 32; 2^24 seeded floats with zeros, +-inf, NaN,
    subnormals and rounding ties): linear and posit bit for bit, LNS
    decodes within 2 ulp and encoded words within those of a log 2 ulp
    either side; the fused fake-quant at n = 8, 12, 16, 24, 32, f32 and
    bf16 out (every ``SWEEP_STRIDE``-th float32 pattern at 12, 24 and 32;
    counts 1-33 at offsets 0 and 1, the scalar loop); the plain
    hardware-faithful path (section V) on CUDA tensors word for word
    against the decode and encode kernels at n = 12, 16, 24, 32; decode
    and encode times at n = 8, 12, 16, 24, 32 beside the byte bound
    (and the plain version's at 12, 24, 32, ``torch.index_select`` on the
    2^n decoded values up to 16 bits); contiguous attention with
    left-padded starts at hd 128 and 256, every row (those before
    ``start`` the uniform average of V over the whole cache) against its
    plain version, timed with and without starts; the path (every
    width's decode, encode and fake-quant through ``ops``) with the
    launch counters zeroed before it and read after.
34. the codec at 33-64 bits and the float64 decode: the decode (to
    float32 and float64), encode and fake-quant (float32, bfloat16 and
    float64 out) kernels at n = 33, 40, 48, 57, 58, 61 and 64, each kind,
    over 2^24 seeded words (top bit set and clear) and floats (with the
    ties of every float exponent's cut), against the plain codec on the
    card (the counts of differing outputs, all 0: linear and posit bit
    for bit, LNS decodes within 2 ulp, LNS words in the window of a logf
    2 ulp either side, LNS fake-quant the codec kernels' round trip);
    the float64 decode and fake-quant from 8-, 16- and 32-bit words (n =
    8, 16, 24, 32); every ``SWEEP_STRIDE``-th float32 pattern through the
    encode at n = 64, linear and posit; times at [5120, 17920] (n = 40 and
    64; the float64 decode from uint32 words at 32) beside their byte
    bounds, PyTorch's cast over the same bytes and, at 64 bits, the plain
    version's; the path (each width's decode, encode and fake-quant
    through ``ops``) with the launch counters zeroed before it and read
    after. ``widths`` of the kernels line's ``takum_codec`` and
    ``fake_quant`` gain these rows.
38. tensor-parallel serving (``ServeEngine(shard=ShardPlan(...))``,
    ``repro_torch.serve.shard``) with ranks as processes on the one card,
    their rings over gloo (CUDA payloads staged through host memory;
    several ranks of one card cannot share an NCCL communicator): the
    ring hop's encode and decode kernels against the plain codec at a
    rank's columns (``HOP_SHAPES``: [4 | 256, 2560 | 8960]), [4, 23040]
    and [256, 5120] for takum8, takum16, lns-takum8 and posit8 (words and
    wire values bit for bit, LNS by phase 7's rule); the wire matmul at a
    rank's column slices (``SHARD_MM``: K 5120, N 2560, 640, 8960, M 4
    and 256) and both attention kernels and the append at a rank's heads
    (Hkv 5, G 4, hd 128), each against its plain version at its
    tolerance; the compressed ``ring_all_reduce`` at 4 and 2 ranks on the
    card against the same ring on the CPU, bit for bit; the reduced cases of
    ``shard_selftest`` (tp 2 and 4, dp 2 x tp 2, psum, lns-takum8 wire
    weights) against one rank on the card, whose tokens equal the CPU's;
    phi3-medium-14b at full width (40 layers, takum8 wire weights and KV,
    page 256, decode batch 4) at tp 2, gather mode, each rank building
    every seeded layer whole and keeping its slice: phase 5's prompts
    with 32 new tokens, eagerly, tokens and every step's two best logits
    bit for bit those of one card running the same column slices
    (``SplitCols``: the wire matmul's K split depends on N), and against
    one card's whole matrices equal or parting at a tie (phase 20's
    ``TIE_REL``; one card's column slices are held to the same rule);
    then with takum16 collectives (they hold this run's bf16 activations
    exactly: tokens and top-2 logits bit for bit the uncompressed run's)
    and takum8 collectives (lossy: residual norms finite and not all 0,
    the two ranks' tokens equal, those against the uncompressed run and
    one card reported); compressed, one encode and two decodes a seam
    and the bytes a decode step equal to ``step_interconnect_bytes``;
    per rank ``peak_gb``, ``weights_s``, TTFT, the eager step and the
    ring hops' host share of it. The kernels line's codec,
    append, wire matmul and both attention entries gain
    ``launches_phase38``.
39. manual data-parallel training (``trainer.make_train_step_manual``,
    ZeRO-1) with ranks as processes on the one card, their rings over
    gloo: the compressed hop's encode and decode kernels
    (``collectives.encode_hop`` / ``decode_hop``, takum16 and takum8 as
    the step's ``QuantSpec``s) on a gradient chunk of the full-width
    run's size (G/2 = 854,602,240 elements, one launch each) against the
    plain codec a block at a time, words and values bit for bit, with
    their times beside the byte bound; phi3-medium-14b at full width,
    ``TRAIN_LAYERS`` of 40 layers (G = 1,709,204,480 f32 parameters), on
    two ranks of 1 x ``TRAIN_T`` tokens each, ``DP_STEPS`` AdamW steps
    on phase 24's repeated batch: uncompressed (``data2``) against one
    card's ``make_train_step`` on the same 2 x ``TRAIN_T`` batch with
    microbatch 2 (the ranks' arithmetic: the first update's leaves
    within ``PARAM_REL_L2`` relative L2 and the losses before and after
    it within ``LOSS_REL``; the later steps, where bf16 roundings of
    parameters a bit apart part the runs, and the whole batch in one
    backward, reported), and with takum16 on the data ring
    (``data2_takum16``, its losses beside the uncompressed run's); every
    step the ranks' parameter fingerprints equal, the bytes a rank sends
    equal to ``trainer.step_interconnect_bytes``, the codec's launches
    0 uncompressed and one encode and one decode a step compressed; per
    rank the step's host time, the ring hops' share of it and
    ``peak_gb`` beside phase 24's one-device figure. The pod mesh with
    error feedback (pod 2 x data 1) holds P, m, v and its residual whole
    on each rank, more than two ranks of one card can hold at any
    full-width depth: it runs reduced, as ``dp_selftest``'s
    ``pod2_data2_takum16``, ``data2`` and ``pod2_takum16`` on four ranks,
    card against CPU (losses within ``LOSS_REL``, every leaf within
    ``PARAM_REL_L2``). The kernels line's codec entry gains
    ``launches_phase39`` and ``grad_chunk``.
40. the launch-plan autotuner and the dry run against the card: (a) a
    forced sweep (``REPRO_AUTOTUNE=force``, a temporary local cache, never
    the repo's tables) of the takum8 wire matmul at 4x5120x17920 and
    256x5120x17920 and the lns-takum8 matmul at 256x5120x17920
    (``SWEEPS``), each candidate plan timed by CUDA-graph replays and
    printed beside the card's name and power limit; then in lookup mode
    ``resolved_plan`` finds each winner again (one ``autotune.hit``) and
    the kernel called without a plan is held against its plain version
    at phases 3 and 8's tolerances; (b) ``dryrun.run_cell`` for
    phi3-medium-14b on a one-rank mesh at full width (``DRY_OVERRIDES``:
    ``DRY_LAYERS`` of 40 layers, a decode step of batch 4 over a
    2048-token takum8 cache, takum8 wire weights) traced on fake CUDA
    tensors with no launch, then the same step built from real tensors
    on the card: argument bytes equal exactly, output shapes and dtypes
    equal, each kernel's launches equal to the trace's calls, the
    traced temporary peak beside ``max_memory_allocated`` (within
    ``DRY_PEAK_ABS`` + ``DRY_PEAK_REL`` of the card's). The kernels
    line's wire and LNS matmul entries gain ``autotune_phase40``; the
    append, the wire matmul and contiguous attention
    ``launches_phase40``.

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
matmul and both attention kernels ``launches_moe`` (phases 26 and 27)
and ``launches_new_families`` (phases 28 and 29), fake-quant
``launches_moe_setup`` and ``launches_recurrentgemma_setup``. Details go to
``chiprun_out/chip_smoke.json``.
"""

import contextlib
import dataclasses
import gc
import io
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
# rwkv6's WKV takes its decay from the difference of two cumulative sums of
# log w, |cl| up to 286 in a 64-token chunk of the reduced config (f32 ulp
# 2^-15 there), so the time mix's outputs of two sum orders part by more:
# the inputs of the LNS encodes after it differ by up to 1.7e-4 card
# against CPU (phase 37, and 5.7e-5 between the port and the reference on
# the CPU, tests/test_torch_family_formats_rwkv6.py)
RWKV6_ENCODE_INPUT_ATOL = 1e-3
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
    """|a - b| in units in the last place of their float32 or float64 type
    (+0 and -0 are one value, and a sign change counts the steps through
    zero). Float64 distances are taken in int64 and exact for two values
    of one sign; across zero each side is counted in float64, exact below
    2^53 steps and above that far beyond any tolerance."""
    if a.element_size() == 8:
        def ordered(t):
            i = t.contiguous().view(torch.int64)
            return torch.where(i < 0, -(i & ((1 << 63) - 1)), i)
        oa, ob = ordered(a), ordered(b)
        same = (oa >= 0) == (ob >= 0)
        return torch.where(same, (oa - ob).abs().double(),
                           oa.abs().double() + ob.abs().double())

    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def decode_rows(torch, w, spec):
    """The plain decode of ``w`` [K, N] to f32, a block of rows at a time:
    its integer temporaries are several times the words, so a 1.36 G-word
    leaf decoded whole would not fit the card."""
    from repro_torch.kernels import ref
    step = max(1, (1 << 27) // w.shape[1])
    out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    for i in range(0, w.shape[0], step):
        out[i:i + step] = ref.decode_ref(w[i:i + step], spec)
    return out


def plain_qmatmul(torch, x, w, spec):
    """``ref.qmatmul_ref`` with its decode a block of rows at a time
    (:func:`decode_rows`): the same f32 x f32 product with an f32 sum."""
    return x.to(torch.float32) @ decode_rows(torch, w, spec)


def wire_matmul_check(torch, dev, spec, m, k, n, timed=False):
    """The wire matmul kernel at [m, k] x [k, n] against its plain version
    on seeded operands (``spec`` words of N(0, 1/k) weights): within the
    worst-case f32 bound and the statistical limit, with controls (x
    rounded to TF32 and bf16) that must break the latter. ``timed`` adds
    the kernel's time beside its bound, the plain version's and
    torch.matmul's on the weights decoded beforehand (TF32 off)."""
    from repro_torch.kernels import takum_codec, takum_matmul
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=dev)
    w = takum_codec.encode(torch.randn((k, n), generator=g,
                                       device=dev) / k ** 0.5, spec)
    wf = decode_rows(torch, w, spec)
    got = takum_matmul.qmatmul(x, w, spec)
    again = takum_matmul.qmatmul(x, w, spec)
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"qmatmul {spec.name} {m}x{k}x{n}: two calls differ")
    want = x @ wf                       # ref.qmatmul_ref's product
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
        e = (xe @ wf - want).abs()
        ctrl[key] = float((e / stat).max())
        check(ctrl[key] > 1.0, f"qmatmul {spec.name} {m}x{k}x{n}: a "
              f"{key} product passes the statistical limit")
    row = {"fmt": spec.name, "m": m, "k": k, "n": n,
           "variant": takum_matmul.launch_plan(m, k, n, spec.n)[0],
           "repeatable": True, "max_abs_err": float(err.max()),
           "max_err_over_bound": float((err / tol).max()),
           "max_err_over_stat_limit": r_kernel,
           "control_max_err_over_stat_limit": ctrl}
    if timed:
        del tol, stat, err, got, again, want
        b_ms, b_by = mm_bound(spec, m, k, n)
        row.update(
            ms=cuda_ms(torch, lambda: takum_matmul.qmatmul(x, w, spec)),
            plain_ms=cuda_ms(torch, lambda: plain_qmatmul(torch, x, w, spec),
                             iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(torch, lambda: torch.matmul(x, wf)))
    return row


def full_width_params(torch, dev, cfg, wfmt, dtype=None, place=None):
    """phi3-medium-14b's weights at full width (all layers; ``cfg``
    another dense config), random from a seeded generator on the card,
    every projection ``wfmt`` wire words, embeddings bf16; each layer made
    in ``dtype`` (None: the config's ``param_dtype``) before its encode,
    and passed through ``place`` (a shard plan's slice, phase 38) after
    it: (params, seconds)."""
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
        layer = transformer.init_layer(gen, cfg, device=dev, dtype=dtype)
        wired = quantize_weights(layer, wfmt, mode="wire", verbose=False)
        params["layers"].append(wired if place is None else place(wired))
        del layer, wired
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


def kernel_wrappers():
    """Every kernel wrapper whose launch counter a serving run reads."""
    from repro_torch.kernels import build
    from repro_torch.kernels import lns_matmul as klns
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import takum_attention as kattn
    from repro_torch.kernels import takum_codec, takum_matmul
    return {"takum_decode": takum_codec.decode,
            "takum_encode": takum_codec.encode,
            "kv_append": takum_codec.kv_append,
            "qmatmul": takum_matmul.qmatmul,
            "lns_matmul": klns.lns_matmul,
            "attention": kattn.attention,
            "paged_attention": kattn.paged_attention,
            "fake_quant": kquant.fake_quant,
            "posit8_lut": build.posit8_lut}


def ring_hops(since=None):
    """The ring collectives' hop counters of this process (hops, bytes
    sent, hops staged through host memory, host seconds in them), less
    ``since``'s."""
    from repro_torch.dist.collectives import transport
    now = (transport.hops, transport.bytes_sent, transport.staged,
           transport.seconds)
    return now if since is None else tuple(a - b for a, b in zip(now, since))


def serve_full_width(torch, dev, *, wfmt, kv, plens, max_new, max_len,
                     wrappers, seed=5, eager=False, params=None, cfg=None,
                     shard=None, prepare=None, inspect=None):
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
    with the ``params`` given. ``shard`` (a ``ShardPlan``) serves this
    rank's share of a sharded model (phase 38), with the host time and
    bytes of the rings' hops beside each phase's; ``prepare(eng, sched,
    prompts)`` runs before the requests are submitted and ``inspect(eng,
    sched, outputs)`` after they are served, its dict joining the
    result."""
    from repro_torch.kernels import takum_codec
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine
    ps = 256
    cfg = full_width_cfg(kv) if cfg is None else cfg
    torch.cuda.reset_peak_memory_stats()
    weights_s, setup_encodes = 0.0, None
    if params is None:
        # the standalone encodes of the wired weights (set-up, not serving)
        before = takum_codec.encode.launches
        params, weights_s = full_width_params(torch, dev, cfg, wfmt)
        setup_encodes = takum_codec.encode.launches - before
    kw = {} if shard is None else {"shard": shard}
    eng = ServeEngine(params, cfg, max_len=max_len, page_size=ps,
                      decode_batch=4, device=dev, **kw)
    sched = eng.scheduler()
    runner = getattr(sched, "step", None)      # None: a tree without graphs
    walls = {"prefill": 0.0, "decode": 0.0, "capture": 0.0}
    steps = {"prefill": 0, "decode": 0, "capture": 0}
    hops = None if shard is None else {
        k: {"hops": 0, "bytes_sent": 0, "staged": 0, "seconds": 0.0}
        for k in walls}

    def timed(fn, key, state):
        def wrapped():
            busy = sum(1 for s in sched._slots
                       if s is not None and s.state == state)
            if key == "decode":
                busy = min(busy, 1)     # one packed step for all slots
            caps = getattr(runner, "captures", 0)
            before = None if hops is None else ring_hops()
            torch.cuda.synchronize()
            t = time.perf_counter()
            events = list(fn())
            torch.cuda.synchronize()
            k = key if getattr(runner, "captures", 0) == caps else "capture"
            walls[k] += time.perf_counter() - t
            steps[k] += busy
            if hops is not None:
                for f, v in zip(hops[k], ring_hops(before)):
                    hops[k][f] += v
            yield from events
        return wrapped

    # host clock around each scheduler phase, synchronised on both sides
    sched._prefill_tick = timed(sched._prefill_tick, "prefill", "prefilling")
    sched._decode_step = timed(sched._decode_step, "decode", "active")
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in plens]
    if prepare is not None:
        prepare(eng, sched, prompts)
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
    # fresh single-request prefill (serving is batch-invariant), through
    # the engine's own step where it has one (a rank's, under a plan)
    cache = model.init_cache(getattr(eng, "run_cfg", cfg), 1, 2 * ps,
                             device=dev)
    toks = torch.zeros((1, ps), dtype=torch.long)
    toks[0, :plens[0]] = torch.as_tensor(prompts[0])
    if hasattr(eng, "prefill_chunk"):
        row, _ = eng.prefill_chunk(toks.to(dev), cache, pos=0,
                                   last_idx=plens[0] - 1)
    else:
        row, _ = model.prefill_chunk(eng.params, toks.to(dev), cfg, cache,
                                     pos=0, last_idx=plens[0] - 1)
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
             "setup_encode_launches": setup_encodes,
             "lns_matmul_split_sum_launches": split_sums}
    if hops is not None:
        serve["ring_hops"] = hops
    if inspect is not None:
        serve.update(inspect(eng, sched, outs))
    # the timing wrappers and the scheduler reference each other: collect
    # the cycle so the model's memory is free before the next phase
    del eng, sched, runner, params, cache, row
    gc.collect()
    torch.cuda.empty_cache()
    return serve


@contextlib.contextmanager
def encode_tap(torch, replay=None, atol=ENCODE_INPUT_ATOL):
    """Every ``takum_codec.encode`` call of the port (the activations
    entering each LNS matmul) and every K/V encode of
    ``takum_codec.kv_append`` (K, then V, through the plain append with
    the tapped encode: on the card the fused kernel would write its own
    words), in call order.

    Without ``replay``: yields the list of ``(format, input, words)`` on
    the CPU. With ``replay`` (such a list from another run): each call
    must match the recorded call's format and shape and its input must
    lie within ``atol`` of the recorded one; it returns the
    recorded words. Yields a dict with the words encoded, the number that
    differed from the recorded ones, the first that did, and each call's
    differing (own, recorded, spec) words (``pairs``)."""
    from repro_torch.core.bitops import carrier, to_words
    from repro_torch.core.takum import frac_width
    from repro_torch.kernels import ref, takum_codec
    orig, orig_kv = takum_codec.encode, takum_codec.kv_append
    calls = []
    seen = {"words": 0, "differ": 0, "max_input_diff": 0.0, "first": None,
            "pairs": []}
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
        check(dx <= atol, f"forced run: encode call {i} "
              f"({spec.name}) input differs by {dx}")
        differ = carrier(own.cpu()) != carrier(rwords)
        nd = int(differ.sum())
        if nd:
            seen["pairs"].append((own.cpu()[differ], rwords[differ], spec))
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
                               mode="wire", cfg=rcfg, verbose=False)
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


def contiguous_nar_check(torch, q, kc, vc, spec, pos0, start0, window=0):
    """The contiguous kernel at phase 4's chunk shape with a NaR word (NaN
    for a float cache) in K at position 100 of KV head 3, valid for every
    row, and in V at position 1000 of KV head 6, a visited tile's key that
    most rows mask (p = 0): NaN in the plain version's places (every row
    of head 3, column 2 of every row of head 6), the rest within
    ATTN_ATOL. With fewer KV heads the words go to the last head (one KV
    head: both in head 0, every row NaN). Returns (NaN count, largest
    error on the finite rest)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import takum_attention as kattn
    hkv, tq = kc.shape[2], q.shape[1]
    kh, vh = min(3, hkv - 1), min(6, hkv - 1)
    nar = float("nan") if spec.is_identity else spec.nar_word
    kc, vc = kc.clone(), vc.clone()
    kc[0, 100, kh, 7] = nar
    vc[0, 1000, vh, 2] = nar
    q4 = kattn.to_rows(q, hkv).contiguous()
    got = kattn.attention(q4, kc, vc, pos0, start0, spec=spec, bk=256, tq=tq,
                          window=window)
    if spec.is_identity:       # the kernels' semantics: f32 values, f32 dots
        q, kc, vc = q.float(), kc.float(), vc.float()
    want = kattn.to_rows(ref.attention_ref(q, kc, vc, spec.n, spec, pos=pos0,
                                           start=start0, window=window), hkv)
    nan = torch.isnan(got)
    rows, hd = got.shape[2], got.shape[3]
    check(torch.equal(nan, torch.isnan(want)) and bool(nan[0, kh].all())
          and bool(nan[0, vh, :, 2].all())
          and int(nan.sum()) == rows * hd + (rows if vh != kh else 0),
          f"contiguous attention over {spec.name} KV: NaR words poison "
          "other rows than the plain version's")
    fin = ~nan
    # (one KV head: every row is NaN, nothing finite to hold)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
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
    it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
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


FQ_SWEEP_WIDTHS = (8, 16)           # every float32 pattern (phase 17)
FQ_STRIDED_WIDTHS = (12, 24, 32)    # every SWEEP_STRIDE-th one (phase 33)
FQ_SCALES = (0, 4, -4)              # linear takum's k in the sweeps


def fake_quant_sweep(torch, dev, n, kind, k=0, stride=1):
    """Every ``stride``-th float32 bit pattern (all 2^32 at stride 1:
    every exponent and sign, subnormals, infinities and NaNs) through the
    fake-quant kernel at width n, f32 and bf16 out (linear takum scaled
    by 2^k), in chunks of 2^24 (``encode_sweep``'s form), bit for bit
    (NaN by place) against the plain version on the card (its bf16
    output is its f32 output rounded to nearest even) or, for LNS, the
    codec kernels' round trip."""
    from repro_torch import formats
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import ref, takum_codec
    spec = formats.resolve(kind, n)
    total, chunk = -(-(1 << 32) // stride), 1 << 24
    bad = {"float32": 0, "bfloat16": 0}

    def differ(got, want):
        ng, nw = torch.isnan(got), torch.isnan(want)
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        return int(((ng != nw) | (~ng & (got.view(bits) != want.view(bits)))
                    ).sum())

    for i0 in range(0, total, chunk):
        b = torch.arange(i0, min(i0 + chunk, total), device=dev,
                         dtype=torch.int64) * stride
        x = torch.where(b >= 1 << 31, b - (1 << 32), b).to(
            torch.int32).view(torch.float32)
        want = (takum_codec.decode(takum_codec.encode(x, spec), spec)
                if kind == "lns" else
                ref.fake_quant_ref(x, spec, scale_exp=k))
        for dtype in (torch.float32, torch.bfloat16):
            got = kquant.fake_quant(x, spec, dtype=dtype, scale_exp=k)
            bad[str(dtype)[6:]] += differ(got, want.to(dtype))
        del x, want, got
    check(not any(bad.values()), f"fake-quant {spec.name} k {k}: {bad} of "
          f"{total} swept patterns differ from the plain version")
    return {"patterns": total, "stride": stride, "scale_exp": k,
            "differ": bad}


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


def lockstep_traced(torch, eng, prompts, max_new, call=None):
    """``eng.generate_lockstep`` (or ``call``, such as ``eng.generate``)
    with each forward timed (synchronised on both sides) and its logits'
    two best values and tokens kept: (tokens, [(top2 values [B, 2], top2
    ids [B, 2]) per forward], prefill s, decode ms per step)."""
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
        toks = (call or eng.generate_lockstep)(prompts, max_new)
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


def tq1_attention_served(torch, dev, spec, dtype, *, b, hkv, grp, hd, tmax,
                         pos, start=None, seed=30):
    """Contiguous attention at a lockstep decode step's shape (tq 1, B
    ``b``, ``grp`` query rows per KV head, a cache of ``tmax`` positions
    of ``spec`` words, or ``dtype`` floats for the identity codec, at
    ``pos``, keys before ``start`` masked) against its plain version:
    ATTN_ATOL on the kernels' f32 semantics, and for a bf16 cache
    BF16_ATTN_ATOL against the identity branch as it is; timed beside its
    byte bound and SDPA on K/V decoded beforehand."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import takum_attention as kattn
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, hkv * grp, hd), generator=g, device=dev)
    kf, vf = (torch.randn((b, tmax, hkv, hd), generator=g, device=dev)
              for _ in range(2))
    if spec.is_identity:
        q, kc, vc = q.to(dtype), kf.to(dtype), vf.to(dtype)
    else:
        kc, vc = ref.encode_ref(kf, spec), ref.encode_ref(vf, spec)
    del kf, vf
    st = (torch.zeros(b, dtype=torch.int32, device=dev) if start is None
          else torch.tensor(start, dtype=torch.int32, device=dev))
    q4 = kattn.to_rows(q, hkv).contiguous()

    def kernel():
        return kattn.attention(q4, kc, vc, pos, None if start is None
                               else st, spec=spec, tq=1)

    got = kattn.from_rows(kernel(), 1)
    f32 = (q.float(), kc.float(), vc.float()) if spec.is_identity \
        else (q, kc, vc)
    nbits = 0 if spec.is_identity else spec.n
    want = ref.attention_ref(*f32, nbits, spec, pos=pos, start=st)
    err = float((got - want).abs().max())
    what = (f"contiguous attention at tq 1 (hd {hd}, Hkv {hkv}, G {grp}, "
            f"{spec.name if dtype is None else str(dtype)[6:]})")
    check(bool(torch.isfinite(got).all()) and err <= ATTN_ATOL,
          f"{what}: off by {err}")
    out = {"shape": list(q4.shape), "cache": [b, tmax, hkv, hd],
           "hkv": hkv, "group": grp,
           "kv": spec.name if dtype is None else str(dtype)[6:],
           "pos": pos, "start": start, "max_abs_err": err,
           "tolerance": ATTN_ATOL}
    if dtype == torch.bfloat16:
        plain = ref.attention_ref(q, kc, vc, 0, spec, pos=pos, start=st)
        out["plain_branch_max_abs_err"] = float(
            (got - plain.float()).abs().max())
        out["plain_branch_tolerance"] = BF16_ATTN_ATOL
        check(out["plain_branch_max_abs_err"] <= BF16_ATTN_ATOL,
              f"{what}: off the plain identity branch by "
              f"{out['plain_branch_max_abs_err']}")
    keys = [pos - int(s) + 1 for s in st.tolist()]
    word_bytes = kc.element_size()
    b_ms, b_by = bound(q4.numel() * 4 * 2
                       + sum(keys) * hkv * hd * 2 * word_bytes,
                       4 * hd * grp * hkv * sum(keys)
                       * tf32_products(spec, dtype), TF32_FLOPS)
    kd = ref.decode_ref(kc, spec) if not spec.is_identity else kc.float()
    vd = ref.decode_ref(vc, spec) if not spec.is_identity else vc.float()
    kd, vd = (x[:, :pos + 1].transpose(1, 2) for x in (kd, vd))
    j = torch.arange(pos + 1, device=dev)
    keep = (j[None, :] >= st[:, None])[:, None, None, :]
    qf = q.float().transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qf, kd, vd, attn_mask=keep, enable_gqa=True)

    out.update(
        ms=cuda_ms(torch, kernel, iters=100),
        device_ms=graph_ms(torch, kernel, iters=100),
        plain_ms=cuda_ms(torch, lambda: ref.attention_ref(
            *f32, nbits, spec, pos=pos, start=st), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, library, iters=100),
        library_device_ms=graph_ms(torch, library, iters=100),
        library_max_abs_err=float((library().transpose(1, 2) - got)
                                  .abs().max()),
        library_call="scaled_dot_product_attention(enable_gqa=True) on K/V "
                     "decoded to f32 beforehand (not timed), boolean start "
                     "mask")
    del q, kc, vc, kd, vd, qf, q4, got, want
    torch.cuda.empty_cache()
    return out


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
        q, k, _ = L._proj_qkv(p0["attn"], xn, None, cfg.n_heads,
                              cfg.n_kv_heads, cfg.hd, cfg.rope_base,
                              positions)
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
    q, k, v = L._proj_qkv(p0["attn"], L.rmsnorm(p0["ln1"], x), None,
                          cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.rope_base,
                          positions)
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
    plen = max(plens)
    tq1 = tq1_attention_served(
        torch, dev, eng.params["layers"][0]["attn"]["wq"].spec, None, b=4,
        hkv=cfg.n_kv_heads, grp=cfg.n_heads // cfg.n_kv_heads, hd=cfg.hd,
        tmax=-(-(plen + max_new + CACHE_SLACK) // 256) * 256,
        pos=plen + max_new - 1, start=[plen - n for n in plens], seed=20)
    tq1["launches_lockstep"] = launches["attention"]
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


def train_cfg(layers, arch="phi3-medium-14b"):
    """``arch``'s registered config, its depth cut to ``layers`` (None:
    as registered)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).config
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def train_media(torch, dev, cfg, batch):
    """Seeded media for one training batch of ``batch`` rows: seamless's
    ``SEAMLESS_FRAMES`` audio frames (phase 31's), vlm's patch embeddings
    [n_media_tokens, d_media] (phase 32's); None for a text-only config."""
    g = torch.Generator(device=dev).manual_seed(35)
    if cfg.frontend == "audio":
        return torch.randn((batch, SEAMLESS_FRAMES, cfg.d_model),
                           generator=g, device=dev)
    if cfg.frontend == "vision":
        return torch.randn((batch, cfg.n_media_tokens,
                            cfg.d_media or cfg.d_model), generator=g,
                           device=dev)
    return None


def full_width_training(torch, dev, arch="phi3-medium-14b",
                        layers=TRAIN_LAYERS, steps=TRAIN_STEPS, lr=TRAIN_LR,
                        falls=True):
    """Phases 24 and 35: ``arch`` at full width, depth cut to ``layers``
    (None: all), ``steps`` steps on one repeated ``SyntheticLM(seed=0)``
    batch of 1 x ``TRAIN_T`` tokens (with the family's seeded media,
    :func:`train_media`), remat per block, each step
    ``trainer.make_train_step``'s three calls (``_grads_fn``,
    ``clip_by_global_norm``, ``apply_update``) timed one by one (phase 25
    drives ``make_train_step`` itself); per step the loss, the grad norm,
    the step's host time (synchronised) and its split into the
    forward+backward and the optimizer (clip + AdamW at the constant rate
    ``lr``). The losses must fall unless ``falls`` is False (a probe of
    another rate, reported only)."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.models import model
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves
    cfg = train_cfg(layers, arch)
    full = train_cfg(None, arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    state = opt.init_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ocfg = opt.AdamWConfig(lr=lr, warmup_steps=0, schedule="const")
    grads_of = trainer._grads_fn(cfg, RuntimeConfig(remat="block"))
    batch = dp.SyntheticLM(cfg.vocab, TRAIN_T, 1, seed=0).batch_at(0)
    batch = trainer._device_batch(batch, dev)
    media = train_media(torch, dev, cfg, 1)
    if media is not None:
        batch["media"] = media
    rows = []
    for i in range(steps):
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
              f"{arch} training step {r['step']}: loss or grad norm not "
              "finite")
    check(not falls or rows[-1]["loss"] < rows[0]["loss"],
          f"{arch} training loss did not fall: {rows[0]['loss']} -> "
          f"{rows[-1]['loss']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = rows[1:]
    reduced = {}
    if cfg.n_layers != full.n_layers:
        reduced["n_layers"] = f"{full.n_layers} -> {cfg.n_layers}"
    res = {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "reduced": reduced,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "params": n_params, "batch": [1, TRAIN_T], "remat": "block",
           "media": None if media is None else list(media.shape),
           "optimizer": f"AdamW lr {lr:g} const, clip 1.0",
           "init_s": init_s, "steps": rows,
           "loss_first_last": [rows[0]["loss"], rows[-1]["loss"]],
           "step_ms_steady_mean": sum(r["step_ms"] for r in steady)
           / len(steady),
           "fwd_bwd_ms_steady_mean": sum(r["fwd_bwd_ms"] for r in steady)
           / len(steady),
           "optimizer_ms_steady_mean": sum(r["optimizer_ms"] for r in steady)
           / len(steady),
           "tokens_per_s_steady_mean": sum(r["tokens_per_s"] for r in steady)
           / len(steady),
           "peak_gb": peak_gb, "bytes_per_param": peak_gb * 1e9 / n_params}
    if cfg.n_enc_layers:
        res["enc_layers"] = cfg.n_enc_layers
    del params, state, batch, media
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


def served_cfg(arch, layers=None):
    """``arch``'s full config with a takum8 KV cache, ``layers`` of its
    layers (None: all)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).config
    return dataclasses.replace(cfg, kv_quant="takum8",
                               n_layers=layers or cfg.n_layers)


def served_params(torch, dev, cfg, dtype):
    """A model's weights at full width, random from a seeded generator on
    the card (embeddings bf16, tied where the config ties them; the
    layers in ``dtype``: None = the config's ``param_dtype``, each of its
    block kind), through ``quantize_weights(params, "takum8",
    mode="wire", in_place=True)``: the attention and MLP projections
    wired; a moe layer's router and expert stacks and an RG-LRU's
    matrices, ``conv`` and ``lam`` fake-quantised in place (one exponent
    a stacked leaf of the reference: a scan group's block over its
    repeats; an expert stack a slice of its expert axis at a time).
    An encdec model gets its ``enc`` and ``dec`` stacks instead of
    ``layers``. Returns (params, seconds, fake-quant launches, the audit
    line)."""
    from repro_torch.kernels import quantize as kquant
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.serve.engine import quantize_weights
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = L.embed_init(gen, cfg.vocab, cfg.d_model, cfg.tie_embeddings,
                          dtype=torch.bfloat16, device=dev)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dev)
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        dt = L.DTYPES[cfg.param_dtype] if dtype is None else dtype
        params["enc_norm"] = L.rmsnorm_init(cfg.d_model, dev)
        params["enc"] = [encdec._enc_block_init(gen, cfg, dt, dev)
                         for _ in range(cfg.n_enc_layers)]
        params["dec"] = [encdec._dec_block_init(gen, cfg, dt, dev)
                         for _ in range(cfg.n_layers)]
    else:
        params["layers"] = [transformer.init_layer(gen, cfg, kind=kind,
                                                   device=dev, dtype=dtype)
                            for kind in transformer.layer_kinds(cfg)]
    kquant.fake_quant.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params = quantize_weights(params, "takum8", mode="wire", cfg=cfg,
                                  in_place=True)
    torch.cuda.synchronize()
    return (params, time.perf_counter() - t0, kquant.fake_quant.launches,
            buf.getvalue().strip())


def attention_check(torch, dev, hkv, grp, hd, seed, window=0):
    """Both attention kernels at Hkv ``hkv``, G ``grp``, head dim ``hd``
    over takum8 words, at the shapes a serving run gives them: the last
    256-token chunk of a 1024-token prompt (pos 768 of a 1280-position
    cache), and a decode step of 4 sequences (pos 76, 520, 1023 and an
    idle slot at a stale 4000) over 256-position pages, under a sliding
    ``window`` (0: none). Each is held to its plain version on the same
    inputs (ATTN_ATOL), with NaR words: a K word of the paged pool (seq
    1, position 266, head 3, or the last head below 4: that row NaN,
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
                               tq=tq, window=window)

    got = contiguous()
    want = kattn.to_rows(ref.attention_ref(q, kc, vc, 8, t8, pos=pos0,
                                           start=start0, window=window), hkv)
    c_err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and c_err <= ATTN_ATOL,
          f"hd {hd} contiguous attention off by {c_err}")
    nar_nans, nar_err = contiguous_nar_check(torch, q, kc, vc, t8, pos0,
                                             start0, window)
    keys_needed = sum(min(pos0 + r + 1, window or pos0 + r + 1)
                      for r in range(tq)) * grp * hkv
    b_ms, b_by = bound(q4.numel() * 4 * 2 + 2 * (pos0 + tq) * hkv * hd,
                       4 * hd * keys_needed * tf32_products(t8), TF32_FLOPS)
    kf = ref.decode_ref(kc, t8)[:, :pos0 + tq].transpose(1, 2)
    vf = ref.decode_ref(vc, t8)[:, :pos0 + tq].transpose(1, 2)
    qf = q.transpose(1, 2)
    causal = band_mask(torch, dev, pos0, tq, pos0 + tq, window)
    cont = {"shape": list(q4.shape), "window": window, "max_abs_err": c_err,
            "ms": cuda_ms(torch, contiguous),
            "plain_ms": cuda_ms(torch, lambda: ref.attention_ref(
                q, kc, vc, 8, t8, pos=pos0, start=start0, window=window),
                iters=5),
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
    nh = min(3, hkv - 1)
    kp[4, 10, nh, 7] = takum.nar_word(8)      # seq 1, position 266, head 3
    qd = torch.randn((4, 1, hkv * grp, hd), generator=g, device=dev)
    qd4 = kattn.to_rows(qd, hkv).contiguous()

    def paged():
        return kattn.paged_attention(qd4, kp, vp, pos, startp, table, spec=t8,
                                     window=window)

    gotp = paged()
    wantp = kattn.to_rows(ref.paged_attention_ref(
        qd, kp, vp, table, t8, pos=pos, start=startp, window=window), hkv)
    nan_ok = torch.equal(torch.isnan(gotp), torch.isnan(wantp))
    poisoned = bool(torch.isnan(gotp[1, nh]).all())
    clean = int(torch.isnan(gotp).sum()) == grp * hd
    fin = torch.isfinite(wantp)
    p_err = float((gotp[fin] - wantp[fin]).abs().max())
    check(nan_ok and poisoned and clean and p_err <= ATTN_ATOL,
          f"hd {hd} paged attention: nan_ok={nan_ok} poisoned={poisoned} "
          f"clean={clean} err={p_err}")
    def keys_in(p):       # the valid keys of a sequence at pos p
        hi = min(p + 1, (min(p // ps, npg - 1) + 1) * ps)
        return max(hi - (max(p - window + 1, 0) if window else 0), 0)

    need = [keys_in(p) for p in pos.tolist()]
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
        keep[i, 0, 0, :n_keys] = (j <= pos[i]) & (j >= startp[i]) & (
            j > pos[i] - window if window else True)
    qg = qd.transpose(1, 2)                  # [B, H, 1, hd]

    def paged_library():
        return sdpa(qg, kg, vg, attn_mask=keep, enable_gqa=True)

    lib_out = kattn.to_rows(paged_library().transpose(1, 2), hkv)
    lib_fin = torch.isfinite(lib_out) & torch.isfinite(gotp)
    pag = {"shape": list(qd4.shape), "window": window, "max_abs_err": p_err,
           "partition_keys": kattn.paged_partition_keys(hd, 8),
           "ms": cuda_ms(torch, paged, iters=100),
           "device_ms": graph_ms(torch, paged, iters=100),
           "plain_ms": cuda_ms(torch, lambda: ref.paged_attention_ref(
               qd, kp, vp, table, t8, pos=pos, start=startp, window=window),
               iters=5),
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


def band_mask(torch, dev, pos0, tq, tk, window=0):
    """[tq, tk] bool: query row r at pos0 + r sees key j <= pos0 + r (and
    j > pos0 + r - window with a window), as scaled_dot_product_attention's
    mask."""
    qpos = pos0 + torch.arange(tq, device=dev)[:, None]
    j = torch.arange(tk, device=dev)[None, :]
    keep = j <= qpos
    return keep & (j > qpos - window) if window else keep


def hd_attention_check(torch, dev, cfg, seed=27, window=0):
    """Both attention kernels (:func:`attention_check`, under ``window``)
    and the append at ``cfg``'s heads (kimi-k2: Hkv 8, G 8, hd 112;
    nemotron-4-340b: 8, 12, 192; recurrentgemma-2b: 1, 10, 256), takum8
    words: the append of a decode step and of a chunk held bit for bit to
    the plain append, and timed."""
    from repro_torch import formats
    from repro_torch.kernels import ref, takum_codec
    t8 = formats.get("takum8")
    hkv, hd = cfg.n_kv_heads, cfg.hd
    grp = cfg.n_heads // hkv
    cont, pag, nar = attention_check(torch, dev, hkv, grp, hd, seed=seed,
                                     window=window)
    # the append, both modes, against the plain append
    app = {}
    for mode in ("paged", "contiguous"):
        k, v, kc, vc, where = kv_append_inputs(
            torch, dev, t8, None, torch.bfloat16, mode, 10 * seed, hkv=hkv,
            hd=hd)
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
    cfg = served_cfg(arch, layers)
    # a full-width kimi-k2 layer's expert stacks fit the card only in bf16
    dtype = None if layers is None else torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    params, weights_s, fq, _ = served_params(torch, dev, cfg, dtype)
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


# -- phases 28-29: the dense relu2/gelu configs and the hybrid RG-LRU family --

# phase 28's depth, cut from nemotron-4-340b's 96 layers: a layer is 3.45 G
# takum8 words, beside the two bf16 embedding tables' 18.9 GB
NEMOTRON_LAYERS = 8
# phase 29: recurrentgemma-2b's equal-length prompts, longer than its
# 2048-token window and no multiple of 2048 (the contiguous kernel, not
# the fresh branch, runs the prefill)
RG_PLEN, RG_BATCH, RG_NEW = 2300, 4, 16
# the wire matmul at the largest [K, N] of each phase's path, at the M of a
# decode step (the streaming kernel) and of a prefill (the tensor-core
# one): nemotron's relu2 MLP, 1.36 G words a leaf (K up to 73728, the
# prefill's split-K); recurrentgemma's MLP at its lockstep prefill's M
# (RG_BATCH x RG_PLEN rows)
NEMOTRON_MM = ((4, 18432, 73728), (4, 73728, 18432), (256, 18432, 73728),
               (256, 73728, 18432))
RG_MM = ((RG_BATCH * RG_PLEN, 2560, 7680), (RG_BATCH * RG_PLEN, 7680, 2560))


def served_matmul_check(torch, dev, shapes):
    """The takum8 wire matmul at a served model's shapes
    (:func:`wire_matmul_check`: the f32 bound, the statistical limit and
    its TF32/bf16 controls), each timed beside its bound, the plain
    version and torch.matmul."""
    from repro_torch import formats
    rows = []
    for m, k, n in shapes:
        rows.append(wire_matmul_check(torch, dev, formats.get("takum8"),
                                      m, k, n, timed=True))
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def nemotron_phase(torch, dev, wrappers):
    """Phase 28: nemotron-4-340b at full width (d 18432, 96/8 heads of
    192, d_ff 73728, relu2, vocab 256000), ``NEMOTRON_LAYERS`` of its 96
    layers (each made in bf16, then encoded to takum8 wire words), a
    takum8 KV cache: phase 5's requests through the scheduler with the
    decode step replayed from a CUDA graph (the relu2 MLP's 1.36 G-word
    leaves through the wire matmul's both regimes); the replayed step
    against the eager one, bit for bit (phase 19's check); the wire
    matmul at ``NEMOTRON_MM`` (:func:`served_matmul_check`); hd 192
    through the append and both attention kernels at the served shapes
    (Hkv 8, G 12), each against its plain version, with NaR words; the
    reduced config served on the card and on the CPU."""
    from repro_torch.configs import get_arch
    cfg = served_cfg("nemotron-4-340b", NEMOTRON_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params, weights_s = full_width_params(torch, dev, cfg, "takum8",
                                          dtype=torch.bfloat16)
    serve = serve_full_width(torch, dev, wfmt="takum8", kv="takum8",
                             plens=PHASE5_PLENS, max_new=16, max_len=1280,
                             wrappers=wrappers, params=params, cfg=cfg)
    serve["weights_s"] = round(weights_s, 2)
    serve["layers_of"] = get_arch("nemotron-4-340b").config.n_layers
    serve["activation"] = cfg.activation
    serve["prefill_ms_per_chunk"] = round(
        1e3 * serve["prefill_s"] / max(serve["prefill_chunks"], 1), 1)
    launches = serve["launches"]
    for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
        check(launches[k] > 0, f"nemotron-4-340b: kernel {k} was not "
              "launched by the serving run")
    check(launches["takum_encode"] == 0 and launches["takum_decode"] == 0,
          "nemotron-4-340b: the serving run launched the standalone codec")
    out = {"serving": serve}
    out["graph_vs_eager"] = graph_vs_eager(
        torch, dev, params, cfg, plens=PHASE5_PLENS, max_new=MOE_LATE,
        late_at=40, late_plen=150, late_new=32)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["wire_matmul"] = served_matmul_check(torch, dev, NEMOTRON_MM)
    out["hd_kernels"] = hd_attention_check(torch, dev, cfg, seed=28)
    out["reduced_card_vs_cpu"] = reduced_card_vs_cpu(
        torch, dev, wfmt="takum8", kv="takum8", arch="nemotron-4-340b")
    return out


def window_attention_served(torch, dev, cfg, seed=29):
    """Contiguous attention at recurrentgemma-2b's served shapes (Hkv 1, G
    10, hd 256, its window of 2048): the lockstep prefill (tq = RG_PLEN
    from pos 0) and a decode step (tq = 1 at the last step's pos), B =
    RG_BATCH over a takum8 cache of the lockstep width, each against its
    plain version (ATTN_ATOL), timed beside its bound and SDPA's time (K/V
    decoded beforehand, the band as a boolean mask)."""
    from repro_torch import formats
    from repro_torch.kernels import ref, takum_codec
    from repro_torch.kernels import takum_attention as kattn
    from repro_torch.serve.engine import CACHE_SLACK
    t8 = formats.get("takum8")
    hkv, hd, win = cfg.n_kv_heads, cfg.hd, cfg.window
    grp = cfg.n_heads // hkv
    b = RG_BATCH
    tmax = -(-(RG_PLEN + RG_NEW + CACHE_SLACK) // 256) * 256
    g = torch.Generator(device=dev).manual_seed(seed)
    kc, vc = (takum_codec.encode(torch.randn((b, tmax, hkv, hd), generator=g,
                                             device=dev), t8)
              for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, tq, pos0 in (("prefill", RG_PLEN, 0),
                           ("step", 1, RG_PLEN + RG_NEW - 1)):
        q = torch.randn((b, tq, hkv * grp, hd), generator=g, device=dev)
        q4 = kattn.to_rows(q, hkv).contiguous()

        def kernel():
            return kattn.attention(q4, kc, vc, pos0, None, spec=t8, tq=tq,
                                   window=win)

        got = kernel()
        want = kattn.to_rows(ref.attention_ref(q, kc, vc, 8, t8, pos=pos0,
                                               window=win), hkv)
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= ATTN_ATOL,
              f"hd {hd} contiguous attention, window {win}, tq {tq}: off "
              f"by {err}")
        del want
        lo = max(pos0 - win + 1, 0)           # the first key any row sees
        keys = sum(min(pos0 + r + 1, win) for r in range(tq)) * grp * hkv * b
        b_ms, b_by = bound(q4.numel() * 4 * 2
                           + 2 * b * (pos0 + tq - lo) * hkv * hd,
                           4 * hd * keys * tf32_products(t8), TF32_FLOPS)
        kf = ref.decode_ref(kc, t8)[:, :pos0 + tq].transpose(1, 2)
        vf = ref.decode_ref(vc, t8)[:, :pos0 + tq].transpose(1, 2)
        qf = q.transpose(1, 2)
        mask = band_mask(torch, dev, pos0, tq, pos0 + tq, win)

        def library():
            return sdpa(qf, kf, vf, attn_mask=mask, enable_gqa=True)

        lib = kattn.to_rows(library().transpose(1, 2), hkv)
        out[name] = {
            "shape": list(q4.shape), "cache": [b, tmax, hkv, hd],
            "pos": pos0, "window": win, "max_abs_err": err,
            "ms": cuda_ms(torch, kernel, iters=20 if tq > 1 else 100),
            "plain_ms": cuda_ms(torch, lambda: ref.attention_ref(
                q, kc, vc, 8, t8, pos=pos0, window=win), iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, library,
                                  iters=20 if tq > 1 else 100),
            "library_max_abs_err": float((lib - got).abs().max()),
            "library_call": "scaled_dot_product_attention(enable_gqa=True) "
                            "on K/V decoded to f32 beforehand (not timed), "
                            "boolean band mask"}
        if tq == 1:
            out[name]["device_ms"] = graph_ms(torch, kernel, iters=100)
        del q, q4, got, kf, vf, qf, mask, lib
        torch.cuda.empty_cache()
    return out


def lockstep_served(torch, dev, cfg, params, prompts, max_new, wrappers,
                    media=None):
    """``ServeEngine.generate`` (routed to lockstep: the scheduler
    refuses these families, and a media prompt goes there in any case)
    over ``prompts`` with ``media``, every forward timed
    (:func:`lockstep_traced`); the output's shape and vocabulary and the
    logits' finiteness checked. Returns (the serving fields, the
    per-forward count)."""
    from repro_torch.serve.engine import CACHE_SLACK, ServeEngine
    eng = ServeEngine(params, cfg, max_len=max(map(len, prompts)) + max_new
                      + CACHE_SLACK, device=dev)
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks, tops, prefill_s, step_ms = lockstep_traced(
        torch, eng, prompts, max_new,
        call=lambda p, n: eng.generate(p, n, media=media))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    check(eng._sched is None, f"{cfg.name}: generate did not route to "
          "lockstep")
    for p, o in zip(prompts, toks):
        check(o[:len(p)] == p and len(o) == len(p) + max_new
              and all(0 <= t < cfg.vocab for t in o[len(p):]),
              f"{cfg.name}: served output has the wrong shape or tokens "
              "out of vocab")
    check(all(bool(torch.isfinite(v).all()) for v, _ in tops),
          f"{cfg.name}: logits not finite")
    check(launches["takum_encode"] == 0 and launches["takum_decode"] == 0
          and launches["paged_attention"] == 0
          and launches["fake_quant"] == 0,
          f"{cfg.name}: the serving run launched another kernel than its "
          f"path's: {launches}")
    forwards = len(tops)             # the prefill and every decode step
    serve = {"arch": cfg.name, "layers": cfg.n_layers, "kv": cfg.kv_quant,
             "d_model": cfg.d_model, "prompts": [len(p) for p in prompts],
             "max_new": max_new, "forwards": forwards,
             "generate_s": round(gen_s, 3), "prefill_s": round(prefill_s, 3),
             "decode_ms_per_step": round(step_ms, 2),
             "step": "eager (lockstep: the contiguous attention takes pos "
                     "as a host int)",
             "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
             "launches": launches}
    del eng, tops
    gc.collect()
    torch.cuda.empty_cache()
    return serve, forwards


def recurrentgemma_phase(torch, dev, wrappers):
    """Phase 29: recurrentgemma-2b at full width and depth (26 layers in
    the (rec, rec, attn) pattern, d 2560, MQA 10/1 heads of 256, window
    2048, RG-LRU width 2560, gelu, tied vocab 256000), takum8 wire
    attention and MLP, the RG-LRU fake-quantised at set-up by the
    fake-quant kernel, a takum8 KV cache: RG_BATCH prompts of RG_PLEN
    tokens, RG_NEW new each, through ``ServeEngine.generate`` (routed to
    lockstep: the scheduler refuses the family), every forward timed;
    then the wire matmul at ``RG_MM`` (:func:`served_matmul_check`), hd
    256 through the append and both attention kernels with the
    window (:func:`hd_attention_check`) and the contiguous kernel at the
    served shapes (:func:`window_attention_served`); and the reduced
    recurrentgemma-2b, minitron-4b and starcoder2-15b served on the card
    and on the CPU."""
    from repro_torch.models import transformer
    from repro_torch.models import transformer
    cfg = served_cfg("recurrentgemma-2b")
    torch.cuda.reset_peak_memory_stats()
    params, weights_s, fq, audit = served_params(torch, dev, cfg, None)
    setup_gb = torch.cuda.max_memory_allocated() / 1e9
    check(fq > 0, "recurrentgemma-2b: quantize_weights launched no "
          "fake-quant kernel")
    g = torch.Generator().manual_seed(29)
    prompts = [torch.randint(0, cfg.vocab, (RG_PLEN,), generator=g).tolist()
               for _ in range(RG_BATCH)]
    serve, forwards = lockstep_served(torch, dev, cfg, params, prompts,
                                      RG_NEW, wrappers)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = serve["launches"]
    n_attn = transformer.layer_kinds(cfg).count("self")
    calls = n_attn * forwards           # the prefill and every step
    check(launches["attention"] == calls and launches["kv_append"] == calls,
          f"recurrentgemma-2b: {launches['attention']} attention and "
          f"{launches['kv_append']} append launches for {calls} calls")
    check(launches["qmatmul"] > 0, f"recurrentgemma-2b: launches {launches}")
    serve.update(weights="takum8 (attention, MLP; the RG-LRU "
                 "fake-quantised)", attention_layers=n_attn,
                 weights_s=round(weights_s, 2), quantize_audit=audit,
                 fake_quant_launches_setup=fq,
                 peak_gb_setup=round(setup_gb, 2))
    out = {"serving": serve}
    out["wire_matmul"] = served_matmul_check(torch, dev, RG_MM)
    out["hd_kernels"] = hd_attention_check(torch, dev, cfg, seed=29,
                                           window=cfg.window)
    out["served_attention"] = window_attention_served(torch, dev, cfg)
    out["reduced_card_vs_cpu"] = [
        reduced_card_vs_cpu(torch, dev, wfmt="takum8", kv="takum8", arch=a)
        for a in ("recurrentgemma-2b", "minitron-4b", "starcoder2-15b")]
    return out


# -- phases 30-32: rwkv6, encdec and vlm, served through lockstep ---------------

# phase 30, rwkv6-1.6b: phase 5's prompt lengths with the longest cut to
# 1000, so lockstep rounds the batch up to 1024 (a multiple of the
# 64-token WKV chunk) and every row is left-padded
RWKV_PLENS, RWKV_NEW = (77, 300, 520, 1000), 16
# phase 31, seamless-m4t-large-v2: 1024 audio-stub frames a request (the
# config's T_a = seq_len // 4 at 4096) and target prompts of 8-32 tokens
SEAMLESS_FRAMES, SEAMLESS_PLENS, SEAMLESS_NEW = 1024, (8, 17, 25, 32), 64
# phase 32, llama-3.2-vision-11b: phase 5's prompts, each with the
# config's 1601 patch embeddings
VLM_NEW = 16
# the wire matmul at each phase's own shapes: a decode step's (M 4: the
# streaming kernel) and the prefill's (the tensor-core kernel). rwkv6:
# the channel mix at M 4 and at the prefill's 4 x 1024 rows. seamless:
# the MLP at M 4 and at the decoder prefill's 4 x 32 rows, the encoder's
# MLP at 4 x 1024 frames, and the cross-attention K/V projection of the
# 4 x 1024 encoder states that every decode step recomputes. vlm: the
# MLP at M 4 and 4 x 1024 rows, and the cross blocks' K/V projection of
# the 4 x 1601 media rows
RWKV_MM = ((4, 2048, 7168), (4, 7168, 2048), (4096, 2048, 7168),
           (4096, 7168, 2048))
SEAMLESS_MM = ((4, 1024, 8192), (4, 8192, 1024), (128, 1024, 8192),
               (4096, 1024, 8192), (4096, 8192, 1024), (4096, 1024, 1024))
VLM_MM = ((4, 4096, 14336), (4, 14336, 4096), (4096, 4096, 14336),
          (4096, 14336, 4096), (6404, 4096, 1024))


def reduced_lockstep_card_vs_cpu(torch, dev, arch, kv, wfmt="takum8",
                                 wrappers=None):
    """The reduced config of ``arch`` with ``wfmt`` wire weights and a
    ``kv`` cache, served through ``generate`` with the frontend stub's
    media on the card and on the CPU (plain versions): identical greedy
    tokens for left-padded prompts (rwkv6's no multiple of 64); the
    prefill logits' largest difference reported. With ``wrappers``, their
    launches in the card's ``generate`` are returned. LNS weights encode
    the activations entering each LNS matmul with a ``logf``: one more
    ``generate`` on each, of prompts cut to one length, has the card's
    encodes replay the CPU run's words (``encode_tap``); it must give the
    CPU's tokens, and every word the card's own encode gave must be the
    CPU's or its neighbour (phase 7's rule). The free-running tokens may
    differ only where such a word was found."""
    from repro_torch import formats
    from repro_torch.configs import get_arch
    from repro_torch.models import model
    from repro_torch.serve.engine import ServeEngine, quantize_weights
    rcfg = dataclasses.replace(get_arch(arch).reduced, kv_quant=kv)
    rparams = quantize_weights(model.init(torch.Generator().manual_seed(0),
                                          rcfg, device="cpu"), wfmt,
                               mode="wire", cfg=rcfg, verbose=False)
    g = torch.Generator().manual_seed(31)
    prompts = [torch.randint(0, rcfg.vocab, (n,), generator=g).tolist()
               for n in (45, 38, 7)]
    media = None
    if rcfg.frontend == "vision":
        media = torch.randn((3, rcfg.n_media_tokens,
                             rcfg.d_media or rcfg.d_model), generator=g)
    elif rcfg.frontend == "audio":
        media = torch.randn((3, 12, rcfg.d_model), generator=g)
    toks, rows, launches = {}, {}, None
    for d in ("cpu", dev):
        eng = ServeEngine(rparams, rcfg, max_len=64, device=d)
        if d != "cpu" and wrappers:
            for f in wrappers.values():
                f.launches = 0
        toks[str(d)] = eng.generate(prompts, 8, media=media)
        if d != "cpu" and wrappers:
            launches = {k: f.launches for k, f in wrappers.items()}
        t = torch.zeros((1, 64), dtype=torch.long)
        t[0, -len(prompts[0]):] = torch.as_tensor(prompts[0])
        c = model.init_cache(rcfg, 1, 72, device=d)
        row, _ = model.prefill(eng.params, t.to(d), rcfg, c,
                               media=None if media is None
                               else media[:1].to(d))
        rows[str(d)] = row.cpu()
    same = toks["cpu"] == toks[str(dev)]
    what = f"reduced {arch} ({wfmt} weights, {kv} KV)"
    out = {"arch": arch, "weights": wfmt, "kv": kv,
           "media": None if media is None else list(media.shape),
           "tokens_identical": same,
           "prefill_logits_max_abs_err": float(
               (rows["cpu"] - rows[str(dev)]).abs().max())}
    if launches is not None:
        out["launches"] = launches
    if not formats.get(wfmt).has_lns_parts:
        check(same, f"{what}: card and CPU tokens differ")
        return out
    # the replay runs prompts of one length: a left-padded row before its
    # start averages V over the whole cache, which the card rounds up to
    # the KV tile (ROADMAP.md section 3), so its values differ from the
    # CPU's by design, and no real row reads them
    even = [p[:len(prompts[-1])] for p in prompts]
    atol = RWKV6_ENCODE_INPUT_ATOL if rcfg.family == "rwkv6" \
        else ENCODE_INPUT_ATOL
    with eager_mode(True), encode_tap(torch) as calls:
        want = ServeEngine(rparams, rcfg, max_len=64,
                           device="cpu").generate(even, 8, media=media)
    with eager_mode(True), encode_tap(torch, replay=calls, atol=atol) as seen:
        forced = ServeEngine(rparams, rcfg, max_len=64,
                             device=dev).generate(even, 8, media=media)
    near, far = lns_neighbours(torch, seen["pairs"])
    check(forced == want, f"{what}: the card's tokens differ from the "
          "CPU's with the CPU's words replayed")
    check(far <= 1, f"{what}: a card encode lies {far} words from the "
          "CPU's")
    check(same or seen["differ"] > 0, f"{what}: card and CPU tokens differ "
          "and no encoded word does")
    out.update(forced_tokens_identical=True, forced_prompts=len(even[0]),
               encode_input_atol=atol, encoded_words=seen["words"],
               words_differing=seen["differ"], neighbours=near,
               max_word_step=far,
               max_encode_input_diff=seen["max_input_diff"],
               first_differing_word=seen["first"])
    return out


def family_phase(torch, dev, n, wrappers):
    """Phases 30-32: one family the scheduler refuses, at the reference
    config's full width and depth with seeded random weights (takum8 wire
    projections; rwkv6's decay LoRA, mixes and bonus fake-quantised at
    set-up), served through ``generate`` (lockstep) with the frontend
    stub's seeded media: 30 rwkv6-1.6b (RWKV_PLENS, no attention); 31
    seamless-m4t-large-v2 (SEAMLESS_FRAMES audio frames and
    SEAMLESS_PLENS target prompts a request, its bf16 decoder cache); 32
    llama-3.2-vision-11b (phase 5's prompts with 1601 patch embeddings
    each, a takum8 cache). Every wrapper's launches from that run, held to
    what the path must launch; the wire matmul at the phase's shapes
    (:func:`served_matmul_check`); contiguous attention at the decode
    step's shape (:func:`tq1_attention_served`); the reduced config card
    against CPU."""
    from repro_torch import formats
    from repro_torch.models import transformer
    arch = {30: "rwkv6-1.6b", 31: "seamless-m4t-large-v2",
            32: "llama-3.2-vision-11b"}[n]
    kv = "none" if n == 31 else "takum8"
    cfg = dataclasses.replace(served_cfg(arch), kv_quant=kv)
    torch.cuda.reset_peak_memory_stats()
    params, weights_s, fq, audit = served_params(torch, dev, cfg, None)
    setup_gb = torch.cuda.max_memory_allocated() / 1e9
    g = torch.Generator(device=dev).manual_seed(n)
    gp = torch.Generator().manual_seed(5)          # phase 5's prompts
    plens = {30: RWKV_PLENS, 31: SEAMLESS_PLENS, 32: PHASE5_PLENS}[n]
    prompts = [torch.randint(0, cfg.vocab, (p,), generator=gp).tolist()
               for p in plens]
    media = None
    if n == 31:
        media = torch.randn((len(plens), SEAMLESS_FRAMES, cfg.d_model),
                            generator=g, device=dev)
    elif n == 32:
        media = torch.randn((len(plens), cfg.n_media_tokens,
                             cfg.d_media or cfg.d_model), generator=g,
                            device=dev)
    max_new = {30: RWKV_NEW, 31: SEAMLESS_NEW, 32: VLM_NEW}[n]
    serve, forwards = lockstep_served(torch, dev, cfg, params, prompts,
                                      max_new, wrappers, media=media)
    serve["media"] = None if media is None else list(media.shape)
    del params, media
    gc.collect()
    torch.cuda.empty_cache()
    launches = serve["launches"]
    if n == 30:
        wired = 8 * cfg.n_layers              # every layer, every forward
        calls = 0
        check(fq == 6 * cfg.n_layers, f"rwkv6: {fq} fake-quant launches at "
              "set-up, not one for each of 6 leaves a layer")
    elif n == 31:
        wired = 10 * cfg.n_layers
        calls = cfg.n_layers
    else:
        wired = 7 * cfg.n_layers
        calls = transformer.layer_kinds(cfg).count("self")
    # the prefill runs the encoder's 6 wired leaves a layer too
    enc = 6 * cfg.n_enc_layers if n == 31 else 0
    check(launches["qmatmul"] == wired * forwards + enc,
          f"{arch}: {launches['qmatmul']} wire matmul launches for "
          f"{forwards} forwards")
    check(launches["attention"] == calls * forwards
          and launches["kv_append"] == calls * forwards,
          f"{arch}: {launches['attention']} attention and "
          f"{launches['kv_append']} append launches for "
          f"{calls * forwards} calls")
    serve.update(weights="takum8 (every projection; rwkv6's decay LoRA, "
                 "ww, mixes and bonus fake-quantised)" if n == 30
                 else "takum8 (every projection)",
                 weights_s=round(weights_s, 2), quantize_audit=audit,
                 fake_quant_launches_setup=fq,
                 peak_gb_setup=round(setup_gb, 2))
    out = {"serving": serve}
    out["wire_matmul"] = served_matmul_check(
        torch, dev, {30: RWKV_MM, 31: SEAMLESS_MM, 32: VLM_MM}[n])
    blk = 256
    if n == 30:
        out["served_attention"] = "none: rwkv6 has no attention"
    elif n == 31:
        tmax = -(-(max(plens) + max_new + 8) // blk) * blk
        out["served_attention"] = tq1_attention_served(
            torch, dev, formats.get("none"), torch.bfloat16, b=len(plens),
            hkv=cfg.n_kv_heads, grp=cfg.n_heads // cfg.n_kv_heads,
            hd=cfg.hd, tmax=tmax, pos=max(plens) + max_new - 1, seed=n)
    elif n == 32:
        plen = max(plens)
        tmax = -(-(plen + max_new + 8) // blk) * blk
        out["served_attention"] = tq1_attention_served(
            torch, dev, formats.get("takum8"), None, b=len(plens),
            hkv=cfg.n_kv_heads, grp=cfg.n_heads // cfg.n_kv_heads,
            hd=cfg.hd, tmax=tmax, pos=plen + max_new - 1,
            start=[plen - p for p in plens], seed=n)
    out["reduced_card_vs_cpu"] = reduced_lockstep_card_vs_cpu(torch, dev,
                                                              arch, kv)
    return out


# -- 33. the codec at every width ------------------------------------------

# widths whose every word is decoded, and those sampled (2^24 seeded words)
WIDTHS_ALL = tuple(range(6, 17))
WIDTHS_SAMPLED = (17, 20, 24, 28, 29, 32)
WIDTHS_TIMED = (8, 12, 16, 24, 32)        # decode/encode times per kind
WIDTHS_FQ = WIDTHS_TIMED                  # fake-quant, and plain times
SWEEP_STRIDE = 61                         # the encode sweep's pattern step
SWEEP_FORMATS = (("linear", 8), ("linear", 16), ("posit", 8), ("posit", 16))
RAGGED_WIDTHS = (8, 12, 16, 24, 32)
WIDTHS_HW = (12, 16, 24, 32)              # the hw path against the kernels
CODEC_SHAPE = (5120, 17920)
CODEC_SAMPLE = 1 << 24                    # seeded words and floats a width
CODEC_KINDS = ("linear", "lns", "posit")


def float_sample(torch, dev, n, kind, seed):
    """2^24 seeded f32 values: normals over the f32 range, raw bit
    patterns, subnormals, zeros, +-inf, NaN and, for linear takum and
    posit up to 27 bits, the rounding ties of width n (the odd words of
    width n + 1 decoded: exactly halfway on the encoding grid)."""
    from repro_torch import formats
    from repro_torch.core.bitops import to_words
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    m = CODEC_SAMPLE // 4
    x = torch.randn(CODEC_SAMPLE, generator=g, device=dev) * torch.pow(
        10.0, torch.randint(-45, 39, (CODEC_SAMPLE,), device=dev,
                            generator=g).float())
    raw = torch.randint(-2 ** 31, 2 ** 31, (m,), device=dev, generator=g,
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    sub = torch.randint(1, 2 ** 23, (m // 4,), device=dev, generator=g,
                        dtype=torch.int32).view(torch.float32)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-45, -1e-45, 1.1754942e-38,
                            3.4028235e38, -3.4028235e38, 1.0, -1.0],
                           device=dev)
    parts = [special, sub, -sub, raw]
    if kind != "lns" and n + 1 <= 27:
        wide = formats.resolve(kind, n + 1)
        odd = torch.randint(0, 2 ** n, (m,), device=dev, generator=g) * 2 + 1
        parts.append(ref.decode_ref(to_words(odd, wide.word_dtype), wide))
    return torch.cat(parts + [x])[:CODEC_SAMPLE]


def lns_encode_bounds(torch, x, n):
    """The words a logarithmic encode of ``x`` may give when its f32
    ``log`` is within 2 ulp of the plain version's: the plain encode of
    2 ln|x| moved 2 ulps down and up (the word is monotone in ell_bar
    within a sign), as (low, high) int64 words."""
    from repro_torch.core import takum
    from repro_torch.core.bitops import lanes
    s = (x < 0).long()
    zero, nan = x == 0, torch.isnan(x)
    ell = 2.0 * torch.log(torch.abs(torch.where(zero | nan,
                                                torch.ones_like(x), x)))
    out = []
    for step in (-2, 2):
        e = ell
        for _ in range(abs(step)):
            e = torch.nextafter(e, torch.full_like(e, float(step) * 1e38))
        eb = torch.clamp(torch.where(s == 1, -e, e), -256.0, 256.0)
        fixed = torch.round(eb * float(1 << 22)).long()
        out.append(lanes(takum.encode_lns(s, fixed, n, wf=22, is_zero=zero,
                                          is_nar=nan)))
    return torch.minimum(*out), torch.maximum(*out)


def lns_encode_ok(got, want, lo, hi, n):
    """Per float, whether an LNS encode kernel's word ``got`` is the plain
    version's ``want`` or, at a ``logf`` tie, its neighbour: one word
    either way and inside the window (``lo``, ``hi``) of
    :func:`lns_encode_bounds` (int64 words throughout). From n = 33 a
    word keeps ell_bar's 22 fraction bits (21 at n = 33 next to the
    longest header), so a tie of the fixed point form moves the word by
    2^(wf - 22) words: there the rule is the window alone."""
    if n > 32:
        return (got == want) | ((got >= lo) & (got <= hi))
    step = (got - want) % (1 << n)
    near = (step == 1) | (step == (1 << n) - 1)
    return (step == 0) | (near & (got >= lo) & (got <= hi))


def width_codec_check(torch, dev, n, kind, seed):
    """Decode (every word for n <= 16, 2^24 seeded words above) and encode
    (``float_sample``) kernels of width n against the plain codec on the
    card: linear and posit bit for bit (NaN by place), LNS decodes within
    2 ulp and encoded words equal to the plain version's or, at an
    ell_bar rounding tie of logf, its neighbour inside the window of
    ``lns_encode_bounds`` (``lns_encode_ok``), at most
    ``LNS_NEIGHBOUR_SHARE`` of them (phase 7's rule)."""
    from repro_torch import formats
    from repro_torch.core.bitops import lanes, to_words
    from repro_torch.kernels import ref, takum_codec
    spec = formats.resolve(kind, n)
    if n <= 16:
        words = to_words(torch.arange(2 ** n, device=dev), spec.word_dtype)
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        w = torch.randint(0, 2 ** n, (CODEC_SAMPLE,), device=dev,
                          generator=g)
        w[:6] = torch.tensor([0, 1, 2 ** (n - 1) - 1, 2 ** (n - 1),
                              2 ** (n - 1) + 1, 2 ** n - 1])
        words = to_words(w, spec.word_dtype)
    got = takum_codec.decode(words, spec)
    want = ref.decode_ref(words, spec)
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan),
          f"{spec.name}: decode kernel NaNs differ from the plain codec")
    dec_ulps = int(ulps(torch, got[~nan], want[~nan]).max())
    check(dec_ulps <= (2 if kind == "lns" else 0),
          f"{spec.name}: decode kernel {dec_ulps} ulp off the plain codec")
    xs = float_sample(torch, dev, n, kind, seed + 1)
    gw = lanes(takum_codec.encode(xs, spec))
    ww = lanes(ref.encode_ref(xs, spec))
    row = {"words": words.numel(), "decode_max_ulps": dec_ulps,
           "floats": xs.numel()}
    if kind == "lns":
        share = float((gw != ww).double().mean())
        lo, hi = lns_encode_bounds(torch, xs, n)
        check(bool(lns_encode_ok(gw, ww, lo, hi, n).all()),
              f"{spec.name}: an encoded word other than the plain version's "
              "or, at a logf tie, its neighbour")
        check(share <= LNS_NEIGHBOUR_SHARE, f"{spec.name}: encode neighbour "
              f"share {share} over {LNS_NEIGHBOUR_SHARE}")
        row["encode_neighbour_share"] = share
        row["encode_within_log_2ulp"] = bool(((gw >= lo) & (gw <= hi)).all())
    else:
        check(torch.equal(gw, ww),
              f"{spec.name}: encode kernel differs from the plain codec")
        row["encode_bit_exact"] = True
    return row


def width_times(torch, dev, n, kind, plain):
    """Decode and encode kernel times at ``CODEC_SHAPE``, each beside its
    byte bound ((word bytes + 4) per element), the plain version's time
    (where ``plain``), the library's (``torch.index_select`` on the 2^n
    decoded values for n <= 16, decode only) and PyTorch's elementwise
    cast over the same bytes (``*_stream_ms``: the words as signed
    integers to float32, and float32 to them; the rate this card gives
    the kernels' byte pattern without the codec's arithmetic)."""
    from repro_torch import formats
    from repro_torch.core.bitops import lanes, to_words
    from repro_torch.kernels import ref, takum_codec
    spec = formats.resolve(kind, n)
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(CODEC_SHAPE, generator=g, device=dev)
    words = takum_codec.encode(x, spec)
    nbytes = x.numel() * (words.element_size() + 4)
    b_ms, b_by = bound(nbytes, 0)
    row = {"decode_ms": cuda_ms(torch, lambda: takum_codec.decode(words,
                                                                  spec)),
           "encode_ms": cuda_ms(torch, lambda: takum_codec.encode(x, spec)),
           "bound_ms": b_ms, "bound_by": b_by,
           "word_bytes": words.element_size()}
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
        words.element_size()]
    as_ints = words.view(ints)
    row["decode_stream_ms"] = cuda_ms(
        torch, lambda: as_ints.to(torch.float32))
    row["encode_stream_ms"] = cuda_ms(torch, lambda: x.to(ints))
    if plain:
        row["decode_plain_ms"] = cuda_ms(
            torch, lambda: ref.decode_ref(words, spec), iters=2, warmup=1)
        row["encode_plain_ms"] = cuda_ms(
            torch, lambda: ref.encode_ref(x, spec), iters=2, warmup=1)
    if spec.has_lut:            # posit8: the computed decode beside
        kept = os.environ.get("REPRO_LUT_DECODE")
        os.environ["REPRO_LUT_DECODE"] = "0"
        try:
            row["decode_computed_ms"] = cuda_ms(
                torch, lambda: takum_codec.decode(words, spec))
        finally:
            if kept is None:
                os.environ.pop("REPRO_LUT_DECODE")
            else:
                os.environ["REPRO_LUT_DECODE"] = kept
    if n <= 16:
        table = ref.decode_ref(to_words(torch.arange(2 ** n, device=dev),
                                        spec.word_dtype), spec)
        idx = lanes(words).to(torch.int32).reshape(-1)
        lib = torch.index_select(table, 0, idx).reshape(x.shape)
        err = codec_err(torch, lib, takum_codec.decode(words, spec))
        check(err == 0.0 or kind == "lns", f"{spec.name}: the library's "
              f"table decode differs from the decode kernel by {err}")
        row["decode_library_ms"] = cuda_ms(
            torch, lambda: torch.index_select(table, 0, idx))
    else:
        row["decode_library_ms"] = None
    return row


def encode_sweep(torch, dev, n, kind):
    """Every ``SWEEP_STRIDE``-th float32 bit pattern (about 70 M: every
    exponent and sign, subnormals, infinities and NaNs) through the encode
    kernel at width n, bit for bit against the plain version on the card,
    in chunks of 2^24."""
    from repro_torch import formats
    from repro_torch.core.bitops import lanes
    from repro_torch.kernels import ref, takum_codec
    spec = formats.resolve(kind, n)
    total, chunk, bad = -(-(1 << 32) // SWEEP_STRIDE), 1 << 24, 0
    for i0 in range(0, total, chunk):
        k = torch.arange(i0, min(i0 + chunk, total), device=dev,
                         dtype=torch.int64)
        b = k * SWEEP_STRIDE
        x = torch.where(b >= 1 << 31, b - (1 << 32), b).to(
            torch.int32).view(torch.float32)
        bad += int((lanes(takum_codec.encode(x, spec))
                    != lanes(ref.encode_ref(x, spec))).sum())
    check(bad == 0, f"{spec.name}: {bad} of {total} swept patterns encode "
          "otherwise than the plain version")
    return {"patterns": total, "stride": SWEEP_STRIDE, "differ": bad}


def ragged_check(torch, dev):
    """Counts 1..33 at offsets 0 and 1 (a misaligned view) through the
    decode, encode and fake-quant wrappers at ``RAGGED_WIDTHS`` and every
    kind (posit8 through its table), against the plain version on the
    card: the vectors' scalar tail and the wrappers' alignment (the
    fake-quant wrapper passes the misaligned view as it is: the kernel's
    scalar loop throughout). Linear and posit bit for bit (fake-quant f32
    and bf16 out, linear takum also scaled by 2^3); LNS decodes within 2
    ulp, encodes the plain version's word or, at a logf tie, its
    neighbour (``lns_encode_ok``), fake-quant the codec kernels' round
    trip bit for bit."""
    from repro_torch import formats
    from repro_torch.core.bitops import lanes
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import ref, takum_codec
    base = float_sample(torch, dev, 16, "linear", 77)[:64]
    cases = fq_cases = 0
    for n in RAGGED_WIDTHS:
        for kind in CODEC_KINDS:
            spec = formats.resolve(kind, n)
            words = takum_codec.encode(base, spec)
            for off in (0, 1):
                for cnt in range(1, 34):
                    x, w = base[off:off + cnt], words[off:off + cnt]
                    gw = lanes(takum_codec.encode(x, spec))
                    ww = lanes(ref.encode_ref(x, spec))
                    ok = (bool(lns_encode_ok(
                        gw, ww, *lns_encode_bounds(torch, x, n), n).all())
                          if kind == "lns" else torch.equal(gw, ww))
                    got = takum_codec.decode(w, spec)
                    want = ref.decode_ref(w, spec)
                    nan = torch.isnan(want)
                    ok = ok and torch.equal(torch.isnan(got), nan) and (
                        bool(nan.all()) or int(ulps(
                            torch, got[~nan], want[~nan]).max())
                        <= (2 if kind == "lns" else 0))
                    check(ok, f"{spec.name}: count {cnt} at offset {off} "
                          "differs from the plain version")
                    cases += 1
                    for k in ((0, 3) if kind == "linear" else (0,)):
                        want = (takum_codec.decode(w, spec) if kind == "lns"
                                else ref.fake_quant_ref(x, spec,
                                                        scale_exp=k))
                        for dtype in (torch.float32, torch.bfloat16):
                            got = kquant.fake_quant(x, spec, dtype=dtype,
                                                    scale_exp=k)
                            check(same_floats(torch, got, want.to(dtype)),
                                  f"fake-quant {spec.name} k {k}: count "
                                  f"{cnt} at offset {off} differs")
                            fq_cases += 1
    return {"cases": cases, "fake_quant_cases": fq_cases, "counts": "1-33",
            "offsets": [0, 1], "widths": list(RAGGED_WIDTHS), "equal": True}


def width_fake_quant(torch, dev, n, kind):
    """The fused fake-quant kernel at width n on ``CODEC_SHAPE`` (seeded
    normals with ``float_sample``'s specials): linear and posit bit for
    bit against the plain version (NaN by place), LNS bit for bit against
    the codec kernels' round trip (the same tables), f32 and bf16 out;
    its times beside the byte bounds (4 bytes in, 4 or 2 out) and the
    plain version's; at ``FQ_STRIDED_WIDTHS`` every ``SWEEP_STRIDE``-th
    float32 pattern too (``fake_quant_sweep``)."""
    from repro_torch import formats
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import ref, takum_codec
    spec = formats.resolve(kind, n)
    g = torch.Generator(device=dev).manual_seed(100 + n)
    x = torch.randn(CODEC_SHAPE, generator=g, device=dev)
    k = min(x.numel(), CODEC_SAMPLE)
    x.view(-1)[:k] = float_sample(torch, dev, n, kind, n)[:k]
    got = kquant.fake_quant(x, spec)
    want = (takum_codec.decode(takum_codec.encode(x, spec), spec)
            if kind == "lns" else ref.fake_quant_ref(x, spec))
    check(same_floats(torch, got, want),
          f"{spec.name}: fake-quant kernel differs from "
          + ("the codec kernels' round trip" if kind == "lns"
             else "its plain version"))
    got16 = kquant.fake_quant(x, spec, dtype=torch.bfloat16)
    check(same_floats(torch, got16, want.to(torch.bfloat16)),
          f"{spec.name}: fake-quant kernel's bf16 output differs")
    b_ms, b_by = bound(x.numel() * 8, 0)
    row = {"ms": cuda_ms(torch, lambda: kquant.fake_quant(x, spec)),
           "plain_ms": cuda_ms(torch, lambda: ref.fake_quant_ref(x, spec),
                               iters=2, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by,
           "bf16_ms": cuda_ms(torch, lambda: kquant.fake_quant(
               x, spec, dtype=torch.bfloat16)),
           "bf16_bound_ms": bound(x.numel() * 6, 0)[0],
           "max_abs_err": codec_err(torch, got, want)}
    if n in FQ_STRIDED_WIDTHS:
        row["sweep"] = fake_quant_sweep(torch, dev, n, kind,
                                        stride=SWEEP_STRIDE)
    return row


def hw_path_check(torch, dev, n, seed):
    """The plain hardware-faithful path (section V) on CUDA tensors word
    for word against the CUDA codec's direct path at width n: every word
    (n <= 16; 2^24 seeded words above) decoded through the hw
    characteristic unit and assembled to f32 equals the decode kernel's
    float, and f32 inputs whose fraction fits n - 5 bits, encoded through
    the extended takum and the section V-A predictor (``wm = n - 5``),
    equal the encode kernel's words."""
    from repro_torch import formats
    from repro_torch.core import takum
    from repro_torch.core.bitops import lanes, to_words
    from repro_torch.kernels import takum_codec
    spec = formats.resolve("linear", n)
    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.arange(2 ** n, device=dev) if n <= 16 else
         torch.randint(0, 2 ** n, (CODEC_SAMPLE,), device=dev, generator=g))
    words = to_words(w, spec.word_dtype)
    hw = takum.linear_to_float(takum.decode_linear(words, n, hw_path=True),
                               n)
    check(same_floats(torch, hw, takum_codec.decode(words, spec)),
          f"{spec.name}: the hw-path decode differs from the decode kernel")
    xs = float_sample(torch, dev, n, "linear", seed + 1)
    keep = max(0, 23 - (n - 5))          # fraction bits past n - 5: clear
    xs = (xs.view(torch.int32) & -(1 << keep)).view(torch.float32)
    s, e, f23, zero, nan = takum.float_fields(xs)
    mant = (f23 << (n - 5 - 23)) if n - 5 >= 23 else (f23 >> keep)
    hw_w = lanes(takum.encode(s, torch.where(s == 1, ~e, e), mant, n,
                              wm=n - 5, is_zero=zero, is_nar=nan,
                              hw_path=True))
    check(torch.equal(hw_w, lanes(takum_codec.encode(xs, spec))),
          f"{spec.name}: the hw-path encode differs from the encode kernel")
    return {"words": words.numel(), "floats": xs.numel(), "equal": True}


def fault0_attention_check(torch, dev, hkv, grp, hd, tq, tmax, starts,
                           seed):
    """Contiguous attention with left-padded ``starts`` at pos 0: every
    row, those before ``start`` (every key masked: the uniform average of
    V over the whole cache, words as stored) included, against the plain
    version within ATTN_ATOL; the kernel timed with these starts and with
    none (the cost of the average's kernel and the rows' select)."""
    from repro_torch import formats
    from repro_torch.kernels import ops, ref, takum_codec
    t8 = formats.get("takum8")
    b = len(starts)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, tq, hkv * grp, hd), generator=g, device=dev)
    kc, vc = (takum_codec.encode(torch.randn((b, tmax, hkv, hd), generator=g,
                                             device=dev), t8)
              for _ in range(2))
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    got = ops.takum_attention(q, kc, vc, 8, t8, pos=0, start=st)
    want = ref.attention_ref(q, kc, vc, 8, t8, pos=0, start=st)
    err = float((got - want).abs().max())
    check(err <= ATTN_ATOL, f"contiguous attention hd {hd} with left "
          f"padding: {err} off the plain version (rows before start too)")
    early = float((got[0, : starts[0]] - ref.decode_ref(vc[0], t8).mean(0)
                   .repeat_interleave(grp, 0)).abs().max())
    check(early <= ATTN_ATOL, f"hd {hd}: rows before start are not the "
          f"uniform average of V ({early})")
    # the bound: q read and the output written in f32, K and V words once;
    # each row r >= start dots and weighs keys start..r (the rows before
    # start average V, a sum a key)
    keys_needed = sum(max(0, r - s0 + 1) for s0 in starts
                      for r in range(tq)) * grp * hkv
    b_ms, b_by = bound(q.numel() * 4 * 2 + 2 * b * tmax * hkv * hd,
                       4 * hd * keys_needed * tf32_products(t8), TF32_FLOPS)
    # the yardstick: scaled_dot_product_attention on K/V decoded
    # beforehand, keys start..r for row r (rows before start mask every
    # key and are left out of any comparison: SDPA gives no average there)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kf = ref.decode_ref(kc, t8).transpose(1, 2)
    vf = ref.decode_ref(vc, t8).transpose(1, 2)
    qf = q.transpose(1, 2)
    j = torch.arange(tmax, device=dev)
    r = torch.arange(tq, device=dev)[:, None]
    mask = ((j[None, None, :] <= r[None]) & (j[None, None, :]
            >= st.long()[:, None, None]))[:, None]
    lib = sdpa(qf, kf, vf, attn_mask=mask, enable_gqa=True).transpose(1, 2)
    late = (r[None, :, 0] >= st.long()[:, None])[:, :, None, None]
    lib_err = float(torch.where(late, (lib - got).abs(),
                                torch.zeros_like(got)).max())
    return {"shape": [b, tq, hkv * grp, hd], "tmax": tmax, "starts": starts,
            "max_abs_err": err, "rows_before_start_max_abs_err": early,
            "ms": cuda_ms(torch, lambda: ops.takum_attention(
                q, kc, vc, 8, t8, pos=0, start=st), iters=10),
            "ms_no_start": cuda_ms(torch, lambda: ops.takum_attention(
                q, kc, vc, 8, t8, pos=0, start=None), iters=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": cuda_ms(torch, lambda: ref.attention_ref(
                q, kc, vc, 8, t8, pos=0, start=st), iters=2, warmup=1),
            "library_ms": cuda_ms(torch, lambda: sdpa(
                qf, kf, vf, attn_mask=mask, enable_gqa=True), iters=10),
            "library_call": "scaled_dot_product_attention(enable_gqa=True) "
                            "on K/V decoded beforehand, keys start..r for "
                            "row r (rows before start not compared)",
            "library_max_abs_err_rows_after_start": lib_err}


def codec_widths_phase(torch, dev):
    """Phase 33: the codec and fake-quant kernels at every width 6..32, the
    hw path against them, the widths' times, and the contiguous
    attention's rows before ``start`` (hd 128 and 256). The path: every
    width's decode, encode and fake-quant through ``ops`` (and linear
    takum's serving fake-quant, ``FormatSpec.fake_quant``), with the
    launch counters zeroed just before and read just after."""
    from repro_torch import formats
    from repro_torch.kernels import ops, takum_codec
    from repro_torch.kernels import quantize as kquant
    checks = {}
    for i, n in enumerate(WIDTHS_ALL + WIDTHS_SAMPLED):
        for j, kind in enumerate(CODEC_KINDS):
            checks[f"{kind}{n}"] = width_codec_check(torch, dev, n, kind,
                                                     1000 + 10 * i + j)
    hw = {str(n): hw_path_check(torch, dev, n, 2000 + n) for n in WIDTHS_HW}
    sweep = {f"{kind}{n}": encode_sweep(torch, dev, n, kind)
             for kind, n in SWEEP_FORMATS}
    ragged = ragged_check(torch, dev)
    fq = {f"{kind}{n}": width_fake_quant(torch, dev, n, kind)
          for n in WIDTHS_FQ for kind in CODEC_KINDS}
    times = {str(n): {kind: width_times(torch, dev, n, kind,
                                        n in WIDTHS_FQ)
                      for kind in CODEC_KINDS} for n in WIDTHS_TIMED}
    attn = {"hd128": fault0_attention_check(
                torch, dev, 8, 4, 128, 1024, 1280, [947, 724, 504, 0], 33),
            "hd256": fault0_attention_check(
                torch, dev, 1, 10, 256, 256, 1024, [200, 100, 37, 0], 34)}
    # the path: zero the counters, drive the entry points at each timed
    # width and kind (each one's launches kept), read them
    x = torch.randn(CODEC_SHAPE, device=dev)
    fns = {"takum_decode": takum_codec.decode,
           "takum_encode": takum_codec.encode,
           "fake_quant": kquant.fake_quant}
    for fn in fns.values():
        fn.launches = 0
    per = {}
    for n in WIDTHS_TIMED:
        for kind in CODEC_KINDS:
            before = {k: fn.launches for k, fn in fns.items()}
            spec = formats.resolve(kind, n)
            ops.takum_decode(ops.takum_encode(x, spec), spec)
            if n in WIDTHS_FQ:
                ops.fake_quant_fused(x, n, fmt=kind)
            if spec.name == "takum12":
                spec.fake_quant(x)          # the serving fake-quant
            per[f"{kind}{n}"] = {k: fn.launches - before[k]
                                 for k, fn in fns.items()}
    launches = {k: fn.launches for k, fn in fns.items()}
    check(all(v["takum_decode"] and v["takum_encode"] for v in per.values())
          and all(per[f"{k}{n}"]["fake_quant"] for n in WIDTHS_FQ
                  for k in CODEC_KINDS),
          f"phase 33's path launched {per}")
    torch.cuda.synchronize()
    return {"checks": checks, "hw_path": hw, "fake_quant": fq,
            "times": times, "attention_rows_before_start": attn,
            "encode_sweep": sweep, "ragged": ragged,
            "launches": launches, "launches_per_format": per}


# -- 34. the codec at 33-64 bits and the float64 decode ----------------------

WIDTHS_64 = (33, 40, 48, 57, 58, 61, 64)
WIDTHS_F64 = (8, 16, 24, 32)          # float64 out from 8-/16-/32-bit words
WIDTHS_64_TIMED = (40, 64)            # 64-bit words timed (and 32 to f64)
F64_SWEEP = ((64, "linear"), (64, "posit"))


def wide_words(torch, dev, n, seed):
    """2^24 seeded n-bit words (every word for n <= 16), half with the
    top bit set and half with it clear at n > 16, and the words around 0
    and NaR."""
    from repro_torch import formats
    from repro_torch.core.bitops import mask, signed64, to_words
    dtype = formats.resolve("linear", n).word_dtype
    if n <= 16:
        return to_words(torch.arange(2 ** n, device=dev), dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(-2 ** 63, 2 ** 63 - 1, (CODEC_SAMPLE,), device=dev,
                      generator=g, dtype=torch.int64) & mask(n, 64)
    top = signed64(1 << (n - 1))
    w[: CODEC_SAMPLE // 2] |= top
    w[CODEC_SAMPLE // 2:] &= ~top
    edge = [0, 1, (1 << (n - 1)) - 1, 1 << (n - 1), (1 << (n - 1)) + 1,
            (1 << n) - 1]
    w[:6] = torch.tensor([signed64(v) for v in edge], device=dev)
    return to_words(w, dtype)


def wide_floats(torch, dev, n, kind, seed):
    """``float_sample``'s 2^24 floats with, first, every normal float32
    exponent's fractions 2^j and 3 * 2^j (j = 0..22), both signs: the
    ties of every cut a 64-bit word can have (linear takum rounds at n =
    33 and 34, posit next to its long regimes)."""
    e = torch.arange(1, 255, device=dev, dtype=torch.int64)[:, None] << 23
    j = torch.arange(23, device=dev, dtype=torch.int64)
    m = torch.cat([1 << j, (3 << j) & 0x7FFFFF])[None, :]
    t = (e | m).reshape(-1)
    t = torch.cat([t, t | (1 << 31)])
    ties = torch.where(t >= 1 << 31, t - (1 << 32), t).to(
        torch.int32).view(torch.float32)
    x = float_sample(torch, dev, n, kind, seed)
    return torch.cat([ties, x[ties.numel():]])


def float_differ(torch, got, want, tol=0) -> int:
    """Elements whose floats differ (NaN by place; more than ``tol`` ulp
    apart, bit for bit at 0)."""
    ng, nw = torch.isnan(got), torch.isnan(want)
    both = ~ng & ~nw
    g, w = got[both], want[both]
    if tol == 0:
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[g.element_size()]
        far = g.view(it) != w.view(it)
    else:
        far = ulps(torch, g, w) > tol
    return int((ng != nw).sum()) + int(far.sum())


def wide_codec_check(torch, dev, n, kind, seed, encode=True):
    """Decode (``wide_words``) to float32 and float64, encode and
    fake-quant (f32, bf16 and f64 out; ``wide_floats``) kernels at width
    n against the plain codec on the card: linear and posit bit for bit
    (NaN by place), LNS decodes within 2 ulp, encoded words by
    ``lns_encode_ok`` (at most ``LNS_NEIGHBOUR_SHARE`` apart) and the
    fused round trip equal to the codec kernels' (their decode to the
    same dtype). ``encode`` False: the decode to float64 alone (from 8-,
    16- and 32-bit words) and fake-quant to float64. The row counts the
    outputs outside each rule (all 0, or the phase fails)."""
    from repro_torch import formats
    from repro_torch.core.bitops import lanes
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import ref, takum_codec
    spec = formats.resolve(kind, n)
    words = wide_words(torch, dev, n, seed)
    row = {"words": words.numel()}
    tol = 2 if kind == "lns" else 0
    dtypes = ((torch.float32, torch.float64) if encode else (torch.float64,))
    for dtype in dtypes:
        got = takum_codec.decode(words, spec, dtype=dtype)
        want = ref.decode_ref(words, spec, dtype=dtype)
        bad = float_differ(torch, got, want, tol)
        check(got.dtype == dtype and bad == 0, f"{spec.name}: {bad} "
              f"{dtype} decodes off the plain codec (tolerance {tol} ulp)")
        row[f"decode_{str(dtype)[6:]}_differ"] = bad
    xs = wide_floats(torch, dev, n, kind, seed + 1)
    row["floats"] = xs.numel()
    gw = takum_codec.encode(xs, spec)
    if encode:
        g, w = lanes(gw), lanes(ref.encode_ref(xs, spec))
        if kind == "lns":
            share = float((g != w).double().mean())
            lo, hi = lns_encode_bounds(torch, xs, n)
            bad = int((~lns_encode_ok(g, w, lo, hi, n)).sum())
            check(share <= LNS_NEIGHBOUR_SHARE, f"{spec.name}: encode "
                  f"neighbour share {share} over {LNS_NEIGHBOUR_SHARE}")
            row["encode_neighbour_share"] = share
        else:
            bad = int((g != w).sum())
        check(bad == 0, f"{spec.name}: {bad} encoded words off the plain "
              "codec")
        row["encode_differ"] = bad
    for dtype in ((torch.float32, torch.bfloat16, torch.float64) if encode
                  else (torch.float64,)):
        got = kquant.fake_quant(xs, spec, dtype=dtype)
        want = (takum_codec.decode(gw, spec, dtype=dtype) if kind == "lns"
                else ref.fake_quant_ref(xs, spec, dtype))
        ng, nw = torch.isnan(got), torch.isnan(want)
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            got.element_size()]
        bad = int(((ng != nw) | (~ng & ~nw & (got.view(it) != want.view(it)))
                   ).sum())
        check(bad == 0, f"fake-quant {spec.name} {dtype}: {bad} outputs "
              "differ from " + ("the codec kernels' round trip"
                                if kind == "lns" else "its plain version"))
        row[f"fake_quant_{str(dtype)[6:]}_differ"] = bad
    return row


def wide_times(torch, dev, n, kind, plain):
    """At ``CODEC_SHAPE``: the decode kernel to float32 (64-bit words) and
    to float64, the encode (64-bit words) and fake-quant to float32,
    bfloat16 and float64 (64-bit widths), each beside its byte bound
    (each input read once, each output written once), PyTorch's
    elementwise cast over the same bytes (``*_stream_ms``: the words as
    int64 or int32 to the float, float32 to int64) and, where ``plain``,
    the plain version's time."""
    from repro_torch import formats
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import ref, takum_codec
    spec = formats.resolve(kind, n)
    g = torch.Generator(device=dev).manual_seed(3400 + n)
    x = torch.randn(CODEC_SHAPE, generator=g, device=dev)
    words = takum_codec.encode(x, spec)
    wb, el = words.element_size(), x.numel()
    ints = {4: torch.int32, 8: torch.int64}[wb]
    as_ints = words.view(ints)
    f64 = torch.float64
    row = {"word_bytes": wb,
           "decode_f64_ms": cuda_ms(torch, lambda: takum_codec.decode(
               words, spec, dtype=f64)),
           "decode_f64_bound_ms": bound(el * (wb + 8), 0)[0],
           "decode_f64_stream_ms": cuda_ms(torch, lambda: as_ints.to(f64)),
           "bound_by": "bytes"}
    if plain:
        row["decode_f64_plain_ms"] = cuda_ms(
            torch, lambda: ref.decode_ref(words, spec, dtype=f64), iters=2,
            warmup=1)
    if n <= 32:
        return row
    row.update(
        decode_ms=cuda_ms(torch, lambda: takum_codec.decode(words, spec)),
        bound_ms=bound(el * (wb + 4), 0)[0],
        decode_stream_ms=cuda_ms(torch, lambda: as_ints.to(torch.float32)),
        encode_ms=cuda_ms(torch, lambda: takum_codec.encode(x, spec)),
        encode_bound_ms=bound(el * (wb + 4), 0)[0],
        encode_stream_ms=cuda_ms(torch, lambda: x.to(ints)))
    fq = {}
    for dtype, ob in ((torch.float32, 4), (torch.bfloat16, 2), (f64, 8)):
        key = str(dtype)[6:]
        fq[f"{key}_ms"] = cuda_ms(torch, lambda: kquant.fake_quant(
            x, spec, dtype=dtype))
        fq[f"{key}_bound_ms"] = bound(el * (4 + ob), 0)[0]
    fq["float64_stream_ms"] = cuda_ms(torch, lambda: x.to(f64))
    if plain:
        row["decode_plain_ms"] = cuda_ms(
            torch, lambda: ref.decode_ref(words, spec), iters=2, warmup=1)
        row["encode_plain_ms"] = cuda_ms(
            torch, lambda: ref.encode_ref(x, spec), iters=2, warmup=1)
        fq["float32_plain_ms"] = cuda_ms(
            torch, lambda: ref.fake_quant_ref(x, spec), iters=2, warmup=1)
        fq["float64_plain_ms"] = cuda_ms(
            torch, lambda: ref.fake_quant_ref(x, spec, f64), iters=2,
            warmup=1)
    row["fake_quant"] = fq
    return row


def codec64_phase(torch, dev):
    """Phase 34: the codec and fake-quant kernels at 33-64 bits (64-bit
    words) and the float64 decode (every storage) against the plain
    codec, every 61st float32 pattern through the encode at n = 64, the
    kernels' times, and the path: each width's decode (f32 and f64),
    encode and fake-quant (f32, bf16, f64) through ``ops``, with the
    launch counters zeroed just before and read just after."""
    from repro_torch import formats
    from repro_torch.kernels import ops, takum_codec
    from repro_torch.kernels import quantize as kquant
    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        torch.cuda.synchronize()
        seconds[part] = time.perf_counter() - t0
        t0 = time.perf_counter()

    checks = {}
    for i, n in enumerate(WIDTHS_64):
        for j, kind in enumerate(CODEC_KINDS):
            checks[f"{kind}{n}"] = wide_codec_check(torch, dev, n, kind,
                                                    3400 + 10 * i + j)
    lap("checks")
    f64 = {f"{kind}{n}": wide_codec_check(torch, dev, n, kind, 3500 + n,
                                          encode=False)
           for n in WIDTHS_F64 for kind in CODEC_KINDS}
    lap("float64_decode")
    sweep = {f"{kind}{n}": encode_sweep(torch, dev, n, kind)
             for n, kind in F64_SWEEP}
    lap("encode_sweep")
    times = {str(n): {kind: wide_times(torch, dev, n, kind, n == 64)
                      for kind in CODEC_KINDS}
             for n in (32,) + WIDTHS_64_TIMED}
    lap("times")
    x = torch.randn(1 << 20, device=dev)
    fns = {"takum_decode": takum_codec.decode,
           "takum_encode": takum_codec.encode,
           "fake_quant": kquant.fake_quant}
    for fn in fns.values():
        fn.launches = 0
    per = {}
    for n in WIDTHS_64 + WIDTHS_F64:
        for kind in CODEC_KINDS:
            before = {k: fn.launches for k, fn in fns.items()}
            spec = formats.resolve(kind, n)
            w = ops.takum_encode(x, spec)
            ops.takum_decode(w, spec, dtype=torch.float64)
            if n > 32:
                ops.takum_decode(w, spec)
            for dtype in ((torch.float32, torch.bfloat16, torch.float64)
                          if n > 32 else (torch.float64,)):
                ops.fake_quant_fused(x, n, fmt=kind, dtype=dtype)
            per[f"{kind}{n}"] = {k: fn.launches - before[k]
                                 for k, fn in fns.items()}
    launches = {k: fn.launches for k, fn in fns.items()}
    check(all(v["takum_decode"] and v["takum_encode"] and v["fake_quant"]
              for v in per.values()), f"phase 34's path launched {per}")
    lap("path")
    return {"checks": checks, "float64_decode": f64, "encode_sweep": sweep,
            "times": times, "launches": launches,
            "launches_per_format": per, "seconds": seconds}


# -- 35-37. training of the served families, other 8-bit weights -----------

# phase 35: (arch, layers trained: None = all, AdamW's lr) at full width,
# 1 x TRAIN_T tokens, FAMILY_TRAIN_STEPS steps. Depths fit one card at
# phase 24's bytes a parameter (f32 parameters, gradients, two AdamW
# moments, the functional update's second copy, activations under remat):
# recurrentgemma two (rec, rec, attn) super-blocks, llama-3.2-vision one
# super-block (its cross block first). At TRAIN_LR the losses of
# starcoder2-15b and llama-3.2-vision-11b rise in four steps (AdamW's first
# step moves every weight by about lr): they train at SLOW_LR, and the
# phase reports their losses at TRAIN_LR beside (``losses_at_train_lr``)
SLOW_LR = 1e-5
TRAIN_FAMILIES = (("minitron-4b", 2, TRAIN_LR),
                  ("starcoder2-15b", 2, SLOW_LR),
                  ("granite-moe-3b-a800m", 8, TRAIN_LR),
                  ("recurrentgemma-2b", 6, TRAIN_LR),
                  ("rwkv6-1.6b", None, TRAIN_LR),
                  ("seamless-m4t-large-v2", None, TRAIN_LR),
                  ("llama-3.2-vision-11b", 5, SLOW_LR))
FAMILY_TRAIN_STEPS = 4
# configs whose one layer does not train on one card at full width: their
# one-layer parameters are counted without memory (FakeTensorMode)
TRAIN_CPU_ONLY = ("nemotron-4-340b", "kimi-k2-1t-a32b")
# phase 36 for rwkv6: its WKV decay is a difference of two cumulative sums
# of log w (RWKV6_ENCODE_INPUT_ATOL), so card and CPU gradients part more
# and AdamW spreads it: measured on an H100 (NVIDIA H100 80GB HBM3, 700 W)
# losses 1.6e-5 apart at the second step, leaves up to 3.5e-4 in relative L2
RWKV6_LOSS_REL = 1e-4
RWKV6_PARAM_REL_L2 = 2e-3
# phase 36: one reduced config a family (and the relu2 / gelu MLPs),
# trained 3 steps on the card and on the CPU
REDUCED_TRAIN_ARCHS = ("minitron-4b", "starcoder2-15b",
                       "granite-moe-3b-a800m", "recurrentgemma-2b",
                       "rwkv6-1.6b", "seamless-m4t-large-v2",
                       "llama-3.2-vision-11b")
# phase 37: the five families beyond dense with each format's weights,
# card against CPU (the KV cache of phases 26 and 29-32)
FAMILY_FMTS = ("lns-takum8", "posit8")
FAMILY_KV = (("granite-moe-3b-a800m", "takum8"),
             ("recurrentgemma-2b", "takum8"), ("rwkv6-1.6b", "takum8"),
             ("seamless-m4t-large-v2", "none"),
             ("llama-3.2-vision-11b", "takum8"))


def one_layer_params(torch, arch):
    """Parameters of one layer of ``arch`` at full width with its
    embeddings, counted under FakeTensorMode (no memory is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves
    with FakeTensorMode():
        p = model.init(torch.Generator(), train_cfg(1, arch), device="cpu")
        return sum(x.numel() for x in tree_leaves(p))


def family_training_phase(torch, dev, bytes_per_param):
    """Phase 35: every served family trained at full width
    (:func:`full_width_training` over ``TRAIN_FAMILIES``); the configs of
    ``TRAIN_CPU_ONLY`` are not run: their one layer's parameters and the
    bytes they would take at ``bytes_per_param`` (phase 24's, this run)."""
    rows = {}
    for arch, layers, lr in TRAIN_FAMILIES:
        rows[arch] = full_width_training(torch, dev, arch, layers,
                                         FAMILY_TRAIN_STEPS, lr)
        if lr != TRAIN_LR:   # why this row trains slower: TRAIN_LR's losses
            probe = full_width_training(torch, dev, arch, layers,
                                        FAMILY_TRAIN_STEPS, TRAIN_LR,
                                        falls=False)
            rows[arch]["losses_at_train_lr"] = [r["loss"]
                                                for r in probe["steps"]]
    not_run = {}
    for arch in TRAIN_CPU_ONLY:
        n = one_layer_params(torch, arch)
        not_run[arch] = {"one_layer_params": n,
                         "one_layer_gb_at_phase24_rate":
                         n * bytes_per_param / 1e9,
                         "card_gb": torch.cuda.get_device_properties(0)
                         .total_memory / 1e9}
    return rows, not_run


def reduced_family_training(torch, dev, arch):
    """Phase 36: phase 25's card-against-CPU check on the reduced
    ``arch`` (f32): 3 AdamW steps of ``make_train_step`` (remat per block,
    no clipping, ``TRAIN_LR``) from the same parameters on the same batches
    (``SyntheticLM(seed=3)``, 4 x 64, seeded media a step) on both:
    losses within ``LOSS_REL``, each parameter leaf within
    ``PARAM_REL_L2`` relative L2 (rwkv6: ``RWKV6_LOSS_REL``,
    ``RWKV6_PARAM_REL_L2``), elementwise differences reported. At phase
    25's lr 1e-3 AdamW's step on gradient elements near 0 (ROADMAP.md
    section 3) put starcoder2's, seamless's and llama-3.2-vision's leaves
    2.8e-5 to 3.7e-5 apart in relative L2 on an H100; at ``TRAIN_LR``,
    2.8e-6 to 3.7e-6."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.models import model
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    from repro_torch.tree import tree_map
    cfg = get_arch(arch).reduced
    cpu_params = model.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    ds = dp.SyntheticLM(cfg.vocab, 64, 4, seed=3)
    batches = []
    for s in range(3):
        b = ds.batch_at(s)
        g = torch.Generator().manual_seed(100 + s)
        if cfg.frontend == "audio":
            b["media"] = torch.randn((4, 16, cfg.d_model), generator=g)
        elif cfg.frontend == "vision":
            b["media"] = torch.randn((4, cfg.n_media_tokens,
                                      cfg.d_media or cfg.d_model),
                                     generator=g)
        batches.append(b)
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=0, schedule="const",
                           clip_norm=1e9)
    step = trainer.make_train_step(cfg, ocfg, RuntimeConfig(remat="block"))
    runs = {}
    for d, p in (("cpu", cpu_params),
                 ("card", tree_map(lambda t: t.to(dev), cpu_params))):
        state, losses = opt.init_state(p), []
        for b in batches:
            p, state, met = step(p, state, b)
            losses.append(float(met["loss"]))
        runs[d] = (p, losses)
    loss_tol, param_tol = ((RWKV6_LOSS_REL, RWKV6_PARAM_REL_L2)
                           if cfg.family == "rwkv6"
                           else (LOSS_REL, PARAM_REL_L2))
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"][1],
                                                  runs["cpu"][1]))
    check(rel <= loss_tol, f"reduced {arch} training: card losses "
          f"{runs['card'][1]} against the CPU's {runs['cpu'][1]}")
    pd = _max_diffs(torch, runs["card"][0], runs["cpu"][0])
    check(pd["max_leaf_rel_l2"] <= param_tol, f"reduced {arch} training: "
          f"card parameters differ from the CPU's by {pd}")
    return {"family": cfg.family, "loss_tol": loss_tol,
            "param_rel_l2_tol": param_tol, "losses_card": runs["card"][1],
            "losses_cpu": runs["cpu"][1], "loss_max_rel": rel, "params": pd,
            "media": list(batches[0]["media"].shape)
            if "media" in batches[0] else None}


def lns_neighbours(torch, pairs):
    """Of (card word, CPU word, spec) triples that differ: how many are
    one word apart (the card's ``logf`` on the other side of an ell_bar
    rounding tie, phase 7's neighbour rule), and the farthest step."""
    from repro_torch.core.bitops import lanes
    near, far = 0, 0
    for own, rec, spec in pairs:
        step = (lanes(own) - lanes(rec)) % (1 << spec.n)
        step = torch.minimum(step, (1 << spec.n) - step)
        near += int((step == 1).sum())
        far = max(far, int(step.max()))
    return near, far


# -- 38. tensor-parallel serving over gloo ranks on the one card ------------

SHARD_TP = 2                      # phase 38's full-width plan
SHARD_NEW = 32                    # its new tokens a request
# the wire hop's shapes: a rank's columns at tp 2 in a decode step (batch
# 4; H*hd/tp = 2560 after attention, d_ff/tp = 8960 after the MLP) and in
# a 256-token prompt chunk, one gather step's columns at full width
# (batch 4, H*hd + d_ff = 23040: the rings' shape) and a 256-row block of
# d_model
HOP_SHAPES = ((4, 2560), (4, 8960), (256, 2560), (256, 8960), (4, 23040),
              (256, 5120))
RING_SHAPE = (4, 23040)
# the wire matmul at the column slices a tp-2 gather plan gives a rank
# (wq 2560, wk/wv 640, wg/w1 8960 columns), a decode step and a prompt
# chunk; wo and w2 stay whole (MM_SHAPES)
SHARD_MM = tuple((m, 5120, n) for m in (4, 256) for n in (2560, 640, 8960))
# phase 38's full-width runs: the collectives' wire format of each
SHARD_RUNS = (("uncompressed", None), ("takum16", "takum16"),
              ("takum8", "takum8"))
HOP_FORMATS = ("takum8", "takum16", "lns-takum8", "posit8")
RING_FORMATS = ("takum16", "takum8", "posit8")
# the reduced cases of repro_torch.serve.shard_selftest run on the card
SHARD_REDUCED = ("tp2", "tp4", "dp2tp2", "psum2", "lns2")


def hop_floats(torch, dev, shape, seed):
    """Seeded f32 values spread over 10^-3..10^3 times a normal draw."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    e = torch.empty(shape, device=dev).uniform_(-3.0, 3.0, generator=g)
    return x * torch.pow(10.0, e)


def wire_hop_check(torch, dev):
    """The ring hop's encode and decode kernels (``collectives.encode_hop``
    and ``wire_roundtrip`` on CUDA tensors) against the plain codec on the
    same card, at ``HOP_SHAPES``: words bit for bit (LNS by phase 7's
    neighbour rule), wire values bit for bit (LNS within 2 ulp of the
    plain decode of the same words), the residual exactly x - wire, and
    two encodes and two decodes for the two calls."""
    from repro_torch import formats
    from repro_torch.core.bitops import lanes
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import ref, takum_codec
    out = {}
    for name in HOP_FORMATS:
        spec = formats.get(name)
        for shape in HOP_SHAPES:
            x = hop_floats(torch, dev, shape, 38)
            enc, dec = takum_codec.encode.launches, takum_codec.decode.launches
            words, wire = coll.encode_hop(x, spec)
            y, res = coll.wire_roundtrip(x, spec)
            launched = [takum_codec.encode.launches - enc,
                        takum_codec.decode.launches - dec]
            check(launched == [2, 2], f"phase 38: {name}'s hops launched "
                  f"{launched} encodes and decodes, not [2, 2]")
            gw = lanes(words).reshape(-1)
            pw = lanes(ref.encode_ref(x, spec)).reshape(-1)
            plain = ref.decode_ref(words, spec)
            row = {"shape": list(shape)}
            if spec.kind == "lns":
                lo, hi = lns_encode_bounds(torch, x.reshape(-1), spec.n)
                check(bool(lns_encode_ok(gw, pw, lo, hi, spec.n).all()),
                      f"phase 38: a {name} hop word other than the plain "
                      "version's or, at a logf tie, its neighbour")
                share = float((gw != pw).double().mean())
                check(share <= LNS_NEIGHBOUR_SHARE, f"phase 38: {name} "
                      f"neighbour share {share}")
                u = int(ulps(torch, wire.reshape(-1),
                             plain.reshape(-1)).max())
                check(u <= 2, f"phase 38: {name} wire {u} ulp off")
                row.update(encode_neighbour_share=share, wire_max_ulps=u)
            else:
                check(torch.equal(gw, pw), f"phase 38: {name} hop words "
                      "differ from the plain codec's")
                check(torch.equal(wire.view(torch.int32),
                                  plain.view(torch.int32)),
                      f"phase 38: {name} wire values differ from the plain "
                      "decode")
                row.update(words_bit_exact=True, wire_bit_exact=True)
            check(torch.equal(y.view(torch.int32), wire.view(torch.int32))
                  and torch.equal(res.view(torch.int32),
                                  (x - wire).view(torch.int32)),
                  f"phase 38: {name} wire_roundtrip is not (wire, x - wire)")
            out[f"{name} {shape[0]}x{shape[1]}"] = row
    return out


def ring_check(torch, rank, world):
    """The compressed ``ring_all_reduce`` of this rank's seeded
    ``RING_SHAPE`` values over the job's ranks, on the card and on the
    CPU: outputs and residuals bit for bit, a format each."""
    import torch.distributed as dist
    from repro_torch import formats
    from repro_torch.dist import collectives as coll
    from repro_torch.serve.shard import ShardPlan
    dev = ShardPlan().device_for()      # cuda:(rank % device_count)
    x = hop_floats(torch, dev, RING_SHAPE, 100 + rank).reshape(-1)
    out = {}
    for name in RING_FORMATS:
        spec = formats.get(name)
        y, r = coll.ring_all_reduce(x, dist.group.WORLD, world, spec=spec)
        yc, rc = coll.ring_all_reduce(x.cpu(), dist.group.WORLD, world,
                                      spec=spec)
        same = (torch.equal(y.cpu().view(torch.int32), yc.view(torch.int32))
                and torch.equal(r.cpu().view(torch.int32),
                                rc.view(torch.int32)))
        check(same, f"phase 38: {name} ring_all_reduce at world {world} "
              "differs between the card and the CPU")
        out[name] = "bit-equal"
    return out


def full_width_rank(torch):
    """This rank's share of phi3-medium-14b at full width under
    ``ShardPlan(tp=SHARD_TP)``: every layer made whole from the seeded
    generator (as :func:`full_width_params` makes it for one card),
    wired and sliced before the next, then phase 5's requests with
    ``SHARD_NEW`` new tokens, eagerly, once for each of ``SHARD_RUNS``:
    tokens, every step's two best logits (:func:`top2_recorder`) and,
    compressed, the residual norms of the last step."""
    from repro_torch.dist.tp import residual_norms
    from repro_torch.serve.shard import ShardPlan, place_params
    plan = ShardPlan(tp=SHARD_TP)
    dev = plan.device_for()
    torch.cuda.set_device(dev)
    cfg = full_width_cfg("takum8")
    mesh = plan.build_mesh()
    torch.cuda.reset_peak_memory_stats()
    params, weights_s = full_width_params(
        torch, dev, cfg, "takum8",
        place=lambda layer: place_params(layer, plan, mesh, cfg))
    out = {"weights_s": round(weights_s, 2),
           "peak_gb_setup": round(torch.cuda.max_memory_allocated() / 1e9,
                                  2)}

    for label, comp in SHARD_RUNS:
        tops = {}

        def inspect(eng, sched, outs, tops=tops, comp=comp):
            res = {"tokens": outs,
                   "tops": [[r, i, v, t] for (r, i), (v, t) in tops.items()]}
            if comp is not None:
                n = list(residual_norms(sched.pool.cache).values())
                check(bool(n) and all(math.isfinite(v) for v in n),
                      f"phase 38: {comp} residual norms not finite: {n[:4]}")
                res.update(residual_sites=len(n), residual_norm_min=min(n),
                           residual_norm_max=max(n))
            return res

        out[label] = serve_full_width(
            torch, dev, wfmt="takum8", kv="takum8", plens=PHASE5_PLENS,
            max_new=SHARD_NEW, max_len=1280, wrappers=kernel_wrappers(),
            eager=True, params=params, cfg=cfg,
            shard=ShardPlan(tp=SHARD_TP, compress=comp),
            prepare=top2_recorder(torch, tops), inspect=inspect)
    return out


def shard_rank(rank, world, tmp):
    """One rank of phase 38's job (``torch.multiprocessing.spawn``'s
    target; every rank on the one card, the rings over gloo): the ring
    check at ``world`` ranks, then ranks below ``SHARD_TP`` in a group of
    their own: the ring check again and :func:`full_width_rank`. Writes
    ``tmp/rank_<rank>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import RANK_TIMEOUT
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg_all",
                            world_size=world, rank=rank,
                            timeout=RANK_TIMEOUT)
    try:
        res[f"ring_world{world}"] = ring_check(torch, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank < SHARD_TP:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg_tp",
                                world_size=SHARD_TP, rank=rank,
                                timeout=RANK_TIMEOUT)
        try:
            res[f"ring_world{SHARD_TP}"] = ring_check(torch, rank, SHARD_TP)
            res.update(full_width_rank(torch))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    (Path(tmp) / f"rank_{rank}.json").write_text(json.dumps(res))


def top2_recorder(torch, tops):
    """A ``prepare`` hook for :func:`serve_full_width` that keeps, for
    every generated token, the two best logits of the step that chose it
    and their ids: ``tops[(rid, i)] = (values, ids)`` (the last prompt
    chunk for i = 0, decode steps after)."""
    def prepare(eng, sched, prompts):
        chunk, step = eng.prefill_chunk, sched.step

        def prefill(tokens, cache, *, pos, last_idx):
            row, cache = chunk(tokens, cache, pos=pos, last_idx=last_idx)
            for s in sched._slots:
                if (s is not None and s.state == "prefilling"
                        and s._cursor == pos
                        and pos + last_idx + 1 == len(s.prefill_tokens)):
                    t = torch.topk(row[0].float(), 2)
                    tops[(s.rid, 0)] = (t.values.tolist(), t.indices.tolist())
            return row, cache

        def decode(tok, pos):
            live = [(i, s.rid, len(s.generated))
                    for i, s in enumerate(sched._slots)
                    if s is not None and s.state == "active"]
            logits, head = step(tok, pos)
            t = torch.topk(logits.float(), 2, dim=-1)
            vals, ids = t.values.cpu(), t.indices.cpu()
            for i, rid, n in live:
                tops[(rid, n)] = (vals[i].tolist(), ids[i].tolist())
            return logits, head

        eng.prefill_chunk = prefill
        sched.step = decode
    return prepare


def tie_or_equal(want, got, plen, tops, rid):
    """"equal", or "tie at i (gap g)" where ``got`` leaves ``want`` at
    generated token i for the other of ``want``'s run's two best logits,
    within ``TIE_REL`` of each other (phase 20's rule; bf16 logits tie
    exactly too, in either order), or None."""
    if got == want:
        return "equal"
    i = next(i for i, (a, b) in enumerate(zip(want[plen:], got[plen:]))
             if a != b)
    v, t = tops[(rid, i)]
    if (v[0] - v[1] <= TIE_REL * abs(v[0])
            and {got[plen + i], want[plen + i]} == set(t)):
        return f"tie at {i} (gap {(v[0] - v[1]) / abs(v[0]):.2e})"
    return None


def top2_drift(tops, other, rid):
    """The largest difference of the best logit between two runs' steps of
    request ``rid`` while they chose the same token, over its value, and
    the step of the first choice that differs (or None)."""
    drift, i = 0.0, 0
    while (rid, i) in tops and (rid, i) in other:
        (v, t), (w, u) = tops[(rid, i)], other[(rid, i)]
        if t[0] != u[0]:
            return drift, i
        drift = max(drift, abs(v[0] - w[0]) / max(abs(v[0]), 1e-30))
        i += 1
    return drift, None


def reduced_shard_check(torch):
    """The reduced cases (``SHARD_REDUCED`` of ``shard_selftest``) in a
    4-rank gloo job on the card against the card's single-rank engine,
    whose greedy tokens must equal the CPU's."""
    import tempfile
    from repro_torch.serve import shard_selftest as sst
    weights = sst.make_weights()
    with tempfile.TemporaryDirectory() as tmp:
        results = sst.run_job(4, weights, tmp, device="cuda",
                              names=SHARD_REDUCED)
    card = sst.single_rank(weights, SHARD_REDUCED, "cuda")
    cpu = sst.single_rank(weights, SHARD_REDUCED, "cpu")
    try:
        lines = sst.check(results, card)
    except AssertionError as e:
        fail(f"phase 38 (reduced, card): {e}")
    for key in ("greedy", "takum8", "lns-takum8"):
        if key in card:
            check(card[key] == cpu[key], f"phase 38: the reduced {key} "
                  "tokens differ between the card and the CPU")
    return {"cases": [ln.lstrip("# ") for ln in lines],
            "card_vs_cpu": "greedy tokens equal (float, lns-takum8 wire)"}


class SplitCols:
    """A wire matrix multiplied as ``parts`` column blocks, each through
    its own wire matmul, the products concatenated: one card computing
    the column slices a gather-mode plan of ``parts`` ranks gives each
    rank, at the ranks' shapes (the wire matmul's K split depends on N,
    so its sums run in another order than the whole matrix's)."""

    def __init__(self, w, parts):
        from repro_torch.kernels.ops import WireMatrix
        n = w.shape[1] // parts
        self.shape = w.shape
        self.blocks = [WireMatrix(w.words[:, i * n:(i + 1) * n].contiguous(),
                                  fmt=w.spec) for i in range(parts)]

    def __rmatmul__(self, x):
        import torch
        return torch.cat([x @ b for b in self.blocks], dim=-1)


def split_columns(params, parts):
    """``params`` with every projection a gather-mode plan column-shards
    (wq, wk, wv, wg, w1) made a :class:`SplitCols`, in place."""
    for layer in params["layers"]:
        for block, names in (("attn", ("wq", "wk", "wv")),
                             ("mlp", ("wg", "w1"))):
            for name in names:
                layer[block][name] = SplitCols(layer[block][name], parts)
    return params


def shard_phase(torch, dev, card):
    """Phase 38: the wire hop's kernels, and the wire matmul, both
    attention kernels and the append at a rank's shapes, against their
    plain versions; the rings on the card, the reduced cases, and
    phi3-medium-14b at full width over two ranks on the one card (gloo),
    held against one rank on the same card."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch import formats
    from repro_torch.serve.shard import ShardPlan
    t0 = time.perf_counter()
    out = {"card": card, "transport": "gloo, CUDA payloads staged through "
           "host memory (collectives.transport): several ranks on one card "
           "cannot share an NCCL communicator; the NCCL path is not run"}
    out["wire_hop"] = wire_hop_check(torch, dev)
    cfg = full_width_cfg("takum8")
    t8 = formats.get("takum8")
    out["wire_matmul_rank_columns"] = [
        wire_matmul_check(torch, dev, t8, m, k, n) for m, k, n in SHARD_MM]
    out["attention_rank_heads"] = hd_attention_check(
        torch, dev, ShardPlan(tp=SHARD_TP).local_cfg(cfg), seed=38)
    gc.collect()
    torch.cuda.empty_cache()
    # one rank on this card on the same weights, eagerly, the top-2 logits
    # of every step kept: the whole matrices, then the ranks' column
    # slices (SplitCols), whose arithmetic the ranks repeat bit for bit
    params, weights_s = full_width_params(torch, dev, cfg, "takum8")
    tops, split_tops = {}, {}
    runs = {}
    for label, rec in (("single", tops), ("split", split_tops)):
        if label == "split":
            split_columns(params, SHARD_TP)
        runs[label] = serve_full_width(
            torch, dev, wfmt="takum8", kv="takum8", plens=PHASE5_PLENS,
            max_new=SHARD_NEW, max_len=1280, wrappers=kernel_wrappers(),
            eager=True, params=params, cfg=cfg,
            prepare=top2_recorder(torch, rec),
            inspect=lambda eng, sched, outs: {"tokens": outs})
    single, split = runs["single"], runs["split"]
    single["weights_s"] = round(weights_s, 2)
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(shard_rank, args=(4, tmp), nprocs=4, join=True)
        ranks = [json.loads((Path(tmp) / f"rank_{r}.json").read_text())
                 for r in range(4)]
    out["rings"] = {k: v for k, v in ranks[0].items()
                    if k.startswith("ring")}
    out["reduced"] = reduced_shard_check(torch)
    census = {c: ShardPlan(tp=SHARD_TP, compress=c).step_interconnect_bytes(
        cfg, 4) for _, c in SHARD_RUNS}

    def against_single(toks):
        """Each request's tokens against one card's whole matrices: equal,
        parting at a tie (phase 20's rule), or None."""
        return [tie_or_equal(w, g, len(w) - SHARD_NEW, tops, i)
                for i, (w, g) in enumerate(zip(single["tokens"], toks))]

    full = {"single_rank": {k: single[k] for k in (
        "decode_ms_per_step", "ttft_s", "peak_gb", "weights_s")}}
    # the column slices on one card against the whole matrices: the
    # wire matmul's order of summation alone, so the tokens part only
    # where the two best logits tie
    verdicts = against_single(split["tokens"])
    check(all(v is not None for v in verdicts),
          f"phase 38: one card's column slices part from its whole "
          f"matrices where the logits do not tie: {verdicts}")
    full["single_rank_column_slices"] = {
        "decode_ms_per_step": split["decode_ms_per_step"],
        "tokens_vs_single_rank": verdicts,
        "top_logit_drift": [top2_drift(tops, split_tops, i)
                            for i in range(len(PHASE5_PLENS))]}
    served = {}
    for label, comp in SHARD_RUNS:
        check(ranks[0][label]["tokens"] == ranks[1][label]["tokens"],
              f"phase 38: the two ranks served different tokens ({label})")
        per_rank, sent = [], 0
        for r in range(SHARD_TP):
            s = ranks[r][label]
            toks = s.pop("tokens")
            own = {(a, b): (v, t) for a, b, v, t in s.pop("tops")}
            served.setdefault(label, (toks, own))
            verdicts = against_single(toks)
            if comp is None:
                # the sharded step repeats one card's arithmetic on the
                # same column slices: tokens and every step's top-2
                # logits bit for bit
                check(toks == split["tokens"] and own == split_tops,
                      f"phase 38: rank {r}'s tokens or top-2 logits differ "
                      "from one card's on the same column slices")
                check(all(v is not None for v in verdicts),
                      f"phase 38: rank {r}'s tokens part from one card's "
                      f"whole matrices where the logits do not tie: "
                      f"{verdicts}")
                s["tokens_vs_single_rank_column_slices"] = "bit-equal"
            elif comp == "takum16":
                # takum16 holds this run's bf16 activations exactly (its
                # residuals are 0): the gathered wire values are the
                # uncompressed run's, and so is every product after them
                check(toks == served["uncompressed"][0]
                      and own == served["uncompressed"][1],
                      f"phase 38: rank {r}'s takum16 tokens or top-2 "
                      "logits differ from the uncompressed run's")
                s["tokens_vs_uncompressed"] = "bit-equal"
            else:
                # a lossy wire: error feedback must be carrying something
                check(s["residual_norm_max"] > 0.0, f"phase 38: rank {r}'s "
                      f"{comp} residuals are all 0: no error feedback")
                ref_toks, ref_tops = served["uncompressed"]
                s["tokens_vs_uncompressed"] = [
                    "equal" if a == b else next(
                        f"parts at {i}" for i, (x, y) in enumerate(
                            zip(a[len(a) - SHARD_NEW:],
                                b[len(b) - SHARD_NEW:])) if x != y)
                    for a, b in zip(ref_toks, toks)]
                s["top_logit_drift_vs_uncompressed"] = [
                    top2_drift(ref_tops, own, i)
                    for i in range(len(PHASE5_PLENS))]
            s["top_logit_drift"] = [top2_drift(tops, own, i)
                                    for i in range(len(PHASE5_PLENS))]
            # against the whole matrices: equal or parting at a tie
            # (phase 20's rule; held for the exact runs above), or None
            s["tokens_vs_single_rank"] = verdicts
            hops = s.pop("ring_hops")
            steps = max(s["decode_steps"], 1)
            n_fwd = s["decode_steps"] + s["prefill_chunks"]
            dec = hops["decode"]
            sent += dec["bytes_sent"] / steps
            s.update(bytes_sent_per_decode_step=dec["bytes_sent"] / steps,
                     hops_per_decode_step=dec["hops"] / steps,
                     staged_hops=dec["staged"] + hops["prefill"]["staged"],
                     transport_share_of_step=round(
                         dec["seconds"] / max(s["decode_s"], 1e-9), 4),
                     peak_gb=max(s["peak_gb"], ranks[r]["peak_gb_setup"]),
                     weights_s=ranks[r]["weights_s"])
            launches = s["launches"]
            seams = 2 * cfg.n_layers * n_fwd
            if comp is None:
                check(launches["takum_encode"] == 0
                      and launches["takum_decode"] == 0,
                      "phase 38: the uncompressed seams launched the codec")
            else:
                check(launches["takum_encode"] == seams
                      and launches["takum_decode"] == SHARD_TP * seams,
                      f"phase 38: {launches['takum_encode']} encodes and "
                      f"{launches['takum_decode']} decodes for {seams} "
                      f"compressed seams (one encode and {SHARD_TP} "
                      "decodes a seam)")
            for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
                check(launches[k] > 0, f"phase 38: rank {r} launched no {k}")
            per_rank.append(s)
        if comp is not None:
            # a compressed hop moves n/8 bytes an element, as counted
            check(sent == census[comp], f"phase 38: {comp} ranks sent "
                  f"{sent} bytes a decode step, the census {census[comp]}")
        full[label] = {"ranks": per_rank,
                       "bytes_sent_per_decode_step_all_ranks": sent,
                       "step_interconnect_bytes": census[comp]}
    out["full_width"] = full
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


# -- 39. manual data-parallel training over gloo ranks on the one card ------

DP_RANKS = 2                      # phase 39's full-width ranks (data 2)
DP_STEPS = 3
# phase 39's full-width runs: (label, gradient compression of the data ring)
DP_RUNS = (("data2", None), ("data2_takum16", "takum16"))
# the reduced cases of repro_torch.train.dp_selftest on 4 ranks, the card's
# job against the CPU's: the pod ring with error feedback (pod 2 x data 2,
# and pod 2 x data 1: the pod run phase 39 cannot hold at full width on
# one card), and uncompressed data 2
DP_REDUCED = ("pod2_data2_takum16", "data2", "pod2_takum16")
# the codec on a gradient chunk: the formats of a compressed hop, as the
# QuantSpecs the step takes
DP_CODEC = ("takum16", "takum8")


def grad_floats(torch, dev, n, seed):
    """``n`` seeded gradient-like f32 values: normals times 10^-7..10^0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=g, device=dev)
    x *= torch.pow(10.0, torch.empty(n, device=dev).uniform_(-7.0, 0.0,
                                                             generator=g))
    return x


def grad_chunk_check(torch, dev, n):
    """The compressed hop's codec kernels on a gradient chunk of ``n``
    elements (a rank's ``G/2`` at full width): ``collectives.encode_hop``
    (one encode, one decode: the sender's words and its wire values) and
    ``decode_hop`` (the receiver's decode) against the plain codec a block
    at a time, words and values bit for bit; times at this size beside the
    byte bound and the plain pass."""
    from repro_torch import formats
    from repro_torch.core.bitops import lanes
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels import ref, takum_codec
    from repro_torch.train.trainer import grad_spec_from_quant
    x = grad_floats(torch, dev, n, 39)
    blk = 1 << 24
    out = {"elements": n}
    for name in DP_CODEC:
        spec = grad_spec_from_quant(name)
        fmt = formats.resolve("linear", spec.n)
        enc, dec = takum_codec.encode.launches, takum_codec.decode.launches
        words, wire = coll.encode_hop(x, spec)
        got = coll.decode_hop(words, spec, torch.float32)
        launched = [takum_codec.encode.launches - enc,
                    takum_codec.decode.launches - dec]
        check(launched == [1, 2], f"phase 39: a {name} hop of {n} elements "
              f"launched {launched} encodes and decodes, not [1, 2]")
        check(torch.equal(got.view(torch.int32), wire.view(torch.int32)),
              f"phase 39: the {name} receiver's values differ from the "
              "sender's")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for lo in range(0, n, blk):
            pw = ref.encode_ref(x[lo:lo + blk], fmt)
            check(torch.equal(lanes(words[lo:lo + blk]), lanes(pw)),
                  f"phase 39: {name} words of the chunk differ from the "
                  f"plain codec's at block {lo // blk}")
            pv = ref.decode_ref(pw, fmt)
            check(torch.equal(wire[lo:lo + blk].view(torch.int32),
                              pv.view(torch.int32)),
                  f"phase 39: {name} values of the chunk differ from the "
                  f"plain decode at block {lo // blk}")
        t1.record()
        torch.cuda.synchronize()
        plain_pass = t0.elapsed_time(t1)
        wb = fmt.bytes_per_elem()
        enc_ms = cuda_ms(torch, lambda: takum_codec.encode(x, fmt), 5, 1)
        dec_ms = cuda_ms(torch, lambda: takum_codec.decode(words, fmt), 5, 1)
        out[name] = {
            "words_bit_exact": True, "values_bit_exact": True,
            "encode_ms": enc_ms, "decode_ms": dec_ms,
            "encode_bound_ms": bound(n * (4 + wb), 0)[0],
            "decode_bound_ms": bound(n * (wb + 4), 0)[0],
            "plain_encode_and_decode_pass_ms": plain_pass}
        del words, wire, got
    del x
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_one_card(torch, dev, cfg, ocfg, batches, microbatch=0, keep=()):
    """``make_train_step`` on one rank over the whole global batches
    (``microbatch`` 2: a backward a row, the two gradients summed, as two
    data-parallel ranks do): (losses, grad norms, the parameters after
    the steps ``keep`` in host memory by step, peak_gb)."""
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.models import model
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    from repro_torch.tree import tree_map
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    state = opt.init_state(params)
    step = trainer.make_train_step(cfg, ocfg, RuntimeConfig(
        remat="block", microbatch=microbatch))
    losses, norms, host = [], [], {}
    for i, b in enumerate(batches):
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        if i in keep:
            host[i] = tree_map(lambda t: t.cpu(), params)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms, host, peak


def leaf_rel_l2_on(torch, dev, tree, ref) -> float:
    """The largest relative L2 distance between ``tree``'s leaves (on the
    card) and ``ref``'s (host memory), a leaf on the card at a time."""
    from repro_torch.tree import tree_leaves
    rel = 0.0
    for a, b in zip(tree_leaves(tree), tree_leaves(ref)):
        b = b.to(dev)
        rel = max(rel, float(torch.linalg.vector_norm((a - b).double())
                             / torch.linalg.vector_norm(b.double())))
    return rel


def dp_rank(rank, world, tmp):
    """One rank of phase 39's job (``torch.multiprocessing.spawn``'s
    target; every rank on the one card, the rings over gloo): rank 0 first
    runs one card's ``make_train_step`` on the whole batch, as it is and
    with microbatch 2, while the other ranks wait; then every rank runs
    each of ``DP_RUNS`` from the seeded full-width weights through
    ``make_train_step_manual``, on phase 24's repeated ``SyntheticLM``
    batch (here ``world`` x ``TRAIN_T`` tokens). Writes
    ``tmp/dp_<rank>.json``."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.launch.mesh import RANK_TIMEOUT, make_mesh
    from repro_torch.models import model
    from repro_torch.optim import adamw as opt
    from repro_torch.train import trainer
    from repro_torch.train.dp_selftest import fingerprint
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    cfg = train_cfg(TRAIN_LAYERS)
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=0, schedule="const")
    batches = [dp.SyntheticLM(cfg.vocab, TRAIN_T, world,
                              seed=0).batch_at(0)] * DP_STEPS
    res = {"rank": rank}
    refs = {}
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg_dp",
                            world_size=world, rank=rank,
                            timeout=RANK_TIMEOUT)
    try:
        last = DP_STEPS - 1
        for key, micro, keep in (("one_card", 0, (last,)),
                                 ("one_card_microbatch2", world,
                                  range(DP_STEPS))):
            if rank == 0:
                t0 = time.perf_counter()
                losses, norms, refs[key], peak = dp_one_card(
                    torch, dev, cfg, ocfg, batches, micro, keep)
                res[key] = {"losses": losses, "grad_norms": norms,
                            "peak_gb": peak,
                            "seconds": time.perf_counter() - t0}
        dist.barrier()
        mesh = make_mesh((world, 1), ("data", "model"))
        wrappers = kernel_wrappers()
        for label, comp in DP_RUNS:
            torch.cuda.reset_peak_memory_stats()
            params = model.init(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
            state, spec = trainer.init_flat_state(params, world)
            g = sum(spec[1]) + spec[4]
            step = trainer.make_train_step_manual(
                cfg, ocfg, RuntimeConfig(remat="block"), mesh, spec,
                compress=trainer.grad_spec_from_quant(comp or "none"))
            for w in wrappers.values():
                w.launches = 0
            rows, run = [], {}
            start_gb = torch.cuda.memory_allocated() / 1e9
            for s, batch in enumerate(batches):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                h0, t0 = ring_hops(), time.perf_counter()
                params, state, met = step(params, state, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                hops, sent, staged, secs = ring_hops(h0)
                if label == "data2":
                    # against one card's parameters after the same step
                    for key, ref in refs.items():
                        if s in ref:
                            run.setdefault(f"leaf_rel_l2_vs_{key}", []).append(
                                leaf_rel_l2_on(torch, dev, params,
                                               ref.pop(s)))
                rows.append({"step": s, "loss": float(met["loss"]),
                             "grad_norm": float(met["grad_norm"]),
                             "step_ms": 1e3 * dt, "hops": hops,
                             "bytes_sent": sent, "staged": staged,
                             "transport_ms": 1e3 * secs,
                             "transport_share": secs / dt,
                             "peak_gb": torch.cuda.max_memory_allocated()
                             / 1e9,
                             "fingerprint": fingerprint(params)})
            run.update({"steps": rows,
                   "launches": {k: w.launches for k, w in wrappers.items()},
                   "allocated_gb_at_start": start_gb,
                   "peak_gb": max(r["peak_gb"] for r in rows),
                   "flat_size": g,
                   "census": trainer.step_interconnect_bytes(
                       g, world, 1, trainer.grad_spec_from_quant(
                           comp or "none"))})
            refs.clear()
            res[label] = run
            del params, state, step
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    (Path(tmp) / f"dp_{rank}.json").write_text(json.dumps(res))


def dp_reduced_check(torch):
    """The reduced cases (``DP_REDUCED``) in a 4-rank gloo job on the card
    against the same job on the CPU: ``dp_selftest.check`` on the card's
    (ranks bit-equal, bytes the census, data 2 against one rank on the
    card, the pod runs' error feedback finite and not all zero) and
    ``dp_selftest.against`` the CPU's, phase 36's rule: losses within
    1e-5 and each leaf within 1e-5 relative L2, the takum16 runs too."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.train import dp_selftest as dst
    params = dst.make_params()

    def job(d):
        with tempfile.TemporaryDirectory() as tmp:
            return dst.run_job(4, {"params": params}, tmp, device=d,
                               names=DP_REDUCED)

    # the card's job and the CPU's at once: their ranks share nothing
    with ThreadPoolExecutor(2) as pool:
        got = dict(zip(("cuda", "cpu"), pool.map(job, ("cuda", "cpu"))))
    try:
        lines = dst.check(got["cuda"], dst.one_rank(params, "cuda"))
        versus = dst.against(got["cuda"], got["cpu"])
    except AssertionError as e:
        fail(f"phase 39 (reduced, card against CPU): {e}")
    return {"cases": [ln.lstrip("# ") for ln in lines],
            "card_vs_cpu": versus}


def dp_phase(torch, dev, card, train):
    """Phase 39: the codec kernels on a gradient chunk of the full-width
    run's size; phi3-medium-14b at full width (``TRAIN_LAYERS`` of 40
    layers) trained by the manual ZeRO-1 step over ``DP_RANKS`` rank
    processes on the one card (gloo, CUDA payloads staged through host
    memory), uncompressed against one card's ``make_train_step`` and with
    takum16 on the data ring; the reduced pod cases card against CPU."""
    import tempfile
    import torch.multiprocessing as mp
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import model
    from repro_torch.optim import adamw as opt
    t0 = time.perf_counter()
    cfg = train_cfg(TRAIN_LAYERS)
    full = train_cfg(None)
    with FakeTensorMode():      # the flat vector's size, no memory
        spec = opt.flat_spec(model.init(torch.Generator().manual_seed(0),
                                        cfg, device="cpu"), DP_RANKS)
    g = sum(spec[1]) + spec[4]
    out = {"card": card, "arch": cfg.name, "layers": cfg.n_layers,
           "reduced": {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"},
           "flat_size": g, "chunk": g // DP_RANKS,
           "batch_per_rank": [1, TRAIN_T], "steps": DP_STEPS,
           "optimizer": f"AdamW lr {TRAIN_LR:g} const, clip 1.0",
           "transport": "gloo, CUDA payloads staged through host memory "
                        "(collectives.transport): ranks of one card cannot "
                        "share an NCCL communicator; the NCCL path is not "
                        "run"}
    out["grad_chunk"] = grad_chunk_check(torch, dev, g // DP_RANKS)
    out["seconds_grad_chunk"] = round(time.perf_counter() - t0, 1)
    gc.collect()
    torch.cuda.empty_cache()
    out["parent_reserved_gb_at_spawn"] = torch.cuda.memory_reserved() / 1e9
    t_ranks = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(dp_rank, args=(DP_RANKS, tmp), nprocs=DP_RANKS, join=True)
        ranks = [json.loads((Path(tmp) / f"dp_{r}.json").read_text())
                 for r in range(DP_RANKS)]
    out["seconds_ranks"] = round(time.perf_counter() - t_ranks, 1)
    one, micro = ranks[0]["one_card"], ranks[0]["one_card_microbatch2"]
    out["one_card"], out["one_card_microbatch2"] = one, micro
    for label, comp in DP_RUNS:
        runs = [r[label] for r in ranks]
        for r, run in enumerate(runs):
            check([s["fingerprint"] for s in run["steps"]]
                  == [s["fingerprint"] for s in runs[0]["steps"]],
                  f"phase 39: rank {r}'s {label} parameters differ from "
                  "rank 0's")
            check(all(s["bytes_sent"] == run["census"]
                      for s in run["steps"]),
                  f"phase 39: rank {r} sent "
                  f"{[s['bytes_sent'] for s in run['steps']]} bytes a "
                  f"{label} step, the census {run['census']}")
            codec = (run["launches"]["takum_encode"],
                     run["launches"]["takum_decode"])
            want = (0, 0) if comp is None else (DP_STEPS, DP_STEPS)
            check(codec == want, f"phase 39: rank {r}'s {label} run "
                  f"launched {codec} encodes and decodes, not {want}")
        losses = [s["loss"] for s in runs[0]["steps"]]
        check(all(math.isfinite(x) for x in losses),
              f"phase 39: {label} losses {losses}")
        steady = [s for run in runs for s in run["steps"][1:]]
        row = {"losses": losses,
               "grad_norms": [s["grad_norm"] for s in runs[0]["steps"]],
               "step_ms_per_rank": [[s["step_ms"] for s in run["steps"]]
                                    for run in runs],
               "step_ms_steady_mean": sum(s["step_ms"] for s in steady)
               / len(steady),
               "transport_share_steady_mean": sum(
                   s["transport_share"] for s in steady) / len(steady),
               "hops_per_step": runs[0]["steps"][0]["hops"],
               "bytes_sent_per_rank_step": runs[0]["steps"][0]["bytes_sent"],
               "census": runs[0]["census"],
               "peak_gb_per_rank": [run["peak_gb"] for run in runs],
               "peak_gb_one_device_phase24": train["peak_gb"],
               "launches": {k: sum(run["launches"][k] for run in runs)
                            for k in ("takum_encode", "takum_decode")},
               "ranks_bit_equal": "every step (fingerprints)"}
        if comp is None:
            # one card's step on the same batch with microbatch 2 runs the
            # ranks' arithmetic (a backward a row, the two gradients
            # summed; only the norm's sum runs in another order, so the
            # clip scale may differ in its last bit): its first update is
            # held at phase 25's tolerances, and the losses before and
            # after it. Later steps are reported: a bit of difference in
            # the parameters flips bf16 roundings of the next forward,
            # whose gradients then differ where they are small, and AdamW
            # gives those elements O(lr) steps either way. The whole batch
            # in one backward (other GEMM shapes) is reported beside it.
            for key, ref in (("one_card_microbatch2", micro),
                             ("one_card", one)):
                row[f"vs_{key}"] = {
                    "losses": ref["losses"],
                    "loss_rel": [abs(a - b) / abs(b)
                                 for a, b in zip(losses, ref["losses"])],
                    "leaf_rel_l2_after_steps": runs[0][
                        f"leaf_rel_l2_vs_{key}"]}
            held = row["vs_one_card_microbatch2"]
            check(max(held["loss_rel"][:2]) <= LOSS_REL
                  and held["leaf_rel_l2_after_steps"][0] <= PARAM_REL_L2,
                  f"phase 39: data 2 against one card (microbatch 2): "
                  f"{held}")
        else:
            base = out["data2"]["losses"]
            row["loss_rel_vs_uncompressed"] = [abs(a - b) / abs(b)
                                               for a, b in zip(losses, base)]
        out[label] = row
    t_red = time.perf_counter()
    out["reduced_config_runs"] = dp_reduced_check(torch)
    out["seconds_reduced"] = round(time.perf_counter() - t_red, 1)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


# phase 40: the launch-plan sweeps (op, format, [M, K, N]) and the dry
# run's cell held against the card (phi3-medium-14b at full width, a
# decode step of batch 4 over a 2048-token takum8 cache, takum8 wire
# weights, DRY_LAYERS of its 40 layers)
SWEEPS = (("qmatmul", "takum8", (4, 5120, 17920)),
          ("qmatmul", "takum8", (256, 5120, 17920)),
          ("lns_qmatmul", "lns-takum8", (256, 5120, 17920)))
DRY_LAYERS = 8
DRY_OVERRIDES = {"n_layers": DRY_LAYERS, "global_batch": 4, "seq_len": 2048,
                 "kv_quant": "takum8", "weight_wire": "takum8"}
# the traced peak (live fake storages) beside the allocator's: the trace
# holds no kernel workspace (the decode wire matmul's K-split sums, 16 x
# 4 x 17920 f32 = 4.6 MB at most), none of the wrappers' casts and no
# 512-byte rounding of the caching allocator, so the card's peak may
# exceed it by a few MB (measured: 2,060,688,384 on the card against
# 2,057,832,464 traced, a gap of 2.86 MB); the bound is that workspace
# with room to spare, far below a lost layer's temporaries
DRY_PEAK_ABS = 16 << 20
DRY_PEAK_REL = 0.01


def lns_plan_check(torch, dev, m, k, n):
    """The LNS matmul (linear) at [m, k] x [k, n] on seeded lns-takum8
    operands, called without a plan (the resolved one), against its
    plain version: phase 8's worst-case f32 bound and statistical limit."""
    from repro_torch import formats
    from repro_torch.kernels import lns_matmul as klns
    from repro_torch.kernels import ref, takum_codec
    spec = formats.get("lns-takum8")
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = takum_codec.encode(torch.randn((m, k), generator=g, device=dev), spec)
    w = takum_codec.encode(torch.randn((k, n), generator=g, device=dev)
                           / k ** 0.5, spec)
    got = klns.lns_matmul(x, w, spec)
    want = ref.lns_matmul_plain(x, w, spec)
    xd, wd = ref.decode_ref(x, spec), ref.decode_ref(w, spec)
    tol = (2 * k + 4) * U32 * (xd.abs() @ wd.abs())
    stat = C_STAT * k ** 0.5 * U32 * ((xd * xd) @ (wd * wd)).sqrt()
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()) and bool((err <= tol).all()),
          f"phase 40: lns_matmul {m}x{k}x{n} with the swept plan: error "
          "over the f32 bound")
    r = float((err / stat).max())
    check(r <= 1.0, f"phase 40: lns_matmul {m}x{k}x{n} with the swept plan: "
          f"error {r:.3g} x the statistical limit")
    return {"fmt": spec.name, "m": m, "k": k, "n": n,
            "max_abs_err": float(err.max()),
            "max_err_over_bound": float((err / tol).max()),
            "max_err_over_stat_limit": r}


def autotune_phase(torch, dev, card):
    """40 (a): a forced sweep of each ``SWEEPS`` problem into a temporary
    cache (never the repo's tables), every candidate's CUDA-graph time;
    then, in lookup mode, the winner found again by ``resolved_plan``
    (``autotune.hit`` counted) and the kernel called without a plan, held
    against its plain version at phases 3 and 8's tolerances."""
    import tempfile
    from repro_torch import formats
    from repro_torch.kernels import autotune
    from repro_torch.obs.metrics import GLOBAL
    saved = {k: os.environ.get(k) for k in ("REPRO_AUTOTUNE",
                                             "REPRO_AUTOTUNE_CACHE")}
    tmp = tempfile.mkdtemp(prefix="autotune")
    rows = {}
    try:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "tune.json")
        os.environ["REPRO_AUTOTUNE"] = "force"
        autotune.clear()
        for op, fmt, shape in SWEEPS:
            log = []
            t0 = time.perf_counter()
            plan, us, swept = autotune.sweep_matmul(op, fmt, shape,
                                                    log=log.append)
            check(swept, f"phase 40: {op} {fmt} {shape} was not swept")
            cands = {}
            for line in log:
                m = re.match(r"#\s+(\(.*\)): (.*)$", line)
                if m:
                    cands[m.group(1)] = m.group(2)
            rows[f"{op} {fmt} {'x'.join(map(str, shape))}"] = {
                "op": op, "fmt": fmt, "shape": list(shape),
                "bucket": autotune.matmul_bucket(*shape),
                "planner": list(autotune.default_plan(
                    op, shape, formats.get(fmt).n)[:2]),
                "winner": list(plan), "winner_us": us,
                "candidates": cands,
                "sweep_s": round(time.perf_counter() - t0, 2)}
        os.environ["REPRO_AUTOTUNE"] = "1"
        autotune.clear()
        for key, row in rows.items():
            op, spec = row["op"], formats.get(row["fmt"])
            shape = tuple(row["shape"])
            hits = GLOBAL.counter("autotune.hit").get()
            got = autotune.resolved_plan(op, spec, shape)
            want = autotune.fit_plan(op, tuple(row["winner"]), shape, spec.n)
            check(got == want and GLOBAL.counter("autotune.hit").get()
                  == hits + 1, f"phase 40: lookup of {key} gave {got}, "
                  f"the sweep's winner is {want}")
            row["resolved_plan"] = list(got)
            if op == "qmatmul":
                held = wire_matmul_check(torch, dev, spec, *shape)
            else:
                held = lns_plan_check(torch, dev, *shape)
            row["held"] = {k: held[k] for k in (
                "max_abs_err", "max_err_over_bound",
                "max_err_over_stat_limit")}
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"sweeps": rows, "card": card, "timer": "CUDA-graph replays, 20 "
            "calls a candidate (autotune.graph_seconds)",
            "tolerance": f"phase 3 / 8: within the worst-case f32 bound "
                         f"and {C_STAT:g}*sqrt(K)*2^-24*sqrt((x*x)@(w*w))"}


def _leaf_specs(tree):
    from repro_torch.launch import dryrun
    return [(tuple(t.shape), str(t.dtype)) for _, t in dryrun._leaves(tree)
            if hasattr(t, "shape")]


def dryrun_phase(torch, dev, card, wrappers):
    """40 (b): ``dryrun.run_cell`` for phi3-medium-14b on a one-rank mesh
    at full width (``DRY_OVERRIDES``), traced on fake CUDA tensors, then
    the same step built from real tensors on the card and run: argument
    bytes equal exactly, output shapes and dtypes equal, the traced peak
    beside ``max_memory_allocated`` within ``DRY_PEAK_ABS`` +
    ``DRY_PEAK_REL`` of the card's."""
    from repro_torch.configs import RuntimeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.serve.engine import quantize_weights
    t0 = time.perf_counter()
    launches0 = {k: f.launches for k, f in wrappers.items()}
    cell = dryrun.run_cell("phi3-medium-14b", "decode_32k", out_dir=None,
                           mesh_shape=(1,), overrides=DRY_OVERRIDES,
                           keep=True)
    check(cell["status"] == "ok", f"phase 40: the dry run's cell failed: "
          f"{cell.get('error')}")
    check({k: f.launches for k, f in wrappers.items()} == launches0,
          "phase 40: the fake trace launched a kernel")
    trace_s = time.perf_counter() - t0
    fake_out = _leaf_specs(cell.pop("_trace")["out"])
    cfg, shape = dryrun._cell_config("phi3-medium-14b", "decode_32k",
                                     DRY_OVERRIDES)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, cfg, device=dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params = quantize_weights(params, "takum8", mode="wire", cfg=cfg)
    b = shape.global_batch
    batch = specs.dummy_batch(cfg, b, 1, seed=0, kind="decode", device=dev)
    cache = model.init_cache(cfg, b, shape.seq_len + 64, device=dev)
    dryrun._set_pos(cache, shape.seq_len)
    fn, args = dryrun.port_step(cfg, shape, make_mesh((1, 1), ("data",
                                                                "model")),
                                params, batch, cache, "gspmd",
                                RuntimeConfig())
    del params, batch, cache
    gc.collect()
    real_args = dryrun._tensor_bytes(args)
    check(real_args == cell["port_argument_bytes"],
          f"phase 40: the card's argument bytes {real_args} != the dry "
          f"run's {cell['port_argument_bytes']}")
    for k, f in wrappers.items():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    real_temp = torch.cuda.max_memory_allocated() - base
    launches = {k: f.launches for k, f in wrappers.items()}
    check(_leaf_specs(out) == fake_out, "phase 40: the card's outputs' "
          "shapes and dtypes differ from the dry run's")
    logits = out[0]
    check(bool(torch.isfinite(logits).all()), "phase 40: non-finite logits")
    traced = cell["memory"]["temp_size_in_bytes"]
    check(abs(real_temp - traced) <= DRY_PEAK_ABS + DRY_PEAK_REL * real_temp,
          f"phase 40: the traced temporary peak {traced} against the card's "
          f"{real_temp}")
    for k in ("kv_append", "attention", "qmatmul"):
        check(launches[k] == cell["kernels"][k]["calls"],
              f"phase 40: {k} launched {launches[k]} times, the trace "
              f"called it {cell['kernels'][k]['calls']} times")
    del out, args, fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"cell": {k: cell[k] for k in (
                "arch", "shape", "mesh", "n_devices", "params", "flops",
                "bytes_accessed", "kernels", "port_argument_bytes",
                "memory", "trace_s")},
            "overrides": DRY_OVERRIDES, "argument_bytes_equal": True,
            "outputs_equal": True, "fake_trace_s": round(trace_s, 2),
            "card_temp_bytes": real_temp, "traced_temp_bytes": traced,
            "temp_ratio": real_temp / max(traced, 1), "launches": launches,
            "peak_tolerance": f"|card - traced| <= {DRY_PEAK_ABS >> 20} MiB "
                              f"+ {DRY_PEAK_REL:g} x card: the trace holds "
                              "no kernel workspace, none of the wrappers' "
                              "casts, no allocator rounding (the wire "
                              "matmul's K-split sums: 4.6 MB at most)",
            "card": card}


def phase(n: int, name: str, **fields) -> None:
    print(f"phase {n} {name}: " + json.dumps(fields, sort_keys=False))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on the card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    # the checked-in launch-plan table alone: a local autotune cache that a
    # sweep left in the working directory is not read, so every plan is
    # the one the checkout gives
    import tempfile
    tune_dir = tempfile.TemporaryDirectory(prefix="autotune")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tune_dir.name,
                                                      "tune.json")
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
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu "
                             "(+ flash_attention.cuh)",
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
    wrappers = kernel_wrappers()
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
    # the standalone encode's launches by phase: serving, and the set-up
    # encodes of the wired weights
    enc_launches = {"5": launches["takum_encode"]}
    enc_setup = {"5": serve["setup_encode_launches"]}
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
    enc_launches["10"] = ll["takum_encode"]
    enc_setup["10"] = lserve["setup_encode_launches"]
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
    enc_launches["15"] = pl["takum_encode"]
    enc_setup["15"] = pserve["setup_encode_launches"]
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
    fq_sweep = {f"{kind}{n}" + (f" k {k}" if kind == "linear" else ""):
                fake_quant_sweep(torch, dev, n, kind, k)
                for n in FQ_SWEEP_WIDTHS for kind in CODEC_KINDS
                for k in (FQ_SCALES if kind == "linear" else (0,))}
    # posit8's other decode of the word path (table or computed)
    lut_other = "0" if p8.lut_decode(dev) else "1"
    with lut_switch(lut_other):
        fq_sweep["posit8, " + ("table" if lut_other == "1" else "computed")
                 + " decode"] = fake_quant_sweep(torch, dev, 8, "posit")
    fq_layer = quantize_layer_fake(torch, dev, "posit8")
    check(fq_layer["launches"] == 7, f"quantize_weights(mode='fake') over "
          f"one layer launched the fake-quant kernel {fq_layer['launches']} "
          "times, not 7")
    phase(17, "fake-quant", ms={k: v["ms"] for k, v in fq.items()},
          bound_ms={k: v["bound_ms"] for k, v in fq.items()},
          quantize_weights_layer=fq_layer,
          every_float32_pattern={k: v["differ"] for k, v in fq_sweep.items()},
          tolerance="bit-exact against the plain version (NaNs by place); "
                    "LNS: the codec kernels' round trip bit for bit, the "
                    "plain version's words or their neighbours, share <= "
                    f"{LNS_NEIGHBOUR_SHARE:g}")
    detail["fake_quant"] = {"rows": fq, "quantize_weights_layer": fq_layer,
                            "sweep": fq_sweep}
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
        redesigned="linear takum and posit round in value space (the "
                   "float's bits to nearest even at the word's fraction "
                   "width, from a block table of the float exponents) where "
                   "the word keeps a fraction bit, LNS the same on ell_bar's "
                   "fixed point form; any other float takes the codec "
                   "kernels' table encode and decode (bf16 out: one path a "
                   "warp, by vote; f32 out and LNS: each lane its own); "
                   "vectors of 4, one wave of blocks, n a kernel argument",
        every_float32_pattern=fq_sweep,
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
    enc_launches["18"] = fl["takum_encode"]
    enc_setup["18"] = fserve["setup_encode_launches"]
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
    before = takum_codec.encode.launches
    params20, _ = full_width_params(torch, dev, cfg20, "takum8")
    enc_setup["20"] = takum_codec.encode.launches - before
    lock = lockstep_phase(torch, dev, params20, cfg20, wrappers,
                          PHASE5_PLENS, 16)
    enc_launches["20"] = lock["launches"].get("takum_encode", 0)
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

    # -- 28-29. the dense relu2/gelu configs and the hybrid RG-LRU family --
    for n, fn in ((28, nemotron_phase), (29, recurrentgemma_phase)):
        res = fn(torch, dev, wrappers)
        launches = res["serving"]["launches"]
        for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
            kernels[k].setdefault("launches_new_families", {})[str(n)] = \
                launches[k]
        kernels["kv_append"]["launches_by_phase"][str(n)] = \
            launches["kv_append"]
        hk = res["hd_kernels"]
        for k, key, src in (
                ("attention", "contiguous",
                 "src/repro_torch/csrc/flash_attention_wide.cu "
                 "(+ flash_attention.cuh)"),
                ("paged_attention", "paged", "src/repro_torch/csrc/"
                 "attention.cu")):
            kernels[k][f"hd{hk['hd']}"] = dict(
                hk[key], hkv=hk["hkv"], group=hk["group"], source=src,
                launches=launches[k], launches_phase=n)
        kernels["kv_append"][f"hd{hk['hd']}"] = hk["kv_append"]
        kernels["qmatmul"].setdefault("served_shapes", {})[str(n)] = \
            res["wire_matmul"]
        kernels["qmatmul"]["max_abs_err"] = max(
            kernels["qmatmul"]["max_abs_err"],
            *(r["max_abs_err"] for r in res["wire_matmul"]))
        if n == 29:
            kernels["attention"]["hd256"]["served"] = res["served_attention"]
            kernels["fake_quant"]["launches_recurrentgemma_setup"] = \
                res["serving"]["fake_quant_launches_setup"]
            what = "serving recurrentgemma-2b full width and depth, lockstep"
        else:
            what = (f"serving nemotron-4-340b full width, {NEMOTRON_LAYERS} "
                    f"of {res['serving']['layers_of']} layers")
        phase(n, what, **res, card=card)
        detail[f"phase{n}"] = res

    # -- 30-32. rwkv6, encdec and vlm through lockstep ----------------------
    for n in (30, 31, 32):
        res = family_phase(torch, dev, n, wrappers)
        launches = res["serving"]["launches"]
        for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
            kernels[k].setdefault("launches_lockstep_families", {})[str(n)] = \
                launches[k]
        kernels["kv_append"]["launches_by_phase"][str(n)] = \
            launches["kv_append"]
        kernels["qmatmul"].setdefault("served_shapes", {})[str(n)] = \
            res["wire_matmul"]
        kernels["qmatmul"]["max_abs_err"] = max(
            kernels["qmatmul"]["max_abs_err"],
            *(r["max_abs_err"] for r in res["wire_matmul"]))
        if n != 30:
            sa = res["served_attention"]
            key = f"hd{sa['cache'][3]}_{res['serving']['arch']}_tq1"
            kernels["attention"][key] = dict(
                sa, launches=launches["attention"], launches_phase=n)
        if n == 30:
            kernels["fake_quant"]["launches_rwkv6_setup"] = \
                res["serving"]["fake_quant_launches_setup"]
        what = {30: "serving rwkv6-1.6b full width and depth, lockstep",
                31: "serving seamless-m4t-large-v2 full width and depth, "
                    "lockstep",
                32: "serving llama-3.2-vision-11b full width and depth, "
                    "lockstep"}[n]
        phase(n, what, **res, card=card)
        detail[f"phase{n}"] = res

    # -- 33. the codec at every width ----------------------------------------
    cw = codec_widths_phase(torch, dev)
    widths_t = cw["times"]
    worst_ulps = max(r["decode_max_ulps"] for r in cw["checks"].values())
    phase(33, "the codec at every width",
          widths=f"{WIDTHS_ALL[0]}-{WIDTHS_SAMPLED[-1]}",
          formats=len(cw["checks"]), decode_max_ulps=worst_ulps,
          lns_encode_neighbour_share=max(
              r["encode_neighbour_share"] for r in cw["checks"].values()
              if "encode_neighbour_share" in r),
          hw_path=sorted(cw["hw_path"]),
          fake_quant_ms={k: v["ms"] for k, v in cw["fake_quant"].items()},
          decode_ms={n: {k: v["decode_ms"] for k, v in r.items()}
                     for n, r in widths_t.items()},
          encode_ms={n: {k: v["encode_ms"] for k, v in r.items()}
                     for n, r in widths_t.items()},
          bound_ms={n: r["linear"]["bound_ms"] for n, r in widths_t.items()},
          posit8_computed_decode_ms=widths_t["8"]["posit"][
              "decode_computed_ms"],
          encode_sweep={k: v["differ"] for k, v in cw["encode_sweep"].items()},
          fake_quant_bf16_ms={k: v["bf16_ms"]
                              for k, v in cw["fake_quant"].items()},
          fake_quant_sweep={k: v["sweep"]["differ"]
                            for k, v in cw["fake_quant"].items()
                            if "sweep" in v},
          ragged_cases=cw["ragged"]["cases"],
          ragged_fake_quant_cases=cw["ragged"]["fake_quant_cases"],
          attention_rows_before_start={
              k: {kk: v[kk] for kk in ("max_abs_err", "ms", "ms_no_start",
                                       "bound_ms", "plain_ms", "library_ms")}
              for k, v in cw["attention_rows_before_start"].items()},
          launches=cw["launches"], card=card,
          tolerance="linear and posit bit for bit (NaN by place); LNS "
                    "decode within 2 ulp, encode the same word or (at a "
                    "logf tie) its neighbour, share <= LNS_NEIGHBOUR_SHARE; "
                    "attention ATTN_ATOL on every row")
    detail["phase33"] = cw
    per = cw["launches_per_format"]
    kernels["takum_codec"]["widths"] = {
        n: {kind: dict(r, launches_phase33={
            "decode": per[f"{kind}{n}"]["takum_decode"],
            "encode": per[f"{kind}{n}"]["takum_encode"]}) for kind, r in
            row.items()} for n, row in widths_t.items()}
    kernels["takum_codec"]["launches_phase33"] = {
        "decode": cw["launches"]["takum_decode"],
        "encode": cw["launches"]["takum_encode"]}
    kernels["takum_codec"]["max_abs_err_widths_ulps"] = worst_ulps
    kernels["takum_codec"]["encode_sweep"] = cw["encode_sweep"]
    kernels["takum_codec"]["redesigned"] = (
        "magnitudes negated by two's complement, the encode from the "
        "header cut of the float's exponent (a 4-8 KB block table, one "
        "64-bit add and two funnel shifts), the takum decode from a "
        "2048-entry table of the 11 bits after the sign, vectors of 4 "
        "elements (16-byte float accesses), one wave of blocks")
    enc = codec_t["encode_weights"]
    kernels["takum_codec"]["encode"] = dict(
        shape=enc["shape"], ms=enc["ms"], plain_ms=enc["plain_ms"],
        bound_ms=enc["bound_ms"], bound_by=enc["bound_by"], library_ms=None,
        launches=enc_launches, launches_setup=enc_setup,
        launches_path="standalone encodes while serving (phase 10: the "
                      "activations entering the LNS matmuls) and at set-up "
                      "(the wired weights), phases 5 / 10 / 15 / 18 / 20")
    kernels["takum_codec"]["ragged"] = cw["ragged"]
    kernels["fake_quant"]["widths"] = {
        k: dict(r, launches_phase33=per[k]["fake_quant"])
        for k, r in cw["fake_quant"].items()}
    kernels["fake_quant"]["launches_phase33"] = cw["launches"]["fake_quant"]
    kernels["attention"]["rows_before_start"] = \
        cw["attention_rows_before_start"]

    # -- 34. the codec at 33-64 bits and the float64 decode ------------------
    t34 = time.perf_counter()
    c64 = codec64_phase(torch, dev)
    t64 = c64["times"]
    rows = list(c64["checks"].values()) + list(c64["float64_decode"].values())
    differ = {k: sum(r.get(k, 0) for r in rows)
              for k in ("decode_float32_differ", "decode_float64_differ",
                        "encode_differ", "fake_quant_float32_differ",
                        "fake_quant_bfloat16_differ",
                        "fake_quant_float64_differ")}
    phase(34, "the codec at 33-64 bits and the float64 decode",
          widths=list(WIDTHS_64), float64_from=list(WIDTHS_F64),
          formats=len(c64["checks"]) + len(c64["float64_decode"]),
          differ=differ, lns_encode_neighbour_share=max(
              r["encode_neighbour_share"] for r in c64["checks"].values()
              if "encode_neighbour_share" in r),
          encode_sweep={k: v["differ"] for k, v in
                        c64["encode_sweep"].items()},
          decode_ms={n: {k: v.get("decode_ms") for k, v in r.items()}
                     for n, r in t64.items()},
          decode_f64_ms={n: {k: v["decode_f64_ms"] for k, v in r.items()}
                         for n, r in t64.items()},
          encode_ms={n: {k: v.get("encode_ms") for k, v in r.items()}
                     for n, r in t64.items()},
          fake_quant_ms={n: {k: v.get("fake_quant") for k, v in r.items()}
                         for n, r in t64.items() if n != "32"},
          launches=c64["launches"], seconds=time.perf_counter() - t34,
          seconds_by_part=c64["seconds"],
          card=card,
          tolerance="linear and posit bit for bit (NaN by place); LNS "
                    "decode within 2 ulp, encode the plain word or one in "
                    "the window of a logf 2 ulp either side, fake-quant the "
                    "codec kernels' round trip bit for bit")
    detail["phase34"] = c64
    per64 = c64["launches_per_format"]
    for n, row in t64.items():
        entry = kernels["takum_codec"]["widths"].setdefault(n, {})
        for kind, r in row.items():
            r = {k: v for k, v in r.items() if k != "fake_quant"}
            r["launches_phase34"] = {
                "decode": per64[f"{kind}{n}"]["takum_decode"],
                "encode": per64[f"{kind}{n}"]["takum_encode"]}
            entry.setdefault(kind, {}).update(r)
    kernels["takum_codec"]["launches_phase34"] = {
        "decode": c64["launches"]["takum_decode"],
        "encode": c64["launches"]["takum_encode"]}
    kernels["takum_codec"]["encode_sweep_64"] = c64["encode_sweep"]
    for n, row in t64.items():
        for kind, r in row.items():
            if "fake_quant" in r:
                kernels["fake_quant"]["widths"][f"{kind}{n}"] = dict(
                    r["fake_quant"],
                    launches_phase34=per64[f"{kind}{n}"]["fake_quant"])
    kernels["fake_quant"]["launches_phase34"] = c64["launches"]["fake_quant"]

    # -- 35. training every served family at full width --------------------
    t35 = time.perf_counter()
    fam, not_run = family_training_phase(torch, dev,
                                         train["bytes_per_param"])
    phase(35, "training the served families full width",
          rows={a: {k: r[k] for k in (
              "layers", "params", "reduced", "media", "optimizer",
              "step_ms_steady_mean", "fwd_bwd_ms_steady_mean",
              "optimizer_ms_steady_mean", "tokens_per_s_steady_mean",
              "loss_first_last", "peak_gb", "bytes_per_param")}
              | ({"losses_at_train_lr": r["losses_at_train_lr"]}
                 if "losses_at_train_lr" in r else {})
              for a, r in fam.items()},
          not_run_on_the_card=not_run, batch=[1, TRAIN_T],
          steps=FAMILY_TRAIN_STEPS, remat="block", lr=TRAIN_LR,
          seconds=time.perf_counter() - t35, card=card)
    detail["phase35"] = {"rows": fam, "not_run": not_run}

    # -- 36. the reduced families trained card against CPU ------------------
    red36 = {a: reduced_family_training(torch, dev, a)
             for a in REDUCED_TRAIN_ARCHS}
    phase(36, "reduced training card vs cpu, every family", **red36,
          lr=TRAIN_LR,
          tolerance=f"losses {LOSS_REL:g} relative; each parameter leaf "
                    f"within {PARAM_REL_L2:g} relative L2 (rwkv6: "
                    f"{RWKV6_LOSS_REL:g}, {RWKV6_PARAM_REL_L2:g}; elementwise "
                    f"against rtol {REORDER_RTOL:g} atol {REORDER_ATOL:g} "
                    f"reported)")
    detail["phase36"] = red36

    # -- 37. lns-takum8 and posit8 weights on the served families -----------
    red37, path37 = {}, {k: 0 for k in wrappers}
    for wfmt in FAMILY_FMTS:
        for arch, kv in FAMILY_KV:
            r = reduced_lockstep_card_vs_cpu(torch, dev, arch, kv, wfmt,
                                             wrappers)
            red37[f"{arch} {wfmt}"] = r
            for k in path37:
                path37[k] += r["launches"][k]
            need = (("lns_matmul", "takum_encode") if wfmt == "lns-takum8"
                    else ("qmatmul", "posit8_lut"))
            for k in need:
                check(r["launches"][k] > 0, f"phase 37: {arch} with {wfmt} "
                      f"weights launched no {k}")
    phase(37, "reduced families with lns-takum8 and posit8 weights card "
          "vs cpu", cases=red37, launches=path37,
          tolerance="greedy tokens identical; LNS: also on prompts of "
                    "one length with the CPU's activation words replayed "
                    "(inputs within ENCODE_INPUT_ATOL, rwkv6's within "
                    "RWKV6_ENCODE_INPUT_ATOL), each card word the CPU's or "
                    "its neighbour")
    detail["phase37"] = red37
    kernels["lns_matmul"]["launches_phase37"] = path37["lns_matmul"]
    kernels["qmatmul"]["launches_phase37"] = path37["qmatmul"]
    kernels["posit8_lut"]["launches_phase37"] = path37["posit8_lut"]
    kernels["takum_codec"]["encode"]["launches"]["37"] = \
        path37["takum_encode"]
    kernels["takum_codec"]["launches_phase37"] = {
        "decode": path37["takum_decode"], "encode": path37["takum_encode"]}

    # -- 38. tensor-parallel serving over gloo ranks on the one card -------
    shard = shard_phase(torch, dev, card)
    path38 = {k: 0 for k in wrappers}
    for label, _ in SHARD_RUNS:
        for rank in shard["full_width"][label]["ranks"]:
            for k in path38:
                path38[k] += rank["launches"][k]
    shard["launches"] = path38
    phase(38, "tensor-parallel serving phi3-medium-14b full width, tp 2 "
          "over gloo ranks on one card", **shard)
    detail["phase38"] = shard
    kernels["takum_codec"]["launches_phase38"] = {
        "decode": path38["takum_decode"], "encode": path38["takum_encode"]}
    for k in ("kv_append", "qmatmul", "attention", "paged_attention"):
        kernels[k]["launches_phase38"] = path38[k]

    # -- 39. manual data-parallel training over gloo ranks on the one card -
    dpt = dp_phase(torch, dev, card, train)
    phase(39, "manual data-parallel training phi3-medium-14b full width, "
          "ZeRO-1 over gloo ranks on one card", **dpt)
    detail["phase39"] = dpt
    path39 = {k: sum(dpt[label]["launches"][k] for label, _ in DP_RUNS)
              for k in ("takum_decode", "takum_encode")}
    kernels["takum_codec"]["launches_phase39"] = {
        "decode": path39["takum_decode"], "encode": path39["takum_encode"]}
    kernels["takum_codec"]["grad_chunk"] = dpt["grad_chunk"]

    # -- 40. the launch-plan autotuner and the dry run against the card ----
    t40 = time.perf_counter()
    tune = autotune_phase(torch, dev, card)
    dry = dryrun_phase(torch, dev, card, wrappers)
    phase(40, "launch-plan sweeps and the dry run held against the card",
          sweeps={k: {f: r[f] for f in ("planner", "winner", "winner_us",
                                        "resolved_plan", "candidates",
                                        "held")}
                  for k, r in tune["sweeps"].items()},
          dryrun=dry, seconds=round(time.perf_counter() - t40, 1),
          card=card, tolerance=tune["tolerance"])
    detail["phase40"] = {"autotune": tune, "dryrun": dry}
    for op, kname in (("qmatmul", "qmatmul"), ("lns_qmatmul", "lns_matmul")):
        kernels[kname]["autotune_phase40"] = {
            k: {f: r[f] for f in ("bucket", "planner", "winner",
                                  "winner_us", "candidates")}
            for k, r in tune["sweeps"].items() if r["op"] == op}
    for k in ("kv_append", "qmatmul", "attention"):
        kernels[k]["launches_phase40"] = dry["launches"][k]

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
