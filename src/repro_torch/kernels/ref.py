"""Plain PyTorch versions of every kernel in this package.

Each CUDA kernel is held against the function here: the codec bit-exact
(the LNS conversions to an ulp or two of exp/log), the matmuls and
attention to f32 summation-order tolerance, the gauss LNS matmul's
integer state bit-exact. These are also what the kernel wrappers run
when their tensors lie on the CPU.

Every entry point resolves its format through ``repro_torch.formats``,
so callers may pass a ``FormatSpec``, a registry name or an int width.
"""

from __future__ import annotations

import torch

from repro_torch import formats
from repro_torch.core import lns, takum
from repro_torch.core.bitops import (bit, carrier, clz, floor_log2, lanes,
                                     mask, safe_shr, signed64, to_words)
from repro_torch.core.quant import exp2i
from repro_torch.core.takum import frac_width

__all__ = ["decode_ref", "encode_ref", "kv_append_ref", "takum8_table",
           "encode_dataflow", "decode_dataflow", "lns_tail_dataflow",
           "fake_quant_dataflow", "fake_quant_ref",
           "fake_quant_lns_ref", "qmatmul_ref", "lns_qmatmul_ref", "lns_matmul_plain",
           "attention_ref", "paged_attention_ref", "MASKED"]

MASKED = -1e30   # finite mask value: all-masked rows stay finite


def decode_ref(words, fmt, dtype=torch.float32) -> torch.Tensor:
    """Wire words -> float."""
    return formats.resolve(fmt).decode_tile(words, dtype=dtype)


def takum8_table(device=None) -> torch.Tensor:
    """The 256-entry takum8 decode table of every kernel that decodes
    takum8 words (``csrc/wire.cuh``, ``Codec<8, LINEAR>::Tab``): entry
    ``w`` is the computed decode of word ``w``, as each block fills it."""
    words = torch.arange(256, dtype=torch.int64, device=device)
    return takum.takum_to_float(words.to(torch.uint8), 8)


def encode_ref(x, fmt) -> torch.Tensor:
    """float32 -> wire words (RNE, saturating)."""
    return formats.resolve(fmt).encode_tile(x)


# -- the codec kernels' dataflow ---------------------------------------------
# A plain mirror of csrc/codec.cuh and the device functions of takum.cuh and
# posit.cuh: magnitudes negated by two's complement, the encode from the
# header cut of the float's exponent, the takum decode from a table of the
# 11 bits after the sign. 64-bit words (n >= 33) and float64 output take the
# kernels' wide forms: the encode shifts the header and the fraction into
# place (rounding only where they do not fit, _round_wide), the decode reads
# c and r from the header table (takum) or counts the regime with one 64-bit
# count of leading zeros (posit) and assembles the float in a 64-bit lane.
# The CPU tests hold it against the reference codec
# (tests/test_torch_codec_dataflow.py, tests/test_torch_codec64.py); no
# program path calls it.


def _takum_header(c):
    """(P, L): the header D, R, C of characteristic c in [-255, 254] and
    its length 4 + r."""
    d = (c >= 0).to(torch.int64)
    t = torch.where(d == 1, c, ~c) + 1                  # [1, 255]
    r = floor_log2(t)
    r3 = torch.where(d == 1, r, 7 - r)
    cbits = torch.where(d == 1, t, ~t) & mask(r)
    return (d << (3 + r)) | (r3 << r) | cbits, 4 + r


def _posit_header(e, n: int):
    """(P, L): the regime of k = floor(e / 4), clamped to [1 - n, n - 2],
    and the two exponent bits e mod 4."""
    k = torch.clamp(e >> 2, 1 - n, n - 2)
    regime = torch.where(k >= 0, ((2 << k.clamp(min=0)) - 1) << 1,
                         torch.ones_like(k))
    rl = torch.where(k >= 0, k + 2, 1 - k)
    return (regime << 2) | (e & 3), rl + 2


def _round_cut(p, length, m, n: int, wm: int):
    """clamp(RNE((P << wm | m) >> (L + wm + 1 - n)), 1, 2^(n-1) - 1), as
    ``takum::round_entry``: shifted up so that the cut is at least 1, the
    bias 2^(cut-1) - 1 and the kept word's last bit added before the
    shift (ties to the even word)."""
    pre = max(1, n - wm - 4)
    x = ((p << wm) | m) << pre
    sh = length + wm + 1 - n + pre
    kept = x >> sh
    w = (x + (1 << (sh - 1)) - 1 + (kept & 1)) >> sh
    return torch.clamp(w, 1, (1 << (n - 1)) - 1)


def _round_wide(v, sh):
    """RNE(v * 2^sh) of v < 2^58: a shift up for sh >= 0, else v shifted
    down by -sh <= 32 bits to nearest even (``takum::round_wide``)."""
    k = torch.clamp(-sh, min=1)
    kept = v >> k
    g = (v >> (k - 1)) & 1
    rest = (v & ((1 << (k - 1)) - 1)) != 0
    down = kept + ((g == 1) & (rest | ((kept & 1) == 1))).to(torch.int64)
    return torch.where(sh >= 0, v << torch.clamp(sh, min=0), down)


def _inf_word(kind: str, n: int, wm: int = 23) -> int:
    """The magnitude word of +inf (and of LNS's saturated ell_bar) at
    width n: the plain encoder saturates to the largest characteristic
    with an all-ones mantissa of ``wm`` bits and a sticky bit, which is
    the largest word to n = 35 (34 for LNS) and, wider, that mantissa
    shifted into place; posit saturates to the largest word. -inf is the
    negated largest word at every width: the barred representation takes
    it through the smallest characteristic, which rounds up to the word
    after NaR."""
    top = (1 << (n - 1)) - 1
    if kind == "posit" or n <= 32:
        return top
    p, length = _takum_header(torch.tensor([254]))
    v = (p << wm) | ((1 << wm) - 1)
    w = int(_round_wide(v, torch.tensor([n - 1 - wm]) - length)[0])
    return min(max(w, 1), top)


def encode_dataflow(x, fmt) -> torch.Tensor:
    """float32 -> linear takum or posit words as the encode kernel forms
    them: the header P and length L read from a table by float exponent
    (subnormals normalised), the word of |x| rounded and clamped by
    :func:`_round_cut`, +-inf to the largest magnitude, then negated by
    two's complement for S = 1; +-0 -> 0, NaN -> NaR."""
    spec = formats.resolve(fmt)
    if spec.kind not in ("linear", "posit"):
        raise ValueError(f"the table encode is linear takum's and posit's, "
                         f"got {spec.name!r}")
    n = spec.n
    b = lanes(torch.as_tensor(x, dtype=torch.float32).contiguous()
              .view(torch.int32).view(torch.uint32))
    s, mag = b >> 31, b & 0x7FFFFFFF
    fexp, frac = mag >> 23, mag & 0x7FFFFF
    lb = floor_log2(torch.clamp(frac, min=1))
    sub = fexp == 0
    e = torch.where(sub, lb - 149, fexp - 127).clamp(max=127)
    m = torch.where(sub, (frac << (23 - lb).clamp(min=0)) & 0x7FFFFF, frac)
    es = torch.arange(-150, 128, dtype=torch.int64, device=b.device)
    p_tab, l_tab = (_takum_header(es.clamp(min=-149)) if spec.kind == "linear"
                    else _posit_header(es, n))
    if n <= 32:
        w = _round_cut(p_tab[e + 150], l_tab[e + 150], m, n, 23)
    else:
        w = torch.clamp(_round_wide((p_tab[e + 150] << 23) | m,
                                    n - 24 - l_tab[e + 150]),
                        1, (1 << (n - 1)) - 1)
    w = torch.where(mag == 0x7F800000, torch.where(
        s == 1, (1 << (n - 1)) - 1, _inf_word(spec.kind, n)), w)
    w = torch.where(mag == 0, 0, w)
    w = torch.where(s == 1, (-w) & mask(n, 64), w)
    w = torch.where(mag > 0x7F800000, signed64(1 << (n - 1)), w)
    return to_words(w, spec.word_dtype)


def lns_tail_dataflow(s, fixed, n: int) -> torch.Tensor:
    """The LNS encode's integer tail as the kernels form it: ell_bar's
    fixed point form (22 fraction bits, of |x|) rounded through the cut
    of its floor characteristic, saturating outside [-255, 254], then
    negated for S = 1 (int64 words). From n = 33 the header and the
    fraction shift into place (:func:`_round_wide`), and a characteristic
    above 254 saturates as the plain encoder does (:func:`_inf_word`)."""
    fixed = lanes(fixed)
    c = fixed >> 22
    p, length = _takum_header(torch.clamp(c, -255, 254))
    if n <= 32:
        w = _round_cut(p, length, fixed & mask(22), n, 22)
    else:
        w = torch.clamp(_round_wide((p << 22) | (fixed & mask(22)),
                                    n - 23 - length), 1, (1 << (n - 1)) - 1)
    top = (1 << (n - 1)) - 1
    w = torch.where(c > 254, torch.where(lanes(s) == 1, top,
                                         _inf_word("lns", n, 22)),
                    torch.where(c < -255, 1, w))
    return torch.where(lanes(s) == 1, (-w) & mask(n, 64), w)


def decode_dataflow(words, fmt, dtype=torch.float32) -> torch.Tensor:
    """Linear takum or posit words -> float32 as the decode kernel forms
    them: the magnitude word (-w mod 2^n for S = 1); for takum the entry
    of the 11 bits after the sign (c, the header and the mantissa's shift:
    bits = (t << (23 - p)) + ((c + 127 - header) << 23)), for posit the
    regime's run by a count of leading zeros; the sign ORed back. Words
    whose value is not a float32 normal, and widths from 29 (the fraction
    rounds into float32), take the plain codec, as the kernel takes its
    register path. 64-bit words and float64 output take the wide form
    (:func:`_decode_wide`)."""
    spec = formats.resolve(fmt)
    if spec.kind not in ("linear", "posit"):
        raise ValueError(f"the table decode is linear takum's and posit's, "
                         f"got {spec.name!r}")
    n = spec.n
    if n > 32 or dtype == torch.float64:
        return _decode_wide(words, spec, dtype)
    w = lanes(words) & mask(n)
    s = w >> (n - 1)
    a = torch.where(s == 1, (-w) & mask(n), w)
    if spec.kind == "linear":
        n12 = max(n, 12)
        t = a << (n12 - n)
        idx = (t >> (n12 - 12)) & 0x7FF
        c, r, hdr = _header_table(w.device)
        shift = 23 - (n12 - 5 - r)
        base = ((c + 127 - hdr) << 23) & 0xFFFFFFFF
        rare_tab = (c < -126) | (c > 127)
        bits = ((t << shift[idx].clamp(min=0)) + base[idx]) & 0xFFFFFFFF
        rare = rare_tab[idx] | (n > 28)
    else:
        body = (a << (33 - n)) & 0xFFFFFFFF
        top = body >> 31
        run = clz(torch.where(top == 1, ~body & 0xFFFFFFFF, body), 32)
        k = torch.where(top == 1, run - 1, -run)
        rest = (body << (run + 1)) & 0xFFFFFFFF
        frac = (rest << 2) & 0xFFFFFFFF
        bits = (((4 * k + (rest >> 30) + 127) << 23) | (frac >> 9)) & 0xFFFFFFFF
        rare = torch.full_like(bits, n > 28, dtype=torch.bool)
    bits = bits | (s << 31)
    out = to_words(bits, torch.uint32).view(torch.float32)
    out = torch.where(rare, spec.decode_tile(words), out)
    special = (w & mask(n - 1)) == 0
    return torch.where(special, torch.where(s == 1, float("nan"), 0.0),
                       out)


def _header_table(device):
    """The 2048-entry header table of the 11 bits after the sign (the
    12-bit form, ghost bits appended): each entry's characteristic c,
    regime r and header value (D, R and the r bits of C)."""
    i = torch.arange(2048, dtype=torch.int64, device=device)
    d = i >> 10
    r = torch.where(d == 1, (i >> 7) & 7, 7 - ((i >> 7) & 7))
    uc = (i >> (7 - r)) & mask(r)
    c = torch.where(d == 1, (1 << r) - 1 + uc, -(1 << (r + 1)) + 1 + uc)
    return c, r, i >> (7 - r)


def _decode_wide(words, spec, dtype) -> torch.Tensor:
    """The wide decode of the kernels (``csrc/codec.cuh``): 64-bit lanes,
    the magnitude word's characteristic and regime from the header table
    (takum: the fraction is ``(t << r)`` cut to wf = n12 - 5 bits) or its
    regime by one 64-bit count of leading zeros (posit), then the IEEE
    word assembled for ``dtype`` (float32 or float64) with the plain
    codec's roundings."""
    n = spec.n
    w = lanes(words) & mask(n, 64)
    s = bit(w, n - 1, 64)
    a = torch.where(s == 1, (-w) & mask(n, 64), w)
    special = (w & mask(n - 1, 64)) == 0
    if spec.kind == "linear":
        n12 = max(n, 12)
        t = a << (n12 - n)
        idx = safe_shr(t, n12 - 12, 64) & 0x7FF
        c_tab, r_tab, _ = _header_table(w.device)
        r, me = r_tab[idx], c_tab[idx]
        mf = (t << r) & mask(n12 - 5, 64)
        wf = n12 - 5
    else:
        body = a << (65 - n)
        top = bit(body, 63, 64)
        run = clz(torch.where(top == 1, ~body, body), 64)
        k = torch.where(top == 1, run - 1, -run)
        rest = (body << torch.clamp(run, max=63)) << 1
        me = 4 * k + safe_shr(rest, 62, 64)
        mf = safe_shr(rest << 2, 69 - n, 64)
        wf = n - 5
    return takum.assemble_float(s, mf, me, wf, dtype, is_zero=special & (s == 0),
                                is_nar=special & (s == 1), wide=True)


def _value_drop(e, n: int, kind: str):
    """The fraction bits d = 23 - p that the value-space round drops at
    biased float32 exponent e (int64 lanes): p = n - 1 - L(c) at c = e -
    127, L the header's length (takum: 4 + floor_log2((c >= 0 ? c : ~c)
    + 1); posit: the regime of k = c >> 2 and two exponent bits)."""
    c = e - 127
    if kind == "linear":
        return floor_log2((c ^ (c >> 63)) + 1) + 28 - n
    k = c >> 2
    return (k ^ (k >> 63)) + 28 - n


def fake_quant_dataflow(x, fmt, dtype=torch.float32, *,
                        scale_exp: int = 0) -> torch.Tensor:
    """Linear takum or posit fake-quant as the fused kernel forms it (a
    plain mirror of ``csrc/fake_quant.cu``): x scaled by 2^k; a normal
    float whose word keeps p >= 1 fraction bits rounds in value space,
    to nearest even on its own float32 bits with d = 23 - p bits dropped
    (unchanged for d <= 0: a carry out of the fraction is the word's
    carry into the next characteristic, and at c = 127 gives +inf as the
    decode does); every other float (0, subnormal, inf, NaN, p < 1) takes
    the word path, :func:`encode_dataflow` then :func:`decode_dataflow`;
    the result scaled by 2^-k and cast to ``dtype`` (round to nearest
    even). For ``dtype`` float64 the value path rounds the float64 bits of
    x (d + 29 bits dropped: a carry out of float32's exponent range stays
    finite, as the word's float64 decode) and the word path decodes to
    float64. No program path calls it: the CPU tests hold it against the
    reference (tests/test_torch_fake_quant_dataflow.py,
    tests/test_torch_codec64.py)."""
    spec = formats.resolve_wire(fmt)
    if spec.kind not in ("linear", "posit"):
        raise ValueError(f"the value-space round is linear takum's and "
                         f"posit's, got {spec.name!r}")
    x = torch.as_tensor(x).to(torch.float32)
    if scale_exp:
        x = x * exp2i(scale_exp).to(x.device)
    b = lanes(x.contiguous().view(torch.int32).view(torch.uint32))
    e = (b >> 23) & 0xFF
    d = _value_drop(e, spec.n, spec.kind)
    common = (e >= 1) & (e <= 254) & (d <= 22)
    dd = d.clamp(min=0, max=22)
    f64 = dtype == torch.float64
    if f64:
        b = x.to(torch.float64).contiguous().view(torch.int64)
        dd = dd + 29
    m = (1 << dd) - 1
    r = (b + (m >> 1) + ((b >> dd) & m & 1)) & ~m
    value = (r.view(torch.float64) if f64 else
             to_words(r & 0xFFFFFFFF, torch.uint32).view(torch.float32)
             ).reshape(x.shape)
    word = decode_dataflow(encode_dataflow(x, spec), spec,
                           torch.float64 if f64 else torch.float32)
    y = torch.where(common, value, word)
    if scale_exp:
        y = y * exp2i(-scale_exp).to(y.device)
    return y.to(dtype)


def kv_append_ref(k, v, k_cache, v_cache, fmt, *, pos, table=None,
                  encode=encode_ref) -> None:
    """The KV append of ``takum_codec.kv_append``, in place: ``k``/``v``
    ``[B, T, Hkv, hd]`` in the cache's format (the identity codec casts to
    the cache dtype, wire formats ``encode`` from f32, K then V), written
    at ``(table[b, min(pos // ps, NP - 1)], pos % ps)`` of a paged pool
    (``table`` given, T = 1) or at ``[:, pos:pos + T]`` of a contiguous
    cache (``pos`` an int)."""
    spec = formats.resolve(fmt)

    def words(x, cache):
        return (x.to(cache.dtype) if spec.is_identity
                else encode(x.to(torch.float32), spec))

    kw, vw = words(k, k_cache), words(v, v_cache)
    if table is None:
        index = (slice(None), slice(int(pos), int(pos) + k.shape[1]))
    else:
        ps = k_cache.shape[1]
        pidx = torch.clamp(pos // ps, max=table.shape[1] - 1).long()
        page = table.gather(1, pidx[:, None])[:, 0].long()
        index = (page, (pos % ps).long())
        kw, vw = kw[:, 0], vw[:, 0]
    carrier(k_cache)[index] = carrier(kw)
    carrier(v_cache)[index] = carrier(vw)


def fake_quant_ref(x, fmt, dtype=torch.float32, *,
                   scale_exp: int = 0) -> torch.Tensor:
    """Round trip through ``fmt``'s grid: encode, then decode to f32 (f64
    for ``dtype`` float64, as the reference decodes to its dtype), then
    cast to ``dtype`` (round to nearest even). ``scale_exp`` = k scales by
    2^k before the encode and by 2^-k after the decode (exact powers of
    two: ``core.quant``'s centring, as ``dequantize(quantize(x))``)."""
    spec = formats.resolve_wire(fmt)
    x = torch.as_tensor(x).to(torch.float32)
    if scale_exp:
        x = x * exp2i(scale_exp).to(x.device)
    y = spec.decode_tile(spec.encode_tile(x), dtype=(
        torch.float64 if dtype == torch.float64 else torch.float32))
    if scale_exp:
        y = y * exp2i(-scale_exp).to(y.device)
    return y.to(dtype)


def fake_quant_lns_ref(x, n: int, dtype=torch.float32) -> torch.Tensor:
    """:func:`fake_quant_ref` through the logarithmic takum of width n."""
    return fake_quant_ref(x, formats.resolve("lns", n), dtype=dtype)


def qmatmul_ref(x, w_words, fmt, out_dtype=torch.float32) -> torch.Tensor:
    """x [M, K] float @ decode(w_words [K, N]) -> [M, N], f32 x f32 with
    an f32 sum."""
    w = formats.resolve(fmt).decode_tile(w_words, dtype=torch.float32)
    return (x.to(torch.float32) @ w).to(out_dtype)


def lns_qmatmul_ref(x, w_words, fmt, out_dtype=torch.float32) -> torch.Tensor:
    """The oracle of the LNS matmul: x quantised to the LNS grid, both
    operands decoded to f32, one f32 product with an f32 sum. Against the
    kernel (which exponentiates the ``ell`` sum) each product carries one
    more f32 rounding, at most half an ulp."""
    spec = formats.resolve_lns(fmt)
    xq = spec.decode_tile(spec.encode_tile(x))
    w = spec.decode_tile(w_words, dtype=torch.float32)
    return (xq @ w).to(out_dtype)


def _prod(xell, xflg, well, wflg):
    """(s, ell, zero, nar) of the products x (x) w (broadcast): one add of
    the ell lanes, an XOR of the signs, an OR of the zero/NaR flags."""
    f = xflg | wflg
    return (xflg ^ wflg) & 1, xell + well, (f >> 1) & 1, (f >> 2) & 1


def _lns_to_f32(s, ell, zero, nar, wf: int, exp=torch.exp) -> torch.Tensor:
    """sqrt(e)^ell with sign, zero and NaR (NaN) applied: one exp."""
    mag = exp(ell.to(torch.float32) * (0.5 / (1 << wf)))
    val = torch.where(zero == 1, torch.zeros_like(mag),
                      torch.where(s == 1, -mag, mag))
    return torch.where(nar == 1, torch.full_like(val, float("nan")), val)


def lns_matmul_plain(x_words, w_words, fmt, accum: str = "linear", *,
                     state: bool = False, chunk_elems: int = 1 << 24,
                     exp=torch.exp):
    """What the LNS matmul kernel computes, in plain PyTorch:
    decode(x_words [M, K]) (x) decode(w_words [K, N]) -> f32 [M, N].

    * ``"linear"``: each product's ``ell`` sum converted with one exp,
      summed in f32 over K in chunks of at most ``chunk_elems`` products
      (an ``[M, K, N]`` grid is never materialised);
    * ``"gauss"``: a sequential fold over k = 0..K-1 with
      ``lns.gauss_add_parts`` from the empty sum (the zero flag), NaR as a
      sticky flag, one conversion at the end. ``state=True`` also returns
      the final ``(ell, flags)`` int32 state (flags = S | zero << 1 |
      NaR << 2).

    NaR words become NaN. ``exp`` converts each scaled ``ell`` (a check
    passes a less precise one as a control that its limit must reject)."""
    spec = formats.resolve_lns(fmt)
    if not spec.has_lns_parts:
        raise ValueError(f"format {spec.name!r} has no LNS ell_bar datapath")
    if accum not in ("linear", "gauss"):
        raise ValueError(f"unknown accum {accum!r}")
    wf = frac_width(spec.n)
    xell, xflg = spec.lns_parts(x_words)
    well, wflg = spec.lns_parts(w_words)
    m, k = xell.shape
    n = well.shape[1]
    dev = xell.device
    if accum == "linear":
        if state:
            raise ValueError("state=True returns the gauss accumulator's "
                             "state")
        out = torch.zeros((m, n), dtype=torch.float32, device=dev)
        kc = max(1, chunk_elems // max(m * n, 1))
        for k0 in range(0, k, kc):
            sl = slice(k0, k0 + kc)
            p = _prod(xell[:, sl, None], xflg[:, sl, None], well[None, sl],
                      wflg[None, sl])
            out += _lns_to_f32(*p, wf, exp).sum(dim=1)
        return out
    lut = lns.gauss_tables(wf, device=dev)
    s = torch.zeros((m, n), dtype=torch.int32, device=dev)
    ell = torch.zeros_like(s)
    zero = torch.ones_like(s)
    nar = torch.zeros_like(s)
    for kk in range(k):
        p_s, p_ell, p_zero, p_nar = _prod(xell[:, kk, None], xflg[:, kk, None],
                                          well[None, kk], wflg[None, kk])
        s, ell, zero = lns.gauss_add_parts(s, ell, zero, p_s, p_ell, p_zero,
                                           lut, wf=wf)
        nar = nar | p_nar
    out = _lns_to_f32(s, ell, zero, nar, wf, exp)
    if state:
        return out, ell, s | (zero << 1) | (nar << 2)
    return out


def attention_ref(q, k_cache, v_cache, n, fmt="none", *, pos, start=None,
                  window: int = 0, out_dtype=torch.float32,
                  zero_padding: bool = True) -> torch.Tensor:
    """Decode-then-attend: the whole cache is decoded to f32 and dense
    masked attention runs over it.

    ``q [B, tq, H, hd]``, caches ``[B, Tmax, Hkv, hd]`` words (floats for
    the identity codec); ``pos`` is the position of ``q[:, 0]``,
    ``start [B]`` the first valid key, ``window`` a sliding window
    (0 = full causal). All-masked query rows give a finite uniform
    average; NaR words decode to NaN and poison the rows they reach.
    With ``zero_padding`` (the contiguous kernel's semantics) keys
    before a sequence's ``start`` (left padding) take no part in P.V
    of the rows at or after ``start``: their V values count as 0 there,
    so a NaR word in the padding reaches no such row (a masked key
    elsewhere has p = 0, and 0 x NaN poisons); a row before ``start``
    masks every key and takes the reference's value, the uniform average
    of V over the whole cache as stored. Without it (the paged kernel's,
    as the reference's) padded keys count as they are everywhere."""
    spec = formats.resolve(fmt, n)
    if spec.is_identity:
        k, v = k_cache, v_cache
    else:
        k = spec.decode_tile(k_cache, dtype=torch.float32)
        v = spec.decode_tile(v_cache, dtype=torch.float32)
    b, tq, h, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q5 = q.reshape(b, tq, hkv, g, hd)
    if not spec.is_identity:
        q5 = q5.to(torch.float32)
    scores = (torch.einsum("bqkgd,bskd->bkgqs", q5, k).to(torch.float32)
              * (hd ** -0.5))
    dev = scores.device
    qi = (torch.as_tensor(pos, device=dev)
          + torch.arange(tq, device=dev))[None, None, None, :, None]
    kj = torch.arange(tk, device=dev)[None, None, None, None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    early = None
    if start is not None:
        st = torch.as_tensor(start, device=dev).reshape(b)
        m = m & (kj >= st[:, None, None, None, None])
        if zero_padding:
            # rows before start: the uniform average of V as stored
            early = (qi[:, :, :, :, 0] < st[:, None, None, None])[
                :, 0, 0, :, None, None]                      # [B, tq, 1, 1]
            vbar = v.to(torch.float32).mean(dim=1).to(v.dtype)
            pad = torch.arange(tk, device=dev)[None, :] < st[:, None]
            v = torch.where(pad[:, :, None, None], torch.zeros_like(v), v)
    scores = torch.where(m, scores, torch.full_like(scores, MASKED))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    if early is not None:
        out = torch.where(early[..., None], vbar[:, None, :, None, :], out)
    return out.reshape(b, tq, h, hd).to(out_dtype)


def paged_attention_ref(q, k_pool, v_pool, table, fmt="none", *, pos,
                        start=None, window: int = 0,
                        out_dtype=torch.float32,
                        partitions=None) -> torch.Tensor:
    """Gather-then-attend over the pages the paged kernels visit.

    Sequence ``b`` reads pages ``first..last`` of its block table:
    ``last = min(pos // ps, NP - 1)`` (an idle slot's stale ``pos`` is
    clamped to the table), ``first`` the page of the window floor
    ``pos - window + 1`` (0 without a window). Those pages are gathered
    into a contiguous cache and :func:`attention_ref` runs on it at the
    keys' absolute positions, with that sequence's own ``pos``/``start``.
    Pages past ``pos`` hold stale words; the causal mask excludes them.
    A sequence with no page in range (a stale ``pos`` whose window lies
    past the table) gets 0, as the kernels' empty accumulator gives.

    This is the reference Pallas kernel's result (its ``in_band`` test).
    The JAX package's oracle gathers every page of the table instead; the
    two differ only where a page outside the range would count: rows that
    mask every key, and NaR words on such pages (see ROADMAP.md).

    ``partitions`` (keys per partition) splits and merges as the CUDA
    kernel does (``csrc/attention.cu``): each range of
    ``takum_attention.paged_partitions`` gives its own max ``m``, sum ``l``
    and ``acc = sum exp(s - m) v`` in f32 (a float cache cast to f32, as
    the kernel reads it), and the ranges merge in order with weights
    ``exp(m - M)``, ``M`` their NaN-propagating max."""
    spec = formats.resolve(fmt)
    if partitions is not None:
        return _paged_partitioned(q, k_pool, v_pool, table, spec, pos=pos,
                                  start=start, window=window,
                                  pk=int(partitions)).to(out_dtype)
    b = q.shape[0]
    ps, hkv, hd = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    dev = q.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).expand(b)
    start = (torch.zeros(b, dtype=torch.int64, device=dev) if start is None
             else torch.as_tensor(start, dtype=torch.int64,
                                  device=dev).expand(b))
    table = torch.as_tensor(table, dtype=torch.int64, device=dev)
    outs = []
    for i in range(b):
        p = int(pos[i])
        last = min(p // ps, table.shape[1] - 1)
        first = max((p - window + 1) // ps, 0) if window else 0
        if first > last:
            outs.append(torch.zeros((1,) + tuple(q.shape[1:]),
                                    dtype=out_dtype, device=dev))
            continue
        pages = table[i, first:last + 1]
        kc = carrier(k_pool)[pages].view(k_pool.dtype).reshape(-1, hkv, hd)
        vc = carrier(v_pool)[pages].view(v_pool.dtype).reshape(-1, hkv, hd)
        off = first * ps
        outs.append(attention_ref(q[i:i + 1], kc[None], vc[None], spec.n,
                                  spec, pos=p - off,
                                  start=start[i:i + 1] - off, window=window,
                                  out_dtype=out_dtype, zero_padding=False))
    return torch.cat(outs, dim=0)


def _paged_partitioned(q, k_pool, v_pool, table, spec, *, pos, start,
                       window: int, pk: int) -> torch.Tensor:
    """:func:`paged_attention_ref` split into partitions of ``pk`` keys
    and merged, as the CUDA kernel computes it (f32 throughout)."""
    from repro_torch.kernels.takum_attention import paged_partitions
    b, _, h, hd = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    dev = q.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).expand(b)
    start = (torch.zeros(b, dtype=torch.int64, device=dev) if start is None
             else torch.as_tensor(start, dtype=torch.int64,
                                  device=dev).expand(b))
    table = torch.as_tensor(table, dtype=torch.int64, device=dev)
    plans = paged_partitions(pos.tolist(), ps, table.shape[1], window, pk)

    def words_f32(pool, pages, offs):
        w = carrier(pool)[pages, offs].view(pool.dtype)
        return (w.to(torch.float32) if spec.is_identity
                else spec.decode_tile(w, dtype=torch.float32))

    out = torch.zeros((b, 1, h, hd), dtype=torch.float32, device=dev)
    for i, ranges in enumerate(plans):
        p, st = int(pos[i]), int(start[i])
        qi = q[i, 0].to(torch.float32).reshape(hkv, h // hkv, hd)
        parts = []
        for k0, k1 in ranges:
            keys = torch.arange(k0, k1, device=dev)
            pages, offs = table[i, keys // ps], keys % ps
            k = words_f32(k_pool, pages, offs)              # [nk, hkv, hd]
            v = words_f32(v_pool, pages, offs)
            s = torch.einsum("kgd,nkd->kgn", qi, k) * (hd ** -0.5)
            msk = (keys <= p) & (keys >= st)
            if window:
                msk = msk & (keys > p - window)
            s = torch.where(msk, s, torch.full_like(s, MASKED))
            m = torch.maximum(torch.full_like(s[..., 0], MASKED),
                              s.amax(dim=-1))
            pr = torch.exp(s - m[..., None])
            parts.append((m, pr.sum(dim=-1),
                          torch.einsum("kgn,nkd->kgd", pr, v)))
        if not parts:
            continue                       # no in-band page: 0
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        l = torch.zeros_like(mx)
        acc = torch.zeros_like(parts[0][2])
        for m, lp, ap in parts:
            wgt = torch.exp(m - mx)
            l = l + lp * wgt
            acc = acc + ap * wgt[..., None]
        den = torch.maximum(l, torch.full_like(l, 1e-30))
        out[i, 0] = (acc / den[..., None]).reshape(h, hd)
    return out
