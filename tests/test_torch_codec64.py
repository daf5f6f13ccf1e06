"""The port's codec at 33-64 bits and its float64 decode, against the JAX
package run under ``jax.enable_x64(True)``, on the CPU.

* n = 33, 40, 48, 57, 58, 61 and 64, each kind, on seeded words with the
  top bit set and clear and on the specials: linear takum and posit
  decoded to float32 and float64 bit for bit; LNS within the log/exp
  tolerances (the reference's to n = 60, the golden model's beyond).
* Encode from float32 (specials, subnormals, the ties of each float
  exponent's cut): linear takum bit for bit; posit by the golden model's
  rounding where the reference's encoder leaves a fraction unshifted
  (n >= 29, ``ROADMAP.md`` section 3); LNS words equal to the
  reference's or, at a log tie, inside the window of the port's encode
  with the log moved 2 ulps either way (phase 33's rule).
* The hardware path: decode and encode equal to the reference's up to n
  = 57 and to the golden model from 58, where the reference's (n + 7)-bit
  extended takum overflows its uint64 lane (its round trip fails);
  ``decode_lns`` equal to ``golden.takum_ell_bar`` at 61 and 64, where
  the reference's int64 ``ell_bar`` wraps.
* The float64 decode's repair at n = 24, 25, 28 and 32 (the parent cast a
  float32 decode).
* Fake-quant to float32, bfloat16 and float64; ``ops.takum_decode(dtype=)``
  and ``WireMatrix.decode(torch.float64)``; the kernels' ``*_dataflow``
  mirrors at 64-bit storage; the registry's 64-bit formats; the LNS
  arithmetic's and the Gauss tables' limits.

The reference's codec is jitted once a width (one bundle of every call,
``_bundle``): its eager dispatch compiles every primitive a shape.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import functools
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.core import lns as jlns
from repro.core import posit as jposit
from repro.core import quant as jquant
from repro.core import takum as jtakum
from repro.kernels import ops as jops
from repro_torch import formats
from repro_torch.core import golden, lns, posit, quant, takum
from repro_torch.core.bitops import lanes, to_words
from repro_torch.kernels import ops, ref

W64 = (33, 40, 48, 57, 58, 61, 64)
KINDS = ("linear", "lns", "posit")
F32_TINY = np.float32(1.1754944e-38)


def _mask(n):
    return (1 << n) - 1


def _words(n, size=1 << 11):
    """Seeded n-bit words (uint64), half with the top bit set and half
    with it clear, and the specials around 0 and NaR."""
    rng = np.random.default_rng(64 + n)
    w = rng.integers(0, 1 << 64, size, dtype=np.uint64) & np.uint64(_mask(n))
    top = np.uint64(1 << (n - 1))
    w[: size // 2] |= top
    w[size // 2:] &= ~top
    edge = [0, 1, 2, (1 << (n - 1)) - 1, 1 << (n - 1), (1 << (n - 1)) + 1,
            _mask(n), _mask(n) - 1, 0x7 << (n - 4)]
    return np.concatenate([w, np.array(edge, np.uint64)])


def _floats(n):
    """Seeded float32s over the whole range, raw patterns, subnormals,
    the specials, and at every normal exponent the fractions 2^j and
    3 * 2^j (j = 0..22): the ties of every cut a width can have."""
    rng = np.random.default_rng(640 + n)
    with np.errstate(over="ignore"):
        x = (rng.normal(size=1 << 11) * 10.0 ** rng.integers(-45, 39, 1 << 11)
             ).astype(np.float32)
    raw = rng.integers(0, 1 << 32, 1 << 10, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    sub = rng.integers(1, 1 << 23, 256).astype(np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1.5,
                        F32_TINY, -F32_TINY, 3.4028235e38, -3.4028235e38,
                        1e-45, -1e-45], np.float32)
    e = np.arange(1, 255, dtype=np.uint32)[:, None] << 23
    j = np.arange(23, dtype=np.uint32)
    m = np.concatenate([1 << j, (3 << j) & 0x7FFFFF])[None, :]
    ties = (e | m).reshape(-1)
    ties = np.concatenate([ties, ties | 0x80000000]).view(np.float32)
    return np.concatenate([special, x, raw, sub, -sub, ties[::3]])


def _t(w, n):
    """uint64 numpy words -> the port's word tensor of width n."""
    return to_words(torch.from_numpy(np.asarray(w, np.uint64).view(np.int64)),
                    takum.word_dtype(n))


def _u64(t):
    return lanes(t).numpy().view(np.uint64)


def _jw(w, n):
    return jnp.asarray(np.asarray(w, np.uint64).astype(
        np.uint64 if n > 32 else np.uint32))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _same_floats(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def _ulps(a, b):
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _bundle(n):
    """The reference's codec at width n, every call this file makes in one
    jitted function (traced under x64)."""
    names = {k: formats.resolve(k, n).name for k in KINDS}
    specs = {k: jformats.resolve(v) for k, v in names.items()}

    def run(w, x, fq, hw_s, hw_c, hw_m):
        # each kind decodes the seeded words and the port's encoded
        # floats in one call (float32 and float64); the floats' bfloat16
        # decode is the float32 one cast, in the reference as here
        out = {}
        m = w.shape[0]
        for k in KINDS:
            both = jnp.concatenate([w, fq[k]])
            for dt in (jnp.float32, jnp.float64):
                y = specs[k].decode_tile(both, dtype=dt)
                out[k, np.dtype(dt).name] = y[:m]
                out["fq", k, np.dtype(dt).name] = y[m:]
        out["posit_sm", "float32"] = jposit.posit_to_float(w, n,
                                                           variant="sm")
        out["enc", "linear"] = jtakum.float_to_takum(x, n)
        out["enc", "posit"] = jposit.float_to_posit(x, n)
        out["enc", "lns"] = jtakum.float_to_lns_takum(x, n)
        d = jtakum.decode(w, n, hw_path=True)
        out["hw_val"], out["hw_mant"] = d.val, d.mant
        out["hw_enc"] = jtakum.encode(hw_s, hw_c, hw_m, n, wm=n - 5,
                                      hw_path=True)
        out["ell_bar"] = jtakum.decode_lns(w, n).ell_bar
        return {"/".join(k) if isinstance(k, tuple) else k: v
                for k, v in out.items()}

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _case(n):
    """The port's and the reference's results at width n."""
    w, x = _words(n), _floats(n)
    xt = torch.from_numpy(x)
    fq = {k: _u64(formats.resolve(k, n).encode_tile(xt)) for k in KINDS}
    dec = takum.decode(_t(w, n), n)
    with jax.enable_x64(True):
        out = _bundle(n)(_jw(w, n), jnp.asarray(x),
                         {k: _jw(v, n) for k, v in fq.items()},
                         jnp.asarray(dec.s.numpy().astype(np.int32)),
                         jnp.asarray(dec.val.numpy().astype(np.int32)),
                         jnp.asarray(dec.mant.numpy().astype(np.uint64)))
    out = {tuple(k.split("/")) if "/" in k else k: np.asarray(v)
           for k, v in out.items()}
    return w, x, fq, out


# -- the 64-bit lanes ---------------------------------------------------------


def test_bitops_with_the_top_bit_set_at_every_width():
    """Each helper on words whose top bit is set (bit 63, the int64 lane's
    sign, at n = 64) at every width 33..64, against Python's unbounded
    ints: logical shifts (past the width: 0), masks, floor_log2, clz,
    popcount, bit."""
    from repro_torch.core import bitops
    rng = np.random.default_rng(3364)
    for n in range(33, 65):
        w = (rng.integers(0, 1 << 64, 64, dtype=np.uint64)
             & np.uint64(_mask(n))) | np.uint64(1 << (n - 1))
        t = _t(w, n)
        x = lanes(t)
        ints = [int(v) for v in w]
        s = torch.from_numpy(rng.integers(0, 70, 64))
        u64 = lambda a: [int(v) & _mask(64) for v in a.tolist()]  # noqa
        assert u64(bitops.safe_shr(x, s, 64)) == [
            v >> int(k) if k < 64 else 0 for v, k in zip(ints, s)]
        assert u64(bitops.safe_shl(x, s, 64)) == [
            (v << int(k)) & _mask(64) if k < 64 else 0
            for v, k in zip(ints, s)]
        assert u64(x & bitops.mask(s, 64)) == [
            v & _mask(min(int(k), 64)) for v, k in zip(ints, s)]
        assert bitops.floor_log2(x, 64).tolist() == [n - 1] * 64
        low = x & bitops.mask(52, 64)
        assert bitops.floor_log2(low).tolist() == bitops.floor_log2(
            low, 64).tolist() == [int(v & _mask(52)).bit_length() - 1
                                  for v in ints]
        assert bitops.clz(x, 64).tolist() == [64 - n] * 64
        assert bitops.popcount(x).tolist() == [bin(v).count("1")
                                               for v in ints]
        assert bitops.bit(x, n - 1, 64).tolist() == [1] * 64
        assert bitops.mask(64, 64) == -1 and t.dtype == torch.uint64


# -- decode -----------------------------------------------------------------


@pytest.mark.parametrize("n", W64)
@pytest.mark.parametrize("kind", ["linear", "posit"])
def test_decode_equals_reference(kind, n):
    w, _, _, want = _case(n)
    for dt in (torch.float32, torch.float64):
        key = str(dt).split(".")[1]
        if kind == "linear":
            got = takum.takum_to_float(_t(w, n), n, dtype=dt)
            _same_floats(got.numpy(), want["linear", key])
            _same_floats(formats.resolve(kind, n).decode_tile(
                _t(w, n), dtype=dt).numpy(), want["linear", key])
        else:
            for variant in ("2c", "sm"):
                got = posit.posit_to_float(_t(w, n), n, dtype=dt,
                                           variant=variant)
                _same_floats(got.numpy(), want["posit", key])
            if dt == torch.float32:       # the reference's own variants
                _same_floats(want["posit_sm", key], want["posit", key])


def _rne_int(v: int, p: int) -> int:
    """An integer rounded to p significant bits, to nearest even."""
    a = abs(v)
    drop = a.bit_length() - p
    if drop <= 0:
        return v
    kept, rest = a >> drop, a & ((1 << drop) - 1)
    half = 1 << (drop - 1)
    kept += rest > half or (rest == half and kept & 1)
    return int(math.copysign(kept << drop, v))


def _lns_oracle(w, n, dtype):
    """(-1)^S sqrt(e)^ell from the golden model's exact ell_bar rounded
    once to ``dtype``'s significand, then float64 ``exp``."""
    p = 24 if dtype == np.float32 else 53
    wf = takum.frac_width(n)
    out = []
    for wi in w:
        f = golden.takum_decode_fields(int(wi), n)
        if f.is_zero:
            out.append(0.0)
            continue
        if f.is_nar:
            out.append(math.nan)
            continue
        ell = _rne_int(f.c * (1 << wf) + (f.m_num << (wf - f.p)), p)
        ell = -ell if f.S else ell
        with np.errstate(over="ignore"):
            mag = float(np.exp(np.float64(ell) / 2.0 ** (wf + 1)))
        out.append(-mag if f.S else mag)
    with np.errstate(over="ignore"):
        return np.array(out, np.float64).astype(dtype)


@pytest.mark.parametrize("n", W64)
def test_lns_decode_within_tolerance(n):
    """float32 and float64 within 2 ulp of the reference's decode where its
    int64 ell_bar holds (n <= 60; float32 values the reference flushes
    are left out) and of the golden model's ell_bar rounded once, through
    a float64 exp, at every width."""
    w, _, _, want = _case(n)
    sub = w[::8]
    for dt, npdt in ((torch.float32, np.float32), (torch.float64, np.float64)):
        got = takum.lns_takum_to_float(_t(w, n), n, dtype=dt).numpy()
        oracle = _lns_oracle(sub, n, npdt)
        fin = np.isfinite(oracle) & (np.abs(oracle) >= np.finfo(npdt).tiny)
        g = got[::8]
        assert np.array_equal(np.isnan(g), np.isnan(oracle))
        assert _ulps(g[fin], oracle[fin]).max() <= 2
        if n <= takum.ELL_BAR_MAX_N:
            r = want["lns", np.dtype(npdt).name]
            ok = np.isfinite(r) & (np.abs(r) >= np.finfo(npdt).tiny)
            assert np.array_equal(np.isnan(got), np.isnan(r))
            assert _ulps(got[ok], r[ok]).max() <= 2


# -- encode -----------------------------------------------------------------


def _posit_key(w, n):
    x = (-w) & _mask(n) if w >> (n - 1) else w
    return Fraction(x & _mask(n - 1), 1 << (n - 1))


def _check_posit_golden(x, words, n):
    """Each word is the golden model's rounding of its float on the
    encoding bit string: nearest (ties to the even word, saturating)
    among the word and its two neighbours of the same sign."""
    for xi, w in zip(x, words):
        if not np.isfinite(xi) or xi == 0:
            continue
        s, key = golden.posit_internal_key(Fraction(float(xi)))
        cands = []
        for v in (int(w) - 1, int(w), int(w) + 1):
            v &= _mask(n)
            if v in (0, 1 << (n - 1)) or v >> (n - 1) != s:
                continue
            cands.append((v, _posit_key(v, n)))
        cands.sort(key=lambda tv: tv[1])
        assert golden._nearest_even(cands, key) == w, (xi, w)


def _lns_window(x, n):
    """The port's LNS words of ``x`` with 2 ln|x| moved 2 f32 ulps down
    and up (the word is monotone in ell_bar within a sign)."""
    xt = torch.from_numpy(x)
    s = (xt < 0).long()
    zero, nan = xt == 0, torch.isnan(xt)
    ell = 2.0 * torch.log(torch.abs(torch.where(zero | nan,
                                                torch.ones_like(xt), xt)))
    out = []
    for step in (-2, 2):
        e = ell
        for _ in range(2):
            e = torch.nextafter(e, torch.full_like(e, step * 1e38))
        eb = torch.clamp(torch.where(s == 1, -e, e), -256.0, 256.0)
        fixed = torch.round(eb * float(1 << 22)).long()
        out.append(lanes(takum.encode_lns(s, fixed, n, wf=22, is_zero=zero,
                                          is_nar=nan)))
    return torch.minimum(*out).numpy(), torch.maximum(*out).numpy()


@pytest.mark.parametrize("n", W64)
@pytest.mark.parametrize("kind", KINDS)
def test_encode(kind, n):
    _, x, fq, want = _case(n)
    got = fq[kind]
    ref_w = want["enc", kind].astype(np.uint64)
    assert formats.resolve(kind, n).word_dtype == torch.uint64
    if kind == "linear":
        np.testing.assert_array_equal(got, ref_w)
    elif kind == "posit":
        assert (got != ref_w).any()        # the reference's fault (n >= 29)
        _check_posit_golden(x[::7], got[::7], n)
    else:
        keep = ~((np.abs(x) < F32_TINY) & (x != 0))   # XLA:CPU reads 0
        lo, hi = _lns_window(x[keep], n)
        g = got[keep].view(np.int64)
        r = ref_w[keep].view(np.int64)
        assert ((g == r) | ((r >= lo) & (r <= hi))).all()
        assert ((g >= lo) & (g <= hi)).all()
        assert (g != r).mean() < 0.05


@pytest.mark.parametrize("n", [40, 64])
def test_encode_specials_and_saturation(n):
    """+-0 -> 0, NaN -> NaR, -inf -> the word after NaR, and +inf -> the
    largest characteristic with an all-ones fraction shifted into place
    (linear takum; the largest word for posit), as the reference."""
    x = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf")])
    lin = _u64(takum.float_to_takum(x, n))
    pos = _u64(posit.float_to_posit(x, n))
    nar = 1 << (n - 1)
    assert lin.tolist()[:3] == [0, 0, nar] == pos.tolist()[:3]
    assert lin[4] == pos[4] == nar + 1 and pos[3] == nar - 1
    assert lin[3] == ((1 << 34) - 1) << (n - 35)
    with jax.enable_x64(True):
        want = jax.jit(lambda a: jtakum.float_to_takum(a, n))(
            jnp.asarray(x.numpy()))
        assert np.asarray(want).astype(np.uint64).tolist() == lin.tolist()


# -- the hardware path and the reference's faults ---------------------------


@pytest.mark.parametrize("n", W64)
def test_hw_path(n):
    """Decode: the hw characteristic unit's fields equal the direct
    path's and the reference's at every width. Encode: the round trip
    of every sampled word through the extended takum gives the word back
    (the golden model's rounding of its own value); the reference's
    encode does too up to n = 57 and fails from 58, where its (n + 7)-bit
    lane overflows."""
    w, _, _, want = _case(n)
    words = _t(w, n)
    hw = takum.decode(words, n, hw_path=True)
    direct = takum.decode(words, n)
    assert torch.equal(hw.val, direct.val) and torch.equal(hw.mant,
                                                           direct.mant)
    np.testing.assert_array_equal(hw.val.numpy(), want["hw_val"])
    np.testing.assert_array_equal(hw.mant.numpy().view(np.uint64),
                                  want["hw_mant"].astype(np.uint64))
    live = ~(direct.is_zero | direct.is_nar).numpy()
    back = _u64(takum.encode(direct.s, direct.val, direct.mant, n, wm=n - 5,
                             hw_path=True))
    np.testing.assert_array_equal(back[live], w[live])
    np.testing.assert_array_equal(back[live], _u64(takum.encode(
        direct.s, direct.val, direct.mant, n, wm=n - 5))[live])
    ref_back = want["hw_enc"].astype(np.uint64)[live]
    if n <= 57:
        np.testing.assert_array_equal(ref_back, w[live])
    else:
        assert (ref_back != w[live]).mean() > 0.25


@pytest.mark.parametrize("n", [61, 64])
def test_decode_lns_golden_where_the_reference_wraps(n):
    """From n = 61, c << wf overflows int64: the port carries (c, mant)
    apart and equals the golden model's ell_bar; the reference's int64
    lane wraps."""
    w, _, _, want = _case(n)
    d = takum.decode_lns(_t(w, n), n)
    assert d.ell_bar is None
    wf = takum.frac_width(n)
    wrapped = 0
    for i in range(0, w.size, 5):
        g = golden.takum_ell_bar(int(w[i]), n)
        if g is None:
            continue
        got = int(d.c[i]) + Fraction(int(d.mant[i]), 1 << wf)
        assert got == g
        wrapped += Fraction(int(want["ell_bar"][i]), 1 << wf) != g
    assert wrapped > 0
    with pytest.raises(OverflowError, match="n <= 60"):
        lns.from_words(_t(w, n), n)


@pytest.mark.parametrize("n", [57, 60])
def test_decode_lns_and_arithmetic_equal_reference_to_60(n):
    """To n = 60 ell_bar is exact in both packages' int64 lanes: the
    decode and the exact arithmetic (mul, div, sqrt) agree word for word
    (the reference's products of large ell wrap at n = 60, and so do the
    port's, as int64 adds)."""
    w = _words(n)[::4]
    t = lns.from_words(_t(w, n), n)
    u = lns.from_words(_t(w[::-1].copy(), n), n)
    wf = n - 5
    got = [lns.mul(t, u, wf=wf), lns.div(t, u, wf=wf), lns.sqrt(t, wf=wf)]
    def arith(a, b):
        jt, ju = jlns.from_words(a, n), jlns.from_words(b, n)
        return jt.ell_bar, [jlns.mul(jt, ju, wf=wf), jlns.div(jt, ju, wf=wf),
                            jlns.sqrt(jt, wf=wf)]

    with jax.enable_x64(True):
        ell, want = jax.jit(arith)(_jw(w, n), _jw(w[::-1].copy(), n))
    np.testing.assert_array_equal(t.ell_bar.numpy(), np.asarray(ell))
    for g, r in zip(got, want):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lns_limits_refused_as_the_reference():
    w = _t(np.array([3, 5], np.uint64), 40)
    for mod, words in ((takum, w), (jtakum, None)):
        with pytest.raises(ValueError, match="n <= 27, got 40"):
            if words is None:
                with jax.enable_x64(True):
                    mod.decode_lns_parts(jnp.asarray(np.array([3], np.uint64)),
                                         40)
            else:
                mod.decode_lns_parts(words, 40)
    for mod in (lns, jlns):
        with pytest.raises(ValueError, match="wf=35"):
            mod.gauss_tables(35)
    t = lns.from_words(_t(np.array([3, 5], np.uint64), 60), 60)
    with pytest.raises(OverflowError):
        lns.mul(t, t, wf=56)
    with jax.enable_x64(True):
        jt = jlns.from_words(jnp.asarray(np.array([3, 5], np.uint64)), 61)
        with pytest.raises(OverflowError):
            jlns.mul(jt, jt, wf=56)


# -- the float64 decode's repair ---------------------------------------------


@pytest.mark.parametrize("n", [24, 25, 28, 32])
def test_float64_decode_repair(n):
    """The reference assembles the float64 word under x64; the parent cast
    a float32 decode (thousands of words differ). Linear and posit bit for
    bit, LNS within 2 ulp."""
    rng = np.random.default_rng(n)
    w = rng.integers(0, 1 << n, 1 << 12).astype(np.uint64)
    w[:4] = [0, 1 << (n - 1), 1, _mask(n)]
    t = _t(w, n)
    with jax.enable_x64(True):
        jw = jnp.asarray(w.astype(np.uint32))
        want = jax.jit(lambda a: (
            jtakum.takum_to_float(a, n, dtype=jnp.float64),
            jposit.posit_to_float(a, n, dtype=jnp.float64),
            jtakum.lns_takum_to_float(a, n, dtype=jnp.float64)))(jw)
        want = [np.asarray(v) for v in want]
    got = [takum.takum_to_float(t, n, dtype=torch.float64).numpy(),
           posit.posit_to_float(t, n, dtype=torch.float64).numpy(),
           takum.lns_takum_to_float(t, n, dtype=torch.float64).numpy()]
    _same_floats(got[0], want[0])
    _same_floats(got[1], want[1])
    assert (takum.takum_to_float(t, n).double().numpy() != want[0]).sum() \
        > 100
    if n <= 28:          # the reference's int32 ell_bar lane wraps above
        fin = np.isfinite(want[2])
        assert np.array_equal(np.isnan(got[2]), np.isnan(want[2]))
        assert _ulps(got[2][fin], want[2][fin]).max() <= 2
    else:
        oracle = _lns_oracle(w[::16], n, np.float64)
        assert _ulps(got[2][::16][1:], oracle[1:]).max() <= 2


# -- fake-quant, the ops, the dataflow mirrors --------------------------------


def _int_view(t):
    """A float tensor's bits (NaN payloads included)."""
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


@pytest.mark.parametrize("n", W64)
@pytest.mark.parametrize("kind", KINDS)
def test_fake_quant(kind, n):
    """``ops.fake_quant_fused`` to float32, bfloat16 and float64: the
    reference's decode (to that dtype) of the port's words; linear takum's
    words are the reference's (test_encode), so this is its fake-quant;
    the dataflow mirror bit for bit. LNS: the port's decode of its words
    bit for bit, and in float64 within 2 ulp of the reference's decode
    where its int64 ell_bar holds (n <= 60; its float32 exp and int64 to
    float32 conversion are held in test_lns_decode_within_tolerance)."""
    _, x, _, want = _case(n)
    xt = torch.from_numpy(x)
    spec = formats.resolve(kind, n)
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        got = ops.fake_quant_fused(xt, n, fmt=kind, dtype=dt)
        assert got.dtype == dt
        if dt == torch.bfloat16:
            w = torch.from_numpy(want["fq", kind, "float32"].copy()).to(
                dt).float().numpy()
            g = got.float().numpy()
        else:
            w = want["fq", kind, str(dt).split(".")[1]]
            g = got.numpy()
        if kind != "lns":
            _same_floats(g, w)
            _same_floats(ref.fake_quant_dataflow(xt, spec, dt).float()
                         .numpy() if dt == torch.bfloat16 else
                         ref.fake_quant_dataflow(xt, spec, dt).numpy(), w)
            continue
        own = takum.lns_takum_to_float(spec.encode_tile(xt), n, dtype=dt)
        assert torch.equal(_int_view(got), _int_view(own))
        if dt == torch.float64 and n <= takum.ELL_BAR_MAX_N:
            ok = np.isfinite(w) & (w != 0)
            assert np.array_equal(np.isnan(g), np.isnan(w))
            assert _ulps(g[ok], w[ok]).max() <= 2


@pytest.mark.parametrize("fmt", ["takum64", "posit40", "takum16"])
def test_ops_decode_dtype_and_wire_matrix(fmt):
    """``ops.takum_decode(dtype=)`` and ``WireMatrix.decode(float64)``
    against the reference's Pallas decode in interpret mode (x64)."""
    spec = formats.resolve(fmt)
    n = spec.n
    rng = np.random.default_rng(n)
    w = (rng.integers(0, 1 << 64, (37, 19), dtype=np.uint64)
         & np.uint64(_mask(n)))
    words = _t(w.reshape(-1), n).reshape(37, 19)
    with jax.enable_x64(True):
        jw = jnp.asarray(w.astype(np.uint64 if n > 32 else np.uint16))
        want = {dt: np.asarray(jops.takum_decode(jw, fmt, dtype=dt,
                                                 interpret=True))
                for dt in (jnp.float64, jnp.float32)}
    _same_floats(ops.takum_decode(words, fmt, dtype=torch.float64).numpy(),
                 want[jnp.float64])
    _same_floats(ops.takum_decode(words, fmt).numpy(), want[jnp.float32])
    wm = ops.WireMatrix(words, fmt=fmt)
    _same_floats(wm.decode(torch.float64).numpy(), want[jnp.float64])
    bf = wm.decode(torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, torch.from_numpy(want[jnp.float32].copy()).to(
        torch.bfloat16))


@pytest.mark.parametrize("n", [33, 48, 64])
@pytest.mark.parametrize("kind", ["linear", "posit"])
def test_dataflow_mirrors_at_64_bit_storage(kind, n):
    """The kernels' wide dataflow (``ref.encode_dataflow``,
    ``decode_dataflow`` to float32 and float64) against the reference's
    codec: linear takum bit for bit, posit's encode against the port's
    plain encoder (the reference's fault)."""
    w, x, fq, want = _case(n)
    spec = formats.resolve(kind, n)
    xt = torch.from_numpy(x)
    got = _u64(ref.encode_dataflow(xt, spec))
    np.testing.assert_array_equal(got, fq[kind])
    if kind == "linear":
        np.testing.assert_array_equal(got, want["enc", kind].astype(
            np.uint64))
    for dt in (torch.float32, torch.float64):
        _same_floats(ref.decode_dataflow(_t(w, n), spec, dt).numpy(),
                     want[kind, str(dt).split(".")[1]])


@pytest.mark.parametrize("n", [33, 35, 36, 48, 64])
def test_lns_tail_dataflow_at_64_bit_storage(n):
    """The LNS encode's integer tail as the kernels form it against the
    reference's ``encode_lns`` (x64), the saturating ends included (+256
    to the plain encoder's word for +inf, -256 and its mirror to the word
    after NaR)."""
    rng = np.random.default_rng(n)
    one = 1 << 22
    edge = np.array([0, 1, one - 1, one, 254 * one, 255 * one - 1,
                     255 * one, 256 * one, 7 * one + one // 2], np.int64)
    fixed = np.concatenate([rng.integers(0, 256 * one + 1, 1 << 12), edge])
    with jax.enable_x64(True):
        enc = jax.jit(lambda s, e: jtakum.encode_lns(s, e, n, wf=22))
        for s in (0, 1):
            got = _u64(to_words(ref.lns_tail_dataflow(
                torch.full(fixed.shape, s, dtype=torch.int64),
                torch.from_numpy(fixed), n), torch.uint64))
            want = enc(jnp.full(fixed.shape, s, jnp.int32),
                       jnp.asarray(-fixed if s else fixed))
            np.testing.assert_array_equal(got & np.uint64(_mask(n)),
                                          np.asarray(want).astype(np.uint64))


# -- the registry, the golden model, quant ------------------------------------


def test_registry_64_bit_formats():
    for name, kind in (("takum64", "linear"), ("lns-takum64", "lns"),
                       ("posit64", "posit")):
        spec = formats.resolve(name)
        want = jformats.resolve(name)
        assert (spec.name, spec.kind, spec.n) == (want.name, want.kind, 64)
        assert spec.word_dtype == torch.uint64 and spec.bytes_per_elem() == 8
        assert formats.resolve(kind, 64) is spec
    for n in (40, 57):
        w = _words(n)[::13]
        t = _t(w, n)
        lin = formats.resolve("linear", n).decode_tile(t, dtype=torch.float64)
        pos = formats.resolve("posit", n).decode_tile(t, dtype=torch.float64)
        for i, wi in enumerate(w):         # float64 holds every value
            v = golden.takum_linear_value(int(wi), n)
            got = float(lin[i])
            assert (math.isnan(got) if v is None else got == v)
            v = golden.posit_decode_value(int(wi), n)
            got = float(pos[i])
            assert (math.isnan(got) if v is None else got == v)
    with pytest.raises(ValueError, match="n=65"):
        jformats.resolve("takum65").word_dtype
    with pytest.raises(ValueError, match="6 <= n <= 64, got 65"):
        formats.resolve("takum65").word_dtype


def test_golden_model_at_64_bits():
    """The port's golden model decodes 64-bit words as the vector codec's
    fields (characteristic, mantissa) and values."""
    w = _words(64)[::7]
    dec = takum.decode(_t(w, 64), 64)
    lin = takum.decode_linear(_t(w, 64), 64)
    wf = takum.frac_width(64)
    for i, wi in enumerate(w):
        f = golden.takum_decode_fields(int(wi), 64)
        if f.is_zero or f.is_nar:
            assert bool(dec.is_zero[i]) == f.is_zero
            continue
        assert int(dec.val[i]) == f.c
        assert int(dec.mant[i]) == f.m_num << (wf - f.p)
        s = int(lin.s[i])      # representation (8): ((1 - 3S) + f) 2^e
        assert golden.takum_linear_value(int(wi), 64) == (
            Fraction(1 - 3 * s) + Fraction(int(lin.mant[i]), 1 << wf)
        ) * Fraction(2) ** int(lin.val[i])


@pytest.mark.parametrize("fmt", ["takum", "posit"])
def test_quant_at_64_bits(fmt):
    """``quantize``/``dequantize`` at n = 64, float32 and float64 out,
    equal to the reference's under x64 (posit: against the reference's
    decode of the port's words)."""
    spec = quant.QuantSpec(fmt=fmt, n=64)
    jspec = jquant.QuantSpec(fmt=fmt, n=64)
    x = np.random.default_rng(64).normal(size=(5, 7)).astype(np.float32)
    qt = quant.quantize(torch.from_numpy(x), spec)
    assert qt.words.dtype == torch.uint64 and qt.nbytes_wire == 35 * 8
    def run(a, words, k):
        jq = jquant.QTensor(words, k, jspec)
        return (jquant.quantize(a, jspec).words,
                [jquant.dequantize(jq, dtype=dt)
                 for dt in (jnp.float32, jnp.float64)])

    with jax.enable_x64(True):
        words, want = jax.jit(run)(jnp.asarray(x), jnp.asarray(_u64(
            qt.words)), jnp.asarray(qt.scale_exp.numpy()))
    if fmt == "takum":
        np.testing.assert_array_equal(_u64(qt.words), np.asarray(words))
    for dt, r in zip((torch.float32, torch.float64), want):
        _same_floats(quant.dequantize(qt, dtype=dt).numpy(), np.asarray(r))
