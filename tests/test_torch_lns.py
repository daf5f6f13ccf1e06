"""The port's logarithmic-takum codec, LNS arithmetic and registry entries
against the JAX package, on the CPU.

Inputs are made with numpy and handed to both packages. Tolerances, each
with its reason:

* integer parts are bit-exact: ``decode_lns``/``decode_lns_parts`` of
  every lns-takum8/16 word, ``encode_lns`` on seeded integer lanes,
  ``gauss_tables``, ``gauss_add_parts``;
* ``lns_takum_to_float`` pays one ``exp``: within 2 ulp of the
  reference's value, except on the words where XLA:CPU's own ``exp``
  misses the correctly rounded value by more than 1 ulp (near the f32
  overflow edge); everywhere, the port is within 1 ulp of the correctly
  rounded value (a float64 oracle);
* ``float_to_lns_takum`` pays one ``log``: the reference's word or its
  neighbour, the neighbours at most a measured share, each at an
  ``ell_bar`` rounding tie (shown with a float64 oracle);
* XLA:CPU treats subnormal inputs as zero (denormals-are-zero) and
  flushes subnormal ``exp`` results; the port computes them (as the CUDA
  kernels do), so the subnormal band is held to the float64 oracle.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.configs.base import parse_kv_quant as jparse_kv_quant
from repro.core import lns as jlns
from repro.core import takum as jtakum
from repro.kernels import ops as jops
from repro_torch import formats
from repro_torch.configs.base import parse_kv_quant
from repro_torch.core import lns, takum
from repro_torch.core.bitops import carrier
from repro_torch.kernels import ops, takum_codec

WIDTHS = [8, 16]
F32_TINY = np.float32(1.1754944e-38)
# neighbour words where the port's and XLA:CPU's f32 log straddle an
# ell_bar rounding tie: measured 6 in 599,587 lns-takum16 encodes of
# _normal_floats (1.0e-5), none for lns-takum8
NEIGHBOUR_SHARE = 1.5e-5
# against the float64 log (the f32 log's own rounding straddles a tie):
# measured 2 in 20,000 lns-takum16 subnormal encodes (1e-4), none for
# lns-takum8
NEIGHBOUR_SHARE_F64 = 1.5e-4


def _all_words(n):
    return np.arange(2 ** n, dtype=np.int64).astype(
        np.uint8 if n == 8 else np.uint16)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


def _np_words(t):
    return carrier(t).numpy().astype(np.int64) & 0xFFFF


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _oracle_decode(words, n):
    """Correctly rounded f32 of (-1)^S sqrt(e)^ell, from float64 ``exp``
    (NaN for NaR, 0 for zero)."""
    d = takum.decode_lns(_t(words), n)
    ell = np.where(d.s.numpy() == 1, -d.ell_bar.numpy(), d.ell_bar.numpy())
    with np.errstate(over="ignore"):
        mag = np.exp(ell / 2.0 ** (takum.frac_width(n) + 1))
        val = np.where(d.s.numpy() == 1, -mag, mag).astype(np.float32)
    val = np.where(d.is_zero.numpy(), np.float32(0), val)
    return np.where(d.is_nar.numpy(), np.float32(np.nan), val)


def _normal_floats(seed, size=300_000):
    rng = np.random.default_rng(seed)
    with np.errstate(over="ignore"):
        x = (rng.normal(size=size) * 10.0 ** rng.integers(-37, 39, size)
             ).astype(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) >= F32_TINY)]
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                        F32_TINY, -F32_TINY, 3.4028235e38, -3.4028235e38],
                       np.float32)
    return np.concatenate([x, rng.normal(size=size).astype(np.float32),
                           special])


def _subnormals(seed, size=20_000):
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 2 ** 23, size).astype(np.uint32)
    bits |= rng.integers(0, 2, size).astype(np.uint32) << 31
    return bits.view(np.float32)


def _tie_distance(x, w_a, w_b, n):
    """|2 ln|x| - midpoint of the two words' ell_bar| in ell units, with
    the log in float64 (sign-adjusted to ell_bar)."""
    wf = takum.frac_width(n)
    mid = (takum.decode_lns(_t(w_a), n).ell_bar.numpy()
           + takum.decode_lns(_t(w_b), n).ell_bar.numpy()) / 2.0 ** (wf + 1)
    ell = 2.0 * np.log(np.abs(x.astype(np.float64)))
    ell_bar = np.where(x < 0, -ell, ell)
    return np.abs(ell_bar - mid), np.abs(ell_bar)


# -- decode --------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
def test_decode_lns_every_word_bit_exact(n):
    words = _all_words(n)
    want = jtakum.decode_lns(jnp.asarray(words), n)
    got = takum.decode_lns(_t(words), n)
    for field in ("s", "ell_bar", "is_zero", "is_nar"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    jell, jflags = jtakum.decode_lns_parts(jnp.asarray(words), n)
    ell, flags = takum.decode_lns_parts(_t(words), n)
    assert ell.dtype == flags.dtype == torch.int32
    np.testing.assert_array_equal(ell.numpy(), np.asarray(jell))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))


@pytest.mark.parametrize("n", WIDTHS)
def test_lns_takum_to_float_every_word(n):
    words = _all_words(n)
    want = np.asarray(jtakum.lns_takum_to_float(jnp.asarray(words), n))
    got = takum.lns_takum_to_float(_t(words), n).numpy()
    oracle = _oracle_decode(words, n)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(oracle))
    fin = np.isfinite(oracle)
    # the port: within 1 ulp of the correctly rounded value, subnormals too
    assert _ulps(got[fin], oracle[fin]).max() <= 1
    np.testing.assert_array_equal(np.isinf(got), np.isinf(oracle))
    # the reference: within 2 ulp in its normal band, except where its own
    # exp is more than 1 ulp off the correctly rounded value
    normal = fin & (np.abs(want) >= F32_TINY)
    xla_off = _ulps(want, oracle) > 1
    cmp = normal & ~xla_off
    assert _ulps(got[cmp], want[cmp]).max() <= 2
    assert (normal & xla_off).sum() <= 8
    # XLA:CPU flushes the subnormal results to zero; the port keeps them
    sub = fin & (np.abs(oracle) < F32_TINY) & (oracle != 0)
    assert (got[sub] != 0).all()


# -- encode --------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
def test_encode_lns_integer_lanes_bit_exact(n):
    rng = np.random.default_rng(40 + n)
    wf = 22
    s = rng.integers(0, 2, 50_000).astype(np.int32)
    ell = rng.integers(-(2 ** 30), 2 ** 30, 50_000).astype(np.int32)
    want = np.asarray(jtakum.encode_lns(jnp.asarray(s), jnp.asarray(ell), n,
                                        wf=wf)).astype(np.int64)
    got = _np_words(takum.encode_lns(torch.from_numpy(s).long(),
                                     torch.from_numpy(ell).long(), n, wf=wf))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", WIDTHS)
def test_float_to_lns_takum_equal_or_neighbour_at_ties(n):
    x = _normal_floats(50 + n)
    want = np.asarray(jtakum.float_to_lns_takum(jnp.asarray(x), n)
                      ).astype(np.int64)
    got = _np_words(takum.float_to_lns_takum(torch.from_numpy(x), n))
    step = (got - want) % (1 << n)
    assert np.isin(step, (0, 1, (1 << n) - 1)).all()
    assert (step != 0).mean() <= NEIGHBOUR_SHARE
    # each neighbour sits at a tie: the float64 ell_bar lies within a few
    # f32 ulps of ell (ulp = |ell| 2^-23) of the two words' midpoint
    bad = np.nonzero(step)[0]
    dt = np.uint8 if n == 8 else np.uint16
    dist, mag = _tie_distance(x[bad], got[bad].astype(dt),
                              want[bad].astype(dt), n)
    assert (dist <= 4 * np.maximum(mag, 1.0) * 2.0 ** -23).all()


@pytest.mark.parametrize("n", WIDTHS)
def test_float_to_lns_takum_subnormals_against_float64(n):
    """Subnormal inputs: the float64-log encode's word, or its neighbour
    at a tie (XLA:CPU reads them as zero, so the reference is not used)."""
    x = _subnormals(60 + n)
    got = _np_words(takum.float_to_lns_takum(torch.from_numpy(x), n))
    ell = 2.0 * np.log(np.abs(x.astype(np.float64)))
    ell_bar = np.clip(np.where(x < 0, -ell, ell), -256.0, 256.0)
    fixed = np.round(ell_bar * 2.0 ** 22).astype(np.int64)
    want = _np_words(takum.encode_lns(torch.from_numpy((x < 0).astype(
        np.int64)), torch.from_numpy(fixed), n, wf=22))
    step = (got - want) % (1 << n)
    assert np.isin(step, (0, 1, (1 << n) - 1)).all()
    assert (step != 0).mean() <= NEIGHBOUR_SHARE_F64
    assert (got != 0).all()           # a nonzero input never encodes to 0
    bad = np.nonzero(step)[0]
    dt = np.uint8 if n == 8 else np.uint16
    dist, mag = _tie_distance(x[bad], got[bad].astype(dt),
                              want[bad].astype(dt), n)
    assert (dist <= 4 * mag * 2.0 ** -23).all()


@pytest.mark.parametrize("n", WIDTHS)
def test_lns_encode_decode_round_trips_every_word(n):
    words = _all_words(n)
    d = takum.decode_lns(_t(words), n)
    keep = ~(d.is_zero | d.is_nar).numpy()
    wf = takum.frac_width(n)
    back = takum.encode_lns(d.s, d.ell_bar, n, wf=wf)
    np.testing.assert_array_equal(_np_words(back)[keep],
                                  words.astype(np.int64)[keep])


# -- Gauss-log arithmetic ------------------------------------------------------


@pytest.mark.parametrize("wf", [7, 11])
def test_gauss_tables_bit_exact(wf):
    got = lns.gauss_tables(wf)
    assert got.dtype == torch.int32 and got.shape == (2, 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlns.gauss_tables(wf)))


def _fold_lanes(rng, n, size=40_000):
    """Seeded (s, ell, zero) operand pairs: random ell, near-equal
    magnitudes (cancellation and the first table segment), far-apart
    magnitudes (beyond the table), zero operands."""
    wf = takum.frac_width(n)
    lim = 255 << wf
    a = rng.integers(-lim, lim + 1, size)
    b = rng.integers(-lim, lim + 1, size)
    near = rng.integers(0, size, size // 4)
    b[near] = a[near] + rng.integers(-(2 ** (wf - 3)), 2 ** (wf - 3) + 1,
                                     near.size)
    b[near[: near.size // 4]] = a[near[: near.size // 4]]
    s_a, s_b = rng.integers(0, 2, size), rng.integers(0, 2, size)
    z_a = (rng.random(size) < 0.05).astype(np.int64)
    z_b = (rng.random(size) < 0.05).astype(np.int64)
    return [x.astype(np.int32) for x in (s_a, a, z_a, s_b, b, z_b)]


@pytest.mark.parametrize("n", WIDTHS)
def test_gauss_add_parts_bit_exact(n):
    wf = takum.frac_width(n)
    lanes = _fold_lanes(np.random.default_rng(70 + n), n)
    want = jlns.gauss_add_parts(*map(jnp.asarray, lanes),
                                jlns.gauss_tables(wf), wf=wf)
    got = lns.gauss_add_parts(*map(torch.from_numpy, lanes),
                              lns.gauss_tables(wf), wf=wf)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", WIDTHS)
def test_lns_matmul_demo_matches_reference(n):
    rng = np.random.default_rng(80 + n)
    x = rng.normal(size=(12, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 20)) / 5.0).astype(np.float32)
    xw = np.asarray(jtakum.float_to_lns_takum(jnp.asarray(x), n))
    ww = np.asarray(jtakum.float_to_lns_takum(jnp.asarray(w), n))
    want = np.asarray(jlns.lns_matmul(jnp.asarray(xw), jnp.asarray(ww), n))
    got = lns.lns_matmul(_t(xw), _t(ww), n).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


# -- registry and the codec ops ----------------------------------------------------


@pytest.mark.parametrize("name", ["lns-takum8", "lns-takum16"])
def test_lns_registry_entries_match_reference(name):
    spec, jspec = formats.get(name), jformats.get(name)
    assert (spec.name, spec.kind, spec.n) == (jspec.name, jspec.kind, jspec.n)
    assert spec.nar_word == jspec.nar_word
    assert spec.zero_word == jspec.zero_word
    assert spec.has_lns_parts and jspec.has_lns_parts
    assert spec.bytes_per_elem(torch.float32) == \
        jspec.bytes_per_elem(jnp.float32)
    assert spec.word_dtype == (torch.uint8 if spec.n == 8 else torch.uint16)


def test_lns_registry_spellings():
    l8, l16 = formats.get("lns-takum8"), formats.get("lns-takum16")
    assert formats.resolve("lns", 16) is l16
    assert formats.resolve("lns-takum8") is l8
    assert formats.resolve(l8, 8) is l8
    assert formats.resolve_lns(8) is l8
    assert formats.resolve_lns("takum8") is formats.get("takum8")
    assert formats.resolve(8) is formats.get("takum8")
    assert not formats.get("takum8").has_lns_parts
    with pytest.raises(ValueError, match="needs a word width"):
        formats.resolve("lns")
    with pytest.raises(ValueError, match="mismatch"):
        formats.resolve("lns-takum8", 16)
    with pytest.raises(ValueError, match="not in this package"):
        formats.resolve("lns-takum12")
    with pytest.raises(ValueError, match="no LNS"):
        formats.get("takum16").lns_parts(torch.zeros(3, dtype=torch.uint16))
    for kv in ("lns-takum16", "lns-takum8", "takum8", "none"):
        assert parse_kv_quant(kv) == jparse_kv_quant(kv)
    assert parse_kv_quant("lns-takum16") == ("lns", 16)


@pytest.mark.parametrize("n", WIDTHS)
def test_ops_lns_codec_matches_reference_kernel(n):
    """ops.takum_encode/takum_decode with lns specs against the JAX codec
    kernels in interpret mode (a float input of any shape)."""
    name = f"lns-takum{n}"
    x = _normal_floats(90 + n, size=20_000)[:30_002].reshape(-1, 2)
    want = np.asarray(jops.takum_encode(jnp.asarray(x), name, use_kernel=True,
                                        interpret=True)).astype(np.int64)
    words = ops.takum_encode(torch.from_numpy(x), name)
    step = (_np_words(words) - want) % (1 << n)
    assert np.isin(step, (0, 1, (1 << n) - 1)).all()
    assert (step != 0).mean() <= NEIGHBOUR_SHARE
    w = _all_words(n)
    jdec = np.asarray(jops.takum_decode(jnp.asarray(w), name, use_kernel=True,
                                        interpret=True))
    dec = ops.takum_decode(_t(w), name).numpy()
    normal = np.isfinite(jdec) & (np.abs(jdec) >= F32_TINY)
    ok = normal & (_ulps(jdec, _oracle_decode(w, n)) <= 1)
    assert _ulps(dec[ok], jdec[ok]).max() <= 2
    np.testing.assert_array_equal(np.isnan(dec), np.isnan(jdec))


def test_codec_wrappers_take_lns_specs_on_cpu_without_launching():
    spec = formats.get("lns-takum16")
    before = (takum_codec.encode.launches, takum_codec.decode.launches)
    x = torch.linspace(-3, 3, 101)
    w = takum_codec.encode(x, spec)
    assert w.dtype == torch.uint16
    assert torch.equal(w, takum.float_to_lns_takum(x, 16))
    torch.testing.assert_close(takum_codec.decode(w, spec),
                               takum.lns_takum_to_float(w, 16))
    assert (takum_codec.encode.launches,
            takum_codec.decode.launches) == before
