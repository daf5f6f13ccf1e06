"""The port's posit codec and its registry entries against the JAX
package, on the CPU.

Inputs are made with numpy and handed to both packages. The posit codec
is integer-only on both sides, so everything here is bit-exact: every
posit8 and posit16 word through both decode variants (the integer IEEE
assembly) and through the ldexp oracle, ``float_to_posit`` over more
than a million seeded, special, subnormal and saturating floats, the
posit8 table decode (the plain version of the reference's
``_posit8_lut_decode``) against the computed one and against the
reference's table with ``REPRO_LUT_DECODE`` on and off, and the
registry's names and spellings.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.configs.base import parse_kv_quant as jparse_kv_quant
from repro.core import posit as jposit
from repro.kernels import ops as jops
from repro_torch import formats
from repro_torch.configs.base import parse_kv_quant
from repro_torch.core import posit
from repro_torch.core.bitops import carrier
from repro_torch.kernels import ops

WIDTHS = [8, 16]
VARIANTS = ["2c", "sm"]


def _all_words(n):
    return np.arange(2 ** n, dtype=np.int64).astype(
        np.uint8 if n == 8 else np.uint16)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


def _np_words(t, n):
    return carrier(t).numpy().astype(np.int64) & ((1 << n) - 1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _floats(seed):
    """>= 1M floats: seeded normals over the f32 range, raw bit patterns,
    subnormals of both signs, powers of two around the posit8/16
    saturation edges (2^+-24 and 2^+-56) and the specials."""
    rng = np.random.default_rng(seed)
    with np.errstate(over="ignore"):
        x = (rng.normal(size=700_000) * 10.0 ** rng.integers(-45, 39, 700_000)
             ).astype(np.float32)
    raw = rng.integers(0, 2 ** 32, 250_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    sub = rng.integers(1, 2 ** 23, 30_000).astype(np.uint32).view(np.float32)
    edges = np.array([2.0 ** e for e in range(-64, 65)], np.float32)
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                            np.nextafter(edges, np.float32(np.inf))])
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1.1754942e-38, 3.4028235e38, -3.4028235e38, 1.0,
                        -1.0], np.float32)
    return np.concatenate([x, raw, sub, -sub, edges, -edges, special,
                           rng.normal(size=50_000).astype(np.float32)])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", WIDTHS)
def test_decode_every_word_bit_exact(n, variant):
    words = _all_words(n)
    jdec = (jposit.decode_2c if variant == "2c" else jposit.decode_sm)(
        jnp.asarray(words), n)
    tdec = (posit.decode_2c if variant == "2c" else posit.decode_sm)(
        _t(words), n)
    for field in ("s", "e", "frac", "is_zero", "is_nar"):
        np.testing.assert_array_equal(
            getattr(tdec, field).numpy().astype(np.int64),
            np.asarray(getattr(jdec, field)).astype(np.int64), err_msg=field)
    want = jposit.posit_to_float(jnp.asarray(words), n, variant=variant)
    got = posit.posit_to_float(_t(words), n, variant=variant)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", WIDTHS)
def test_ldexp_oracle_matches_reference_and_integer_path(n, variant):
    words = _all_words(n)
    want = np.asarray(jposit.posit_to_float_ref(jnp.asarray(words), n,
                                                variant=variant))
    got = posit.posit_to_float_ref(_t(words), n, variant=variant).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])
    integer = posit.posit_to_float(_t(words), n, variant=variant).numpy()
    np.testing.assert_array_equal(_bits(integer)[~nan], _bits(got)[~nan])


@pytest.mark.parametrize("n", WIDTHS)
def test_float_to_posit_bit_exact(n):
    x = _floats(n)
    assert x.size >= 1_000_000
    want = np.asarray(jposit.float_to_posit(jnp.asarray(x), n)).astype(
        np.int64)
    got = _np_words(posit.float_to_posit(torch.from_numpy(x), n), n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", WIDTHS)
def test_encode_from_fields_bit_exact(n):
    """``encode`` on seeded representation-(8) fields with sticky bits,
    at every regime length and past both saturation edges."""
    rng = np.random.default_rng(10 + n)
    size = 200_000
    s = rng.integers(0, 2, size).astype(np.int32)
    e = rng.integers(-4 * n - 8, 4 * n + 8, size).astype(np.int32)
    frac = rng.integers(0, 2 ** 23, size).astype(np.uint32)
    sticky = rng.integers(0, 2, size).astype(bool)
    want = np.asarray(jposit.encode(jnp.asarray(s), jnp.asarray(e),
                                    jnp.asarray(frac), n, wm=23,
                                    sticky=jnp.asarray(sticky)))
    got = posit.encode(torch.from_numpy(s), torch.from_numpy(e),
                       torch.from_numpy(frac.astype(np.int64)), n, wm=23,
                       sticky=torch.from_numpy(sticky))
    np.testing.assert_array_equal(_np_words(got, n), want.astype(np.int64))


@pytest.mark.parametrize("lut", ["0", "1"])
def test_posit8_table_decode(lut, monkeypatch):
    """The plain table decode equals the computed decode on all 256
    words, and both equal the reference's decode with its table on and
    off (``REPRO_LUT_DECODE``)."""
    monkeypatch.setenv("REPRO_LUT_DECODE", lut)
    words = _all_words(8)
    spec = formats.get("posit8")
    assert spec.has_lut and not formats.get("posit16").has_lut
    assert spec.lut_decode("cpu") == (lut == "1")
    assert jformats.get("posit8").lut_decode == (lut == "1")
    table = formats.posit8_lut_decode(_t(words)).numpy()
    computed = posit.posit_to_float(_t(words), 8).numpy()
    np.testing.assert_array_equal(_bits(table), _bits(computed))
    via_tile = spec.decode_tile(_t(words)).numpy()
    np.testing.assert_array_equal(_bits(via_tile), _bits(computed))
    ref_tile = jformats.get("posit8").decode_tile(jnp.asarray(words))
    np.testing.assert_array_equal(_bits(via_tile), _bits(ref_tile))
    bf16 = formats.posit8_lut_decode(_t(words), dtype=torch.bfloat16)
    torch.testing.assert_close(bf16, torch.from_numpy(computed).to(
        torch.bfloat16), rtol=0, atol=0, equal_nan=True)


def test_lut_switch_defaults(monkeypatch):
    monkeypatch.delenv("REPRO_LUT_DECODE", raising=False)
    assert not formats.lut_enabled("cpu")
    assert formats.lut_enabled("cuda") == formats.LUT_DEFAULT_CUDA
    assert not formats.lut_enabled(None)
    monkeypatch.setenv("REPRO_LUT_DECODE", "1")
    assert formats.lut_enabled("cpu") and formats.lut_enabled("cuda")
    monkeypatch.setenv("REPRO_LUT_DECODE", "0")
    assert not formats.lut_enabled("cuda")


def test_registry_names_and_spellings_match_reference():
    assert formats.names() == jformats.names()
    assert formats.wire_names() == jformats.wire_names()
    for name in ("posit8", "posit16"):
        spec, jspec = formats.get(name), jformats.get(name)
        assert (spec.name, spec.kind, spec.n) == (jspec.name, jspec.kind,
                                                  jspec.n)
        assert spec.nar_word == jspec.nar_word
        assert spec.bytes_per_elem(torch.float32) == \
            jspec.bytes_per_elem(jnp.float32)
        assert spec.has_lut == jspec.has_lut
        assert not spec.has_lns_parts
        assert formats.resolve("posit", spec.n) is spec
        assert parse_kv_quant(name) == jparse_kv_quant(name) == ("posit",
                                                                 spec.n)
    with pytest.raises(ValueError, match="mismatch"):
        formats.resolve("posit8", 16)
    with pytest.raises(ValueError, match="not in this package"):
        formats.resolve("posit12")


@pytest.mark.parametrize("n", WIDTHS)
def test_codec_ops_match_reference_kernels(n):
    """``ops.takum_decode``/``takum_encode`` on posit words against the
    reference's Pallas codec kernels in interpret mode (ragged shape)."""
    rng = np.random.default_rng(20 + n)
    x = (rng.normal(size=(37, 19)) * 10.0 ** rng.integers(-9, 9, (37, 19))
         ).astype(np.float32)
    name = f"posit{n}"
    want_w = np.asarray(jops.takum_encode(jnp.asarray(x), name,
                                          interpret=True)).astype(np.int64)
    got_w = ops.takum_encode(torch.from_numpy(x), name)
    np.testing.assert_array_equal(_np_words(got_w, n), want_w)
    want = jops.takum_decode(jnp.asarray(want_w.astype(
        np.uint8 if n == 8 else np.uint16)), name, interpret=True)
    got = ops.takum_decode(got_w, name)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
