"""The port's codec core and registry against the JAX package, on the CPU.

Inputs are made with numpy and handed to both packages; the plain torch
codec (``repro_torch.core``) must give the reference's words and floats
bit for bit: every takum8 and takum16 word decoded, and random, special,
subnormal and rounding-boundary floats encoded. The JAX side runs as its
own tests run it (Pallas kernels in interpret mode). Also here: the test
that keeps JAX and the reference package out of the port.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formats as jformats
from repro.core import bitops as jbit
from repro.core import takum as jtakum
from repro.kernels import ops as jops
from repro_torch import formats
from repro_torch.core import bitops, takum
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = [8, 16]
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|,|$)",
                        re.MULTILINE)


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/kernels/autotune.py",
            "src/repro_torch/kernels/cost.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/specs.py"} <= names
    bad = []
    for f in files:
        for m in _FORBIDDEN.finditer(f.read_text()):
            bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad


def test_isolation_pattern_spares_the_port_name():
    assert not _FORBIDDEN.search("from repro_torch.core import takum\n")
    assert not _FORBIDDEN.search("import repro_torch\n")
    assert _FORBIDDEN.search("  from repro.core import takum\n")
    assert _FORBIDDEN.search("import jax.numpy as jnp\n")
    assert _FORBIDDEN.search("import repro\n")


def _all_words(n):
    return np.arange(2 ** n, dtype=np.int64).astype(
        np.uint8 if n == 8 else np.uint16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _special_floats():
    return np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45,
                     -1e-45, 1.1754942e-38, -1.1754942e-38, 1.1754944e-38,
                     3.4028235e38, -3.4028235e38, 1.0, -1.0, 0.5, -2.0],
                    np.float32)


def _random_floats(seed, size=50_000):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=size) * 10.0 ** rng.integers(-45, 39, size)
         ).astype(np.float32)
    raw = rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    sub = (rng.integers(1, 2 ** 23, size // 10).astype(np.uint32)
           | (rng.integers(0, 2, size // 10).astype(np.uint32) << 31))
    return np.concatenate([x, raw.view(np.float32), sub.view(np.float32),
                           _special_floats()])


def _boundary_floats(n):
    """Midpoints between neighbouring finite takum values (the RNE ties)
    and the floats one ulp either side of each."""
    vals = np.asarray(jtakum.takum_to_float(jnp.asarray(_all_words(n)), n),
                      np.float64)
    vals = np.sort(vals[np.isfinite(vals)])
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    mids = mids[np.isfinite(mids)]
    up = np.nextafter(mids, np.float32(np.inf))
    down = np.nextafter(mids, np.float32(-np.inf))
    return np.concatenate([mids, up, down]).astype(np.float32)


# -- bit helpers -------------------------------------------------------------


def _lanes(seed=0, size=4000):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, size, dtype=np.uint64)
    s = rng.integers(-3, 40, size)
    return x, s


@pytest.mark.parametrize("name", ["safe_shl", "safe_shr", "bit"])
def test_shift_helpers_match_reference(name):
    x, s = _lanes(1)
    want = np.asarray(getattr(jbit, name)(jnp.asarray(x.astype(np.uint32)),
                                          jnp.asarray(s.astype(np.int32))))
    got = getattr(bitops, name)(_t(x.astype(np.int64)), _t(s)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_mask_matches_reference():
    n = np.arange(-2, 40)
    want = np.asarray(jbit.mask(jnp.asarray(n.astype(np.int32))))
    np.testing.assert_array_equal(bitops.mask(_t(n)).numpy(),
                                  want.astype(np.int64))
    for k in (0, 1, 7, 31, 32, 33):
        assert bitops.mask(k) == int(jbit.mask(k))


@pytest.mark.parametrize("name", ["floor_log2", "floor_log2_u8", "clz"])
def test_log_helpers_match_reference(name):
    x, _ = _lanes(2)
    x = np.maximum(x, 1)
    if name == "floor_log2_u8":
        x = np.arange(1, 256)
    j = jnp.asarray(x.astype(np.uint32))
    args = (32,) if name == "clz" else ()
    want = np.asarray(getattr(jbit, name)(j, *args))
    got = getattr(bitops, name)(_t(x.astype(np.int64)), *args).numpy()
    np.testing.assert_array_equal(got, want)


# -- decode --------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
def test_decode_every_word_bit_exact(n):
    words = _all_words(n)
    want = np.asarray(jtakum.takum_to_float(jnp.asarray(words), n))
    got = takum.takum_to_float(_t(words), n).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_takum8_table_matches_reference_decode():
    """The plain takum8 table of the card's kernels equals
    the JAX package's takum_to_float on all 256 words, bit for bit (NaR
    to the same NaN bits, the words past the f32 range to the same
    infinities, the subnormal band exact)."""
    from repro_torch.kernels import ref
    want = np.asarray(jtakum.takum_to_float(jnp.asarray(_all_words(8)), 8))
    table = ref.takum8_table().numpy()
    np.testing.assert_array_equal(table.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", WIDTHS)
def test_decode_fields_match_reference(n):
    words = _all_words(n)
    want = jtakum.decode_linear(jnp.asarray(words), n)
    got = takum.decode_linear(_t(words), n)
    for field in ("s", "val", "mant", "is_zero", "is_nar"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy().astype(np.int64),
            np.asarray(getattr(want, field)).astype(np.int64), err_msg=field)


@pytest.mark.parametrize("n", WIDTHS)
def test_integer_decode_matches_ldexp_oracle(n):
    words = _t(_all_words(n))
    fast = takum.takum_to_float(words, n)
    oracle = takum.takum_to_float_ref(words, n)
    assert torch.equal(torch.isnan(fast), torch.isnan(oracle))
    ok = ~torch.isnan(fast)
    assert torch.equal(fast[ok].view(torch.int32), oracle[ok].view(torch.int32))


# -- encode --------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
def test_encode_random_special_subnormal_bit_exact(n):
    x = _random_floats(n)
    want = np.asarray(jtakum.float_to_takum(jnp.asarray(x), n))
    got = takum.float_to_takum(_t(x), n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", WIDTHS)
def test_encode_rounding_boundaries_bit_exact(n):
    x = _boundary_floats(n)
    want = np.asarray(jtakum.float_to_takum(jnp.asarray(x), n))
    got = takum.float_to_takum(_t(x), n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", WIDTHS)
def test_encode_saturates_and_round_trips(n):
    words = _all_words(n)
    vals = takum.takum_to_float(_t(words), n)
    finite = torch.isfinite(vals) & (vals.abs() < 3e38) & (vals.abs() > 1e-37)
    back = takum.float_to_takum(vals[finite], n)
    assert torch.equal(back.to(torch.int64), _t(words)[finite].to(torch.int64))
    big = takum.float_to_takum(torch.tensor([float("inf"), -float("inf"),
                                             float("nan")]), n).tolist()
    assert big[2] == takum.nar_word(n)
    assert 0 not in big[:2] and takum.nar_word(n) not in big[:2]


# -- ops and registry ------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
def test_ops_decode_matches_reference_kernel(n):
    words = _all_words(n)
    want = np.asarray(jops.takum_decode(jnp.asarray(words), n,
                                        use_kernel=True, interpret=True))
    got = ops.takum_decode(_t(words), f"takum{n}").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", WIDTHS)
def test_ops_encode_matches_reference_kernel(n):
    x = _random_floats(10 + n, size=20_000)[:42_007].reshape(-1, 7)
    want = np.asarray(jops.takum_encode(jnp.asarray(x), n, use_kernel=True,
                                        interpret=True))
    got = ops.takum_encode(_t(x), n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["none", "takum8", "takum16"])
def test_registry_entries_match_reference(name):
    spec, jspec = formats.get(name), jformats.get(name)
    assert (spec.name, spec.kind, spec.n) == (jspec.name, jspec.kind, jspec.n)
    assert spec.nar_word == jspec.nar_word
    assert spec.zero_word == jspec.zero_word
    assert spec.bytes_per_elem(torch.float32) == \
        jspec.bytes_per_elem(jnp.float32)
    assert spec.bytes_per_elem(torch.bfloat16) == \
        jspec.bytes_per_elem(jnp.bfloat16)


def test_registry_resolution_spellings():
    t8 = formats.get("takum8")
    assert formats.resolve(t8) is t8
    assert formats.resolve(8) is t8
    assert formats.resolve("linear", 8) is t8
    assert formats.resolve("takum16").n == 16
    assert formats.resolve("none").is_identity
    with pytest.raises(ValueError, match="identity"):
        formats.resolve_wire("none")
    with pytest.raises(ValueError, match="mismatch"):
        formats.resolve("takum8", 16)
    # posit8 resolves as in the reference's registry, by name and by kind
    p8, jp8 = formats.resolve("posit8"), jformats.resolve("posit8")
    assert (p8.name, p8.kind, p8.n) == (jp8.name, jp8.kind, jp8.n)
    assert formats.resolve("posit", 8) is p8
    with pytest.raises(ValueError, match="unknown"):
        formats.resolve("posit8x")
    assert formats.names() == jformats.names() == (
        "none", "lns-takum16", "lns-takum8", "posit16", "posit8", "takum16",
        "takum8")
