"""The fused fake-quant kernel's dataflow against the JAX package, on the CPU.

``kernels/ref.py::fake_quant_dataflow`` is the plain mirror of
``csrc/fake_quant.cu`` for linear takum and posit: a normal float whose
word keeps p >= 1 fraction bits rounds in value space, its own float32
bits to nearest even with 23 - p bits dropped; every other float takes
the word path (``encode_dataflow`` then ``decode_dataflow``). It is held
bit for bit against the reference's ``fake_quant_fused`` (its Pallas
kernel in interpret mode, compiled once a width and output dtype) at
n = 6, 7, 8, 11, 12, 13, 16, 20, 24, 28, 29 and 32 on:

* every normal float32 exponent with fractions 0, 1 and all ones and,
  for every count d = 1..23 of dropped bits, the tie, the tie +- 1 and
  the tie above an odd kept bit, both signs;
* 2^14 seeded raw patterns, subnormals and the specials;
* scale exponents 0 and +-4 (the reference has no scale: its round trip
  of x * 2^k, times 2^-k in float32);
* f32 and bf16 output (bf16: the reference's own bf16 kernel at k = 0,
  its f32 result rounded to nearest even otherwise, as the port's).

Where the reference's posit encoder is at fault (n >= 29, ROADMAP.md
section 3: it leaves a float32 fraction unshifted), the mirror is held to
the port's plain ``fake_quant_ref`` and its words to the golden model
(``core/golden.py``, sampled), as tests/test_torch_codec_dataflow.py
does. The kernel itself is held to the plain version on the card
(``chip_smoke.py`` phases 17 and 33, ``tests/test_torch_gpu.py``).
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import formats
from repro_torch.core import posit
from repro_torch.core.bitops import lanes
from repro_torch.kernels import ref
from test_torch_codec_dataflow import _check_posit_golden

WIDTHS = [6, 7, 8, 11, 12, 13, 16, 20, 24, 28, 29, 32]
KINDS = ["linear", "posit"]
SCALES = [0, 4, -4]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _floats(n):
    """Every normal exponent x {0, 1, all ones, and at every drop count
    d = 1..23 the tie, the tie +- 1, the tie above an odd kept bit}, both
    signs, plus 2^14 raw patterns, 256 subnormals and the specials."""
    rng = np.random.default_rng(500 + n)
    ex = np.arange(1, 255, dtype=np.int64)[:, None]
    d = np.arange(1, 24, dtype=np.int64)[None, :]
    tie = 1 << (d - 1)
    odd = np.where(d <= 22, tie | (1 << np.minimum(d, 22)), tie)
    fracs = np.concatenate([np.broadcast_to(f, (254, 23)) for f in
                            (tie, tie + 1, tie - 1, odd)], axis=1)
    fracs = np.concatenate([fracs, np.tile([0, 1, 0x7FFFFF], (254, 1))],
                           axis=1)
    bits = ((ex << 23) | (fracs & 0x7FFFFF)).reshape(-1)
    bits = np.concatenate([bits, bits | (1 << 31)])
    raw = rng.integers(0, 1 << 32, 1 << 14, dtype=np.int64)
    sub = rng.integers(1, 1 << 23, 256, dtype=np.int64)
    pats = np.concatenate([bits, raw, sub, sub | (1 << 31)])
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1.1754942e-38, 3.4028235e38, -3.4028235e38, 1.0,
                        -1.0], np.float32)
    return np.concatenate([pats.astype(np.uint32).view(np.float32), special])


@functools.lru_cache(maxsize=None)
def _reference(kind, n, dt):
    """The reference's fake-quant of the floats at k = 0 and +-4, each
    times 2^-k in float32, in ``dt`` ({k: numpy float32 array})."""
    x = _floats(n)
    ks = SCALES if dt == "f32" else [0]
    with np.errstate(over="ignore", invalid="ignore"):   # inf, NaN kept
        xs = np.concatenate([x * np.float32(2.0 ** k) for k in ks])
    y = np.asarray(jops.fake_quant_fused(jnp.asarray(xs), fmt=kind, n=n,
                                         dtype=DTYPES[dt][1], interpret=True
                                         ).astype(jnp.float32))
    with np.errstate(over="ignore", invalid="ignore"):
        out = {k: y[i * x.size:(i + 1) * x.size] * np.float32(2.0 ** -k)
               for i, k in enumerate(ks)}
    if dt == "bf16":
        f32 = _reference(kind, n, "f32")
        out.update({k: torch.from_numpy(f32[k]).to(torch.bfloat16).float()
                    .numpy() for k in SCALES if k})
    return out


def _same_floats(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_mirror_against_reference(kind, n, dt):
    spec = formats.resolve(kind, n)
    x = torch.from_numpy(_floats(n))
    for k in SCALES:
        got = ref.fake_quant_dataflow(x, spec, DTYPES[dt][0],
                                      scale_exp=k).float().numpy()
        if kind == "posit" and n >= 29:
            _same_floats(got, ref.fake_quant_ref(
                x, spec, DTYPES[dt][0], scale_exp=k).float().numpy())
            continue
        _same_floats(got, _reference(kind, n, dt)[k])
    if kind == "posit" and n >= 29:
        xs = x.numpy()[::97]
        _check_posit_golden(xs, lanes(posit.float_to_posit(
            torch.from_numpy(xs), n)).numpy(), n)


@pytest.mark.parametrize("n", [6, 8, 16, 29])
@pytest.mark.parametrize("kind", KINDS)
def test_both_paths_reached(kind, n):
    """The floats above reach both paths: the value path at every float32
    exponent whose word keeps p >= 1 fraction bits, the word path at the
    others and at zeros, subnormals, infinities and NaNs."""
    x = torch.from_numpy(_floats(n))
    e = (lanes(x.view(torch.int32).view(torch.uint32)) >> 23) & 0xFF
    value = (e >= 1) & (e <= 254) & (ref._value_drop(e, n, kind) <= 22)
    every = torch.arange(1, 255, dtype=torch.int64)
    want = set(every[ref._value_drop(every, n, kind) <= 22].tolist())
    normal = (e >= 1) & (e <= 254)
    assert want and set(e[value].unique().tolist()) == want
    assert set(e[~value & normal].unique().tolist()) == set(
        every.tolist()) - want
    assert bool((e[~value] == 0).any()) and bool((e[~value] == 255).any())
