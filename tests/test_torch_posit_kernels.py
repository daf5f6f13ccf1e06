"""The port's ops over posit words against the JAX package's kernels, on
the CPU.

The wire matmul, contiguous attention and paged attention over posit8
and posit16 words (NaR words included): the port runs the plain versions
its wrappers take for CPU tensors (``ref.qmatmul_ref``,
``ref.attention_ref``, ``ref.paged_attention_ref``), the reference runs
its Pallas kernels in interpret mode, both with ``REPRO_LUT_DECODE`` set
to ``1`` (posit8 through the 256-entry table: the reference traces its
``_posit8_lut_decode`` into every kernel body) and to ``0`` (computed;
posit16 has no table).
Tolerances are the reference tests': ``rtol=1e-5, atol=1e-4`` for the
matmul (tests/test_kernels.py), ``atol=2e-5`` for attention
(tests/test_paged_attention.py); NaNs must sit in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posit as jposit
from repro.kernels import ops as jops
from repro_torch.kernels import ops

# (width, REPRO_LUT_DECODE): posit16 has no table, so it runs computed only


@pytest.fixture(scope="module", params=[(8, "0"), (16, "0"), (8, "1")],
                ids=["posit8-computed", "posit16", "posit8-table"])
def fmt(request):
    """(n, lut) with REPRO_LUT_DECODE set for both packages. The reference
    reads the switch while tracing, so its compiled kernels are dropped
    when the table is turned on (pytest runs a module-scoped parameter's
    tests together)."""
    n, lut = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DECODE", lut)
        if lut == "1":
            jax.clear_caches()
        yield n, lut
    if lut == "1":
        jax.clear_caches()


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


def _words(rng, shape, n, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.array(jposit.float_to_posit(jnp.asarray(x), n))


def _close(got, want, **tol):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], **tol)


@pytest.mark.parametrize("mkn", [(128, 128, 128), (100, 130, 60),
                                 (4, 320, 64)])
def test_quant_matmul_matches_reference_kernel(mkn, fmt):
    n, _ = fmt
    m, k, nn = mkn
    rng = np.random.default_rng(5 + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = _words(rng, (k, nn), n, scale=k ** -0.5)
    w[k // 2, nn // 3] = 1 << (n - 1)              # NaR: one NaN column
    name = f"posit{n}"
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), name,
                                        True, True))
    got = ops.quant_matmul(_t(x), _t(w), name).numpy()
    assert np.isnan(want[:, nn // 3]).all() and np.isnan(want).sum() == m
    _close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("pos,window,block", [(0, 0, None), (17, 0, 16),
                                              (30, 12, 8)])
def test_takum_attention_over_posit_kv_matches_reference_kernel(
        pos, window, block, fmt):
    n, _ = fmt
    rng = np.random.default_rng(11 + pos + n)
    b, tq, hkv, g, hd, tmax = 2, 5, 2, 2, 16, 40
    q = rng.normal(size=(b, tq, hkv * g, hd)).astype(np.float32)
    kw = _words(rng, (b, tmax, hkv, hd), n)
    vw = _words(rng, (b, tmax, hkv, hd), n)
    kw[1, pos, 0, 3] = 1 << (n - 1)                # NaR K word at a valid key
    start = np.array([0, 3], np.int32)
    name = f"posit{n}"
    kwargs = dict(pos=pos, start=start, window=window, block=block)
    want = np.asarray(jops.takum_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), n, name,
        use_kernel=True, interpret=True, **kwargs))
    got = ops.takum_attention(_t(q), _t(kw), _t(vw), n, name,
                              **kwargs).numpy()
    # rows before a sequence's start are garbage on every path
    valid = (pos + np.arange(tq))[None, :] >= start[:, None]
    _close(got[valid], want[valid], rtol=0, atol=2e-5)
    if pos >= 3:    # the NaR key is a valid key of sequence 1's rows
        assert np.isnan(got[1, :, :g]).all()


P, PS, HKV, G, HD, NP, B = 11, 16, 2, 2, 16, 4, 4


@pytest.mark.parametrize("window", [0, 7])
def test_paged_attention_over_posit_kv_matches_reference_kernel(window, fmt):
    n, _ = fmt
    rng = np.random.default_rng(20 + n + window)
    kw = _words(rng, (P, PS, HKV, HD), n)
    vw = _words(rng, (P, PS, HKV, HD), n)
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, NP), np.int32)
    table[0] = perm[:NP]
    table[1] = perm[NP:2 * NP]
    table[2, :2] = perm[8:10]
    kw[table[1, 2], 4, 0, 0] = 1 << (n - 1)        # NaR: seq 1, position 36
    q = rng.normal(size=(B, 1, HKV * G, HD)).astype(np.float32)
    pos = np.array([NP * PS - 1, 37, 20, 0], np.int32)
    start = np.array([0, 5, 3, 0], np.int32)
    name = f"posit{n}"
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(table),
        name, pos=jnp.asarray(pos), start=jnp.asarray(start), window=window,
        use_kernel=True, interpret=True))
    got = ops.paged_attention(_t(q), _t(kw), _t(vw), _t(table), name,
                              pos=_t(pos), start=_t(start),
                              window=window).numpy()
    assert np.isnan(got[1, 0, :G]).all()
    assert np.isfinite(got[1, 0, G:]).all()
    _close(got, want, rtol=0, atol=2e-5)
