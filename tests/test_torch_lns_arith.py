"""The port's LNS arithmetic (``core/lns.py``: ``LnsTensor``, ``from_words``,
``to_words``, ``mul``, ``div``, ``sqrt``, ``add``) against the JAX
package's on the same words, on the CPU, as tests/test_quant_lns.py holds
the reference.

* ``from_words``/``to_words``: the reference's ``(s, ell_bar, is_zero,
  is_nar)`` lanes bit for bit, and every word back (n = 8, 12, 16).
* ``mul``/``div``/``sqrt``: exact in ``ell`` (an add, a subtract, an
  arithmetic shift, saturated to the dynamic range): the reference's
  lanes and words bit for bit, zero and NaR operands and x / 0 included.
* ``add``: ``phi(d) = 2 ln(1 +- e^(d/2))`` evaluated in f32, as the
  reference does, at n = 8-32. Every pair, near cancellation included,
  lies within one f32 evaluation's error (2 ulp of ``exp`` and of
  ``log1p``, grown by ``1 / (1 +- e^(d/2))``) of a float64 oracle, and
  within two of the reference's (another ``exp``/``log1p``) up to n = 28,
  where the reference's int32 lanes wrap for ells 256 or more apart;
  from n = 29 its ``ell_bar`` itself wraps. A zero operand
  returns the other; equal magnitudes of opposite sign cancel to zero in
  both; NaR is sticky.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lns as jlns
from repro_torch.core import lns, takum
from repro_torch.core.bitops import lanes, to_words

WIDTHS = [8, 12, 16]
ADD_WIDTHS = [8, 12, 16, 20, 24, 28, 29, 32]


def _words(n, rng, size=4096):
    w = rng.integers(0, 1 << n, size)
    w[:4] = [0, 1 << (n - 1), 1, (1 << n) - 1]   # zero, NaR, the ends
    return w


def _pair(n, w):
    t = lns.from_words(to_words(torch.from_numpy(w), takum.word_dtype(n)), n)
    j = jlns.from_words(jnp.asarray(w.astype(np.uint32)), n)
    return t, j


def _same(t, j):
    assert np.array_equal(t.s.numpy(), np.asarray(j.s))
    assert np.array_equal(t.is_zero.numpy(), np.asarray(j.is_zero))
    assert np.array_equal(t.is_nar.numpy(), np.asarray(j.is_nar))
    live = ~(t.is_zero.numpy() | t.is_nar.numpy())
    assert np.array_equal(t.ell_bar.numpy()[live],
                          np.asarray(j.ell_bar).astype(np.int64)[live])


def _words_of(t, j, n):
    wf = takum.frac_width(n)
    return (lanes(lns.to_words(t, n, wf=wf)).numpy(),
            np.asarray(jlns.to_words(j, n, wf=wf)).astype(np.int64))


@pytest.mark.parametrize("n", WIDTHS)
def test_from_and_to_words(n):
    w = np.arange(1 << n, dtype=np.int64)
    t, j = _pair(n, w)
    _same(t, j)
    got, want = _words_of(t, j, n)
    np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", WIDTHS)
def test_mul_div_sqrt_exact_in_ell(n):
    rng = np.random.default_rng(n)
    wf = takum.frac_width(n)
    (ta, ja), (tb, jb) = (_pair(n, _words(n, rng)) for _ in range(2))
    for op in ("mul", "div"):
        t = getattr(lns, op)(ta, tb, wf=wf)
        j = getattr(jlns, op)(ja, jb, wf=wf)
        _same(t, j)
        got, want = _words_of(t, j, n)
        np.testing.assert_array_equal(got, want)
    t, j = lns.sqrt(ta, wf=wf), jlns.sqrt(ja, wf=wf)
    _same(t, j)
    np.testing.assert_array_equal(*_words_of(t, j, n))
    # exact: the product's ell is the sum of the factors' (unsaturated)
    ell = lambda x: torch.where(x.s == 1, -x.ell_bar, x.ell_bar)  # noqa: E731
    p = lns.mul(ta, tb, wf=wf)
    inner = (ell(ta) + ell(tb)).abs() < (255 << wf)
    assert torch.equal(ell(p)[inner], (ell(ta) + ell(tb))[inner])
    q = lns.div(ta, tb, wf=wf)
    assert bool(q.is_nar[tb.is_zero].all())


def _oracle(ea, eb, sa, sb, wf):
    """The reference's ``add`` in float64 on the same f32 ``d``: the un-barred
    ``ell`` of the sum before rounding, and the bound in grid steps of one
    f32 evaluation's error (``exp`` and ``log1p`` within 2 ulp each;
    through ``log1p(+-x)`` an error of ``x`` grows by ``1 / (1 +- x)``)."""
    a_ge = ea >= eb
    base = np.where(a_ge, ea, eb)
    same = np.where(a_ge, sa, sb) == np.where(a_ge, sb, sa)
    d = (np.minimum(ea, eb) - base).astype(np.float32) / np.float32(1 << wf)
    x = np.exp(d.astype(np.float64) * 0.5)
    xs = np.minimum(x, lns._BELOW_ONE)
    phi = np.where(same, 2.0 * np.log1p(x), 2.0 * np.log1p(-xs))
    cond = np.where(same, x / (1.0 + x), xs / (1.0 - xs))
    ulp = np.spacing(np.abs(phi / 2.0).astype(np.float32)).astype(np.float64)
    err = 2.0 * (2.0 * 2.0 ** -23 * cond) + 4.0 * ulp
    return base + phi * (1 << wf), err * (1 << wf)


def _un_bar(s, ell_bar):
    return np.where(s == 1, -ell_bar, ell_bar)


@pytest.mark.parametrize("n", ADD_WIDTHS)
def test_add_gauss_against_the_reference(n):
    rng = np.random.default_rng(10 + n)
    wf = takum.frac_width(n)
    wa, wb = _words(n, rng), _words(n, rng)
    # near each other too: the steep end of phi_sub and exact cancellation
    wb[1000:2000] = np.clip(wa[1000:2000] + rng.integers(-3, 4, 1000), 0,
                            (1 << n) - 1)
    wb[2000:2500] = (-(wa[2000:2500] + rng.integers(-3, 4, 500))
                     & ((1 << n) - 1))
    wb[2000:2100] = (-wa[2000:2100]) & ((1 << n) - 1)      # a + (-a)
    (ta, ja), (tb, jb) = _pair(n, wa), _pair(n, wb)
    t = lns.add(ta, tb, wf=wf)
    got = lanes(lns.to_words(t, n, wf=wf)).numpy()
    special = (ta.is_zero | tb.is_zero | ta.is_nar | tb.is_nar).numpy()
    # the float64 oracle, every pair and every width
    ea = _un_bar(ta.s.numpy(), ta.ell_bar.numpy())
    eb = _un_bar(tb.s.numpy(), tb.ell_bar.numpy())
    cancel = (ta.s != tb.s).numpy() & (ea == eb) & ~special
    assert cancel[2000:2100][~special[2000:2100]].all()
    exact, tol = _oracle(ea, eb, ta.s.numpy(), tb.s.numpy(), wf)
    lim = lns.ELL_MAX_INT << wf
    live = ~special & ~t.is_zero.numpy()
    ell = _un_bar(t.s.numpy(), t.ell_bar.numpy())
    assert (np.abs(ell - np.clip(exact, -lim, lim)) <= tol + 0.5)[live].all()
    assert t.is_zero.numpy()[cancel].all()
    assert not t.is_zero.numpy()[~special & ~cancel].any()
    # a zero operand returns the other, exactly
    z = ((ta.is_zero ^ tb.is_zero) & ~(ta.is_nar | tb.is_nar)).numpy()
    np.testing.assert_array_equal(got[z], np.where(ta.is_zero.numpy(), wb,
                                                   wa)[z])
    if n > 28:
        return   # the reference's int32 ell_bar wraps from n = 29
    # the reference on the same words: two f32 evaluations apart at most,
    # except where its int32 lanes wrap (n = 28: the difference of ells
    # 256 or more apart, or the sum near 255 before the clip)
    j = jlns.add(ja, jb, wf=wf)
    want = np.asarray(jlns.to_words(j, n, wf=wf)).astype(np.int64)
    assert np.array_equal(t.is_nar.numpy(), np.asarray(j.is_nar))
    assert np.array_equal(t.is_zero.numpy(), np.asarray(j.is_zero))
    wraps = (np.abs(ea - eb) >= 2 ** 31) | (np.abs(exact) + tol >= 2 ** 31)
    assert n == 28 or not wraps.any()
    cmp = live & ~wraps
    ej = _un_bar(np.asarray(j.s), np.asarray(j.ell_bar).astype(np.int64))
    assert (np.abs(ell - ej) <= 2.0 * tol + 1.0)[cmp].all()
    # words of one sign are monotone in ell_bar, a word at least a step
    assert (got[cmp] >> (n - 1) == want[cmp] >> (n - 1)).all()
    assert (np.abs(got - want) <= np.abs(ell - ej))[cmp].all()
    np.testing.assert_array_equal(got[z], want[z])
