"""The partitioned dataflow of the port's paged attention, on the CPU.

``takum_attention.paged_partitions`` is the plan the CUDA kernel
(``csrc/attention.cu``) follows: each sequence's in-band keys cut into
partitions, merged in order. Checked here: the plan visits every in-band
page exactly once and nothing outside the band (windows and idle slots
included), and ``ref.paged_attention_ref(partitions=...)``, which splits
and merges as the kernel does, agrees with the JAX package's Pallas paged
kernel in interpret mode at the reference's tolerance (``atol=2e-5``,
tests/test_paged_attention.py) in the cases that stress the merge: the
idle slot, windows, NaR words, an all-masked row, one-key partitions and
partitions that visit no key.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import takum as jtakum
from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels import takum_attention as kattn

P, PS, HKV, G, HD, NP, B = 11, 16, 2, 2, 16, 4, 4


def _band(p, ps, npg, window):
    """The in-band pages of the reference Pallas kernel's ``in_band`` test,
    page by page."""
    return [kk for kk in range(npg)
            if kk * ps <= p and (not window or (kk + 1) * ps - 1 > p - window)
            and kk <= min(p // ps, npg - 1)]


PLAN_CASES = [
    # (pos, ps, npg, window, pk)
    ([63, 37, 20, 900], 16, 4, 0, 8),      # idle slot past its table
    ([63, 37, 20, 900], 16, 4, 7, 8),      # windowed: the idle slot has none
    ([63, 37, 20, 0], 16, 4, 24, 5),       # window floor inside a page
    ([255, 256, 511, 1023], 256, 5, 0, 64),   # pos on page boundaries
    ([76, 520, 1023, 4000], 256, 5, 0, 64),   # phase 4 of chip_smoke.py
    ([76, 520, 1023, 4000], 256, 5, 300, 64),
    ([0, 1, 15, 16], 16, 4, 0, 1),         # one-key partitions
    ([100, 7, 64, 65], 1, 128, 0, 48),     # pages of one key
    ([30, 30, 30, 30], 16, 4, 1, 512),     # a window of one key
]


@pytest.mark.parametrize("pos,ps,npg,window,pk", PLAN_CASES)
def test_partitions_visit_every_in_band_page_once(pos, ps, npg, window, pk):
    plans = kattn.paged_partitions(pos, ps, npg, window, pk)
    assert len(plans) == len(pos)
    for p, ranges in zip(pos, plans):
        keys = [k for k0, k1 in ranges for k in range(k0, k1)]
        pages = _band(p, ps, npg, window)
        # every key of every in-band page, each once, in order
        assert keys == [kk * ps + o for kk in pages for o in range(ps)]
        # the merge order is the key order, and no range is empty
        assert all(k0 < k1 for k0, k1 in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(k1 - k0 == pk for k0, k1 in ranges[:-1])


@pytest.mark.parametrize("pos,ps,npg,window,pk", PLAN_CASES)
def test_partitions_fit_the_kernel_grid(pos, ps, npg, window, pk):
    """The kernel's grid holds ceil(npg * ps / pk) partitions a sequence:
    enough for any pos; the slots past a sequence's plan visit no key."""
    grid = -(-npg * ps // pk)
    for ranges in kattn.paged_partitions(pos, ps, npg, window, pk):
        assert len(ranges) <= grid
        assert all(k1 <= npg * ps for _, k1 in ranges)


def test_partition_plan_is_fixed():
    """The same inputs give the same plan, whatever else the batch holds:
    a sequence's ranges depend on its own pos only."""
    a = kattn.paged_partitions([76, 520, 1023, 4000], 256, 5, 0, 64)
    b = kattn.paged_partitions([520, 76], 256, 5, 0, 64)
    assert a == kattn.paged_partitions([76, 520, 1023, 4000], 256, 5, 0, 64)
    assert b == [a[1], a[0]]
    assert [len(r) for r in a] == [4, 12, 16, 20]


@pytest.mark.parametrize("hd,bits,pk", [(128, 8, 64), (128, 16, 64),
                                        (128, 32, 64), (64, 8, 128),
                                        (16, 8, 512), (16, 16, 512),
                                        (16, 32, 512), (32, 32, 256)])
def test_partition_keys_follow_the_kernel_geometry(hd, bits, pk):
    """A partition holds 8192 K words: 8192 / hd keys."""
    assert kattn.paged_partition_keys(hd, bits) == pk


# -- the split reference against the Pallas kernel ------------------------------


def _pool(seed, n):
    rng = np.random.default_rng(seed)
    kf = rng.normal(size=(P, PS, HKV, HD)).astype(np.float32)
    vf = rng.normal(size=(P, PS, HKV, HD)).astype(np.float32)
    kw = np.array(jtakum.float_to_takum(jnp.asarray(kf), n))
    vw = np.array(jtakum.float_to_takum(jnp.asarray(vf), n))
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, NP), np.int32)
    table[0] = perm[:NP]
    table[1] = perm[NP:2 * NP]
    table[2, :2] = perm[8:10]
    q = rng.normal(size=(B, 1, HKV * G, HD)).astype(np.float32)
    return q, kw, vw, table


NAR16 = 1 << 15
# name -> (seed, pos, start, window, the NaR words (pool, page-table row,
# page column, offset, head, dim))
SPLIT_CASES = {
    "idle_slot": (0, [NP * PS - 1, 37, 20, 10 * NP * PS], [0, 5, 3, 0], 0, []),
    "window_7": (1, [60, 37, 20, 0], [0, 0, 0, 0], 7, []),
    "window_24_idle": (2, [60, 37, 12, 10 * NP * PS], [0, 40, 0, 0], 24, []),
    # a NaR K word at a valid position of sequence 1 (position 8, head 0)
    "nar_k_valid": (5, [NP * PS - 1, 37, 20, 0], [0, 0, 0, 0], 0,
                    [("k", 1, 0, 8, 0, 0)]),
    # a NaR V word at a masked position (past pos) of a visited page
    "nar_v_masked": (6, [NP * PS - 1, 37, 20, 0], [0, 0, 0, 0], 0,
                     [("v", 1, 2, 10, 1, 3)]),
    # every key of sequence 1 masked (start past pos): V averaged
    "all_masked": (7, [60, 37, 20, 0], [0, 40, 0, 0], 0, []),
}
PKS = [1, 3, 16, 40, 64]


@functools.lru_cache(maxsize=None)
def _split_case(name):
    seed, pos, start, window, nars = SPLIT_CASES[name]
    q, kw, vw, table = _pool(seed, 16)
    for which, b, col, off, head, dim in nars:
        (kw if which == "k" else vw)[table[b, col], off, head, dim] = NAR16
    pos, start = np.array(pos, np.int32), np.array(start, np.int32)
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(table),
        "takum16", pos=jnp.asarray(pos), start=jnp.asarray(start),
        window=window, use_kernel=True, interpret=True))
    return q, kw, vw, table, pos, start, window, want


@pytest.mark.parametrize("pk", PKS)
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_reference_matches_reference_kernel(name, pk):
    q, kw, vw, table, pos, start, window, want = _split_case(name)
    got = ref.paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kw), torch.from_numpy(vw),
        torch.from_numpy(table), "takum16", pos=torch.from_numpy(pos),
        start=torch.from_numpy(start), window=window, partitions=pk).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    if name == "nar_k_valid":        # NaN in exactly the rows of head 0
        assert np.isnan(got[1, 0, :G]).all()
        assert np.isfinite(got[1, 0, G:]).all() and np.isfinite(got[0]).all()
    if name == "nar_v_masked":       # p = 0 at the masked key, 0 x NaN
        assert np.isnan(got[1, 0, G:, 3]).all()
        assert int(np.isnan(got).sum()) == G
    if name == "window_24_idle":     # the idle slot has no in-band page
        assert (got[3] == 0).all()


@pytest.mark.parametrize("pk", [1, 3, 16, 40])
def test_partitions_with_no_key_contribute_nothing(pk):
    """A short sequence in a wide table: most grid slots past its plan
    visit no key; the split result equals the unsplit one (the merge skips
    them)."""
    q, kw, vw, table = _pool(8, 16)
    pos = torch.tensor([3, 17, 0, 33], dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(kw), torch.from_numpy(vw),
            torch.from_numpy(table), "takum16")
    grid = -(-NP * PS // pk)
    plans = kattn.paged_partitions(pos.tolist(), PS, NP, 0, pk)
    assert min(len(r) for r in plans) < grid
    got = ref.paged_attention_ref(*args, pos=pos, partitions=pk)
    want = ref.paged_attention_ref(*args, pos=pos)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["none", "takum8", "lns-takum8", "posit8"])
def test_split_reference_matches_unsplit_over_formats(name):
    """Every KV format the kernel reads: the split reference against the
    unsplit one on the same words (f32 values for the float cache)."""
    from repro_torch import formats
    spec = formats.get(name)
    g = torch.Generator().manual_seed(3)
    kf = torch.randn((P, PS, HKV, HD), generator=g)
    vf = torch.randn((P, PS, HKV, HD), generator=g)
    if spec.is_identity:
        kw, vw = kf, vf
    else:
        kw, vw = spec.encode_tile(kf), spec.encode_tile(vf)
    _, _, _, table = _pool(9, 16)
    q = torch.randn((B, 1, HKV * G, HD), generator=g)
    pos = torch.tensor([NP * PS - 1, 37, 20, 10 * NP * PS], dtype=torch.int32)
    args = (q, kw, vw, torch.from_numpy(table), spec)
    want = ref.paged_attention_ref(*args, pos=pos, window=9)
    for pk in (1, 7, 64):
        got = ref.paged_attention_ref(*args, pos=pos, window=9, partitions=pk)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
