"""The port's kernel modules against the JAX package's reference functions.

K1 (``polars_tpu_torch.kernels.groupagg``) is held against
``groupagg_sums_xla`` and ``np.add.at``; K2 (``polars_tpu_torch.kernels.compact``)
against ``compact_columns_xla``. On CPU tensors the wrappers run their plain
PyTorch versions, so these tests check the arithmetic those versions share
with the CUDA kernels and the routing; ``chip_smoke.py`` holds the kernels
themselves against the plain versions on the card.
"""

from __future__ import annotations

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polars_tpu.kernels.pallas_compact import compact_columns_xla
from polars_tpu.kernels.pallas_groupagg import groupagg_sums_xla
from polars_tpu_torch.kernels.compact import compact, compact_plain
from polars_tpu_torch.kernels import groupagg as K1
from polars_tpu_torch.kernels.groupagg import MODE_GLOBAL, MODE_PRIVATE, MODE_SHARED, groupagg_sums, plan


@pytest.fixture(autouse=True)
def _launch_counters():
    groupagg_sums.launches = 0
    compact.launches = 0
    yield


def _groupagg_inputs(seed: int, n: int, cap: int, k: int):
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, cap, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    vals = rng.normal(size=(n, k)) * 1000.0
    return gids, mask, vals


@pytest.mark.parametrize("n,cap,k", [(1000, 12, 5), (777, 1, 3), (4096, 64, 2)])
def test_groupagg_f64_matches_xla(n, cap, k):
    gids, mask, vals = _groupagg_inputs(n + cap, n, cap, k)
    want = np.asarray(groupagg_sums_xla(jnp.asarray(gids), jnp.asarray(vals), jnp.asarray(mask), cap))
    got = groupagg_sums(
        torch.from_numpy(gids), [torch.from_numpy(np.ascontiguousarray(vals[:, c])) for c in range(k)],
        torch.from_numpy(mask), cap,
    )
    assert got.dtype == torch.float64 and got.shape == (cap, k)
    # both sum in f64 in a different order: rtol 1e-12
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n,cap", [(1000, 12), (0, 4), (513, 1)])
def test_groupagg_i64_exact(n, cap):
    rng = np.random.default_rng(n)
    gids = rng.integers(0, cap, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    v = rng.integers(-(2**50), 2**50, n)
    want = np.zeros((cap, 2), np.int64)
    np.add.at(want[:, 0], gids[mask], v[mask])
    np.add.at(want[:, 1], gids[mask], 1)
    got = groupagg_sums(torch.from_numpy(gids), [torch.from_numpy(v), None], torch.from_numpy(mask), cap)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_groupagg_drops_out_of_range_ids():
    gids = torch.tensor([0, 1, -1, 5, 2], dtype=torch.int32)
    mask = torch.ones(5, dtype=torch.bool)
    got = groupagg_sums(gids, [torch.arange(5, dtype=torch.int64)], mask, 3)
    assert got[:, 0].tolist() == [0, 1, 4]


def _check_plan(p, cap, k, sms, n):
    """What every launch shape must satisfy: see csrc/groupagg.cu ``groupagg``."""
    assert 1 <= p.kt <= min(k, K1.MAX_KT)
    assert p.threads in K1.CONSUMER_THREADS and p.threads % 32 == 0
    # tiles start at multiples of tile_rows: 16-row (and 16-byte) aligned for every operand
    assert p.tile_rows % 16 == 0 and p.tile_rows % (p.threads * K1.ROWS_PER_THREAD) == 0
    assert K1.MIN_STAGES <= p.stages <= K1.MAX_STAGES
    assert 1 <= p.blocks <= sms and 1 <= p.slices <= p.blocks
    words = K1.NWORDS if p.words else 1  # exact words: four int64 accumulators per f64 sum
    assert not p.words or p.mode == MODE_GLOBAL
    acc = {MODE_PRIVATE: p.threads, MODE_SHARED: p.repl, MODE_GLOBAL: 0}[p.mode] * cap * p.kt * 8
    ring = p.stages * p.tile_rows * (8 * p.kt + 4 + 1)
    assert K1.HEADER + acc + ring <= p.smem <= K1.SMEM_MAX == 232448
    if p.mode == MODE_SHARED:
        assert 1 <= p.repl <= p.threads // 32
    if p.mode == MODE_GLOBAL:
        assert p.slices * cap * p.kt * 8 * words <= max(K1.GLOBAL_SCRATCH_MAX, cap * p.kt * 8 * words)
    else:
        assert p.slices == p.blocks
    if n < p.tile_rows:
        assert p.blocks == 1  # no full tile: one block takes the ragged rows


@pytest.mark.parametrize(
    "cap,k,mode",
    [(12, 10, MODE_PRIVATE), (1024, 5, MODE_SHARED), (65536, 3, MODE_GLOBAL),
     (12, 5, MODE_PRIVATE), (12, 1, MODE_PRIVATE), (1, 1, MODE_PRIVATE), (65536, 17, MODE_GLOBAL)],
)
def test_groupagg_plan_covers_dense_capacities(cap, k, mode):
    p = plan(cap, k, 132, 60_000_000)
    assert p.mode == mode
    _check_plan(p, cap, k, 132, 60_000_000)
    assert p.blocks == 132  # persistent: one block per SM, however many rows


@pytest.mark.parametrize("k", [1, 2, 5, 16, 17, 40])
def test_groupagg_plan_sweep_fits_shared_memory(k):
    modes = set()
    for cap in [1, 2, 3, 12, 13, 100, 213, 214, 500, 1024, 4095, 4096, 4097, 20000, 29000, 65535, 65536]:
        for sms, n in [(132, 60_000_000), (132, 0), (132, 1), (132, 2047), (132, 2048), (132, 100_000), (7, 5_000)]:
            p = plan(cap, k, sms, n)
            _check_plan(p, cap, k, sms, n)
            modes.add(p.mode)
    assert modes == {MODE_PRIVATE, MODE_SHARED, MODE_GLOBAL}


@pytest.mark.parametrize("k", [1, 5, 17])
def test_groupagg_plan_f64_sweep_adds_exact_words_in_global_scratch(k):
    """An f64 call runs in the mode that any call of its shape runs in, and
    adds exact words (``Plan.words``) in global scratch only; the private and
    shared slices plan as for i64. Within shared memory and the scratch
    bounds."""
    modes = set()
    for cap in [1, 12, 13, 100, 214, 1024, 4096, 4097, 20000, 65536, 60_000_000]:
        for sms, n in [(132, 60_000_000), (132, 1), (132, 2048), (7, 5_000)]:
            p, q = plan(cap, k, sms, n, True), plan(cap, k, sms, n)
            _check_plan(p, cap, k, sms, n)
            assert p.mode == q.mode and p.words == (p.mode == MODE_GLOBAL) and not q.words
            if p.words:
                assert p.slices * cap * p.kt * 8 * K1.NWORDS <= max(K1.WORDS_SCRATCH_MAX, K1.GLOBAL_SCRATCH_MAX)
            else:
                assert p == q
            modes.add(p.mode)
    assert modes == {MODE_PRIVATE, MODE_SHARED, MODE_GLOBAL}


def test_groupagg_plan_q1_shapes():
    """PDS-H Q1's two calls: the f64 batch keeps private slices for 256
    threads beside a two-stage ring; the count has room for 512."""
    batch, count = plan(12, 5, 132, 60_000_000), plan(12, 1, 132, 60_000_000)
    assert (batch.mode, batch.kt, batch.threads, batch.tile_rows, batch.stages) == (MODE_PRIVATE, 5, 256, 1024, 2)
    assert (count.mode, count.kt, count.threads, count.tile_rows) == (MODE_PRIVATE, 1, 512, 2048)
    assert count.stages >= 4


def test_groupagg_masked_rows_may_hold_anything():
    """NaN, inf and ids out of range under a false mask never reach a sum
    (the kernel selects, it does not multiply by the mask)."""
    rng = np.random.default_rng(41)
    n, cap, k = 3000, 12, 3
    gids = rng.integers(0, cap, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    vals = rng.normal(size=(n, k)) * 100.0
    want = np.asarray(groupagg_sums_xla(jnp.asarray(gids), jnp.asarray(vals), jnp.asarray(mask), cap))
    bad = ~mask
    gids[bad] = rng.choice(np.asarray([-1, -(2**31), cap, 2**31 - 1], np.int32), int(bad.sum()))
    vals[bad] = rng.choice(np.asarray([np.nan, np.inf, -np.inf, 1e308]), (int(bad.sum()), k))
    ints = rng.integers(-(2**40), 2**40, n)
    ints[bad] = 2**62
    cols = [torch.from_numpy(np.ascontiguousarray(vals[:, c])) for c in range(k)]
    got = groupagg_sums(torch.from_numpy(gids), cols, torch.from_numpy(mask), cap)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
    got_i = groupagg_sums(torch.from_numpy(gids), [torch.from_numpy(ints), None], torch.from_numpy(mask), cap)
    want_i = np.zeros((cap, 2), np.int64)
    np.add.at(want_i[:, 0], gids[mask], ints[mask])
    np.add.at(want_i[:, 1], gids[mask], 1)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 3, 0), (0, 0, 5), (1, 3, 5)])
def test_groupagg_takes_views_with_a_storage_offset(offsets):
    """Contiguous views that start inside their storage (``x[1:]``) are taken
    as they are: their data pointers are not 16-byte aligned."""
    n, cap, k = 1000, 12, 2
    gids, mask, vals = _groupagg_inputs(sum(offsets), n, cap, k)
    want = np.asarray(groupagg_sums_xla(jnp.asarray(gids), jnp.asarray(vals), jnp.asarray(mask), cap))

    def view(arr, off):
        return torch.from_numpy(np.concatenate([np.zeros(off, arr.dtype), arr]))[off:]

    tg, tm = view(gids, offsets[0]), view(mask, offsets[1])
    cols = [view(np.ascontiguousarray(vals[:, c]), offsets[2]) for c in range(k)]
    assert tg.storage_offset() == offsets[0] and tm.storage_offset() == offsets[1]
    assert all(c.storage_offset() == offsets[2] and c.is_contiguous() for c in cols)
    got = groupagg_sums(tg, cols, tm, cap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
    # what the wrapper does refuse: a strided view
    with pytest.raises(TypeError):
        groupagg_sums(tg, [c[::2] for c in cols], tm, cap)


@pytest.mark.parametrize("k", [K1.MAX_KT + 1, 2 * K1.MAX_KT + 3])
def test_groupagg_more_columns_than_one_launch(k):
    n, cap = 600, 7
    gids, mask, vals = _groupagg_inputs(k, n, cap, k)
    want = np.asarray(groupagg_sums_xla(jnp.asarray(gids), jnp.asarray(vals), jnp.asarray(mask), cap))
    cols = [torch.from_numpy(np.ascontiguousarray(vals[:, c])) for c in range(k)]
    got = groupagg_sums(torch.from_numpy(gids), cols, torch.from_numpy(mask), cap)
    assert got.shape == (cap, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
    p = plan(cap, k, 132, n)
    assert p.kt <= K1.MAX_KT < k and -(-k // p.kt) >= 2  # the call takes several launches on the card


def _compact_reference(vals: np.ndarray, mask: np.ndarray):
    out, cnt = compact_columns_xla(jnp.asarray(vals[None, :]), jnp.asarray(mask))
    cnt = int(cnt)
    return np.asarray(out)[0, :cnt], cnt


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.int32, np.int8, np.bool_])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_compact_matches_xla(dtype, density):
    rng = np.random.default_rng(7)
    n = 1000
    if dtype == np.bool_:
        vals = rng.random(n) < 0.5
    elif dtype == np.float64:
        vals = rng.normal(size=n)
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    mask = rng.random(n) < density
    want, wcnt = _compact_reference(vals, mask)
    (got,), cnt = compact([torch.from_numpy(vals)], torch.from_numpy(mask))
    assert cnt == wcnt == int(mask.sum())
    np.testing.assert_array_equal(got.numpy(), want)


def test_compact_empty_and_multi_column():
    mask = torch.zeros(0, dtype=torch.bool)
    outs, cnt = compact([torch.zeros(0, dtype=torch.float64), torch.zeros(0, dtype=torch.bool)], mask)
    assert cnt == 0 and [o.shape[0] for o in outs] == [0, 0]
    mask = torch.tensor([True, False, True, True])
    cols = [torch.tensor([1.5, 2.5, 3.5, 4.5]), torch.tensor([1, 2, 3, 4], dtype=torch.int16),
            torch.tensor([True, True, False, True])]
    outs, cnt = compact(cols, mask)
    assert cnt == 3
    assert [o.tolist() for o in outs] == [[1.5, 3.5, 4.5], [1, 3, 4], [True, False, True]]


@contextlib.contextmanager
def _pallas_interpret():
    """Run the JAX package's Pallas kernels in interpret mode (the pattern of
    tests/test_kernels.py)."""
    import jax.experimental.pallas as jpl

    orig = jpl.pallas_call
    jpl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        jpl.pallas_call = orig


def test_groupagg_matches_pallas_kernel_in_interpret_mode():
    from polars_tpu.kernels import pallas_groupagg as PG

    gids, mask, vals = _groupagg_inputs(21, PG.BLOCK * 2, 100, 3)
    with _pallas_interpret():
        want = np.asarray(PG.groupagg_sums_pallas(jnp.asarray(gids), jnp.asarray(vals), jnp.asarray(mask), 128))
    got = groupagg_sums(
        torch.from_numpy(gids), [torch.from_numpy(np.ascontiguousarray(vals[:, c])) for c in range(3)],
        torch.from_numpy(mask), 128,
    )
    # the TPU kernel sums hi/lo f32 planes: tests/test_kernels.py's tolerance
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_compact_matches_pallas_kernel_in_interpret_mode():
    from polars_tpu.kernels import pallas_compact as PC

    rng = np.random.default_rng(22)
    k, n = 3, PC.BLOCK * 4
    vals = rng.normal(size=(k, n))
    mask = rng.random(n) > 0.4
    with _pallas_interpret():
        packed, cnt = PC.compact_columns_pallas(jnp.asarray(vals), jnp.asarray(mask))
    outs, got_cnt = compact([torch.from_numpy(vals[c].copy()) for c in range(k)], torch.from_numpy(mask))
    assert got_cnt == int(cnt)
    np.testing.assert_allclose(torch.stack(outs).numpy(), np.asarray(packed)[:, :got_cnt], rtol=1e-12)


def test_cpu_tensors_route_to_plain_versions():
    gids = torch.tensor([0, 1, 1], dtype=torch.int32)
    mask = torch.tensor([True, True, False])
    out = groupagg_sums(gids, [torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)], mask, 2)
    assert out[:, 0].tolist() == [1.0, 2.0]
    outs, cnt = compact([torch.tensor([1, 2, 3])], mask)
    assert compact_plain([torch.tensor([1, 2, 3])], mask)[1] == cnt == 2
    assert groupagg_sums.launches == 0 and compact.launches == 0


def test_wrappers_reject_bad_inputs():
    mask = torch.ones(3, dtype=torch.bool)
    with pytest.raises(TypeError):
        groupagg_sums(torch.zeros(3, dtype=torch.int64), [torch.zeros(3, dtype=torch.float64)], mask, 2)
    with pytest.raises(TypeError):
        groupagg_sums(torch.zeros(3, dtype=torch.int32), [torch.zeros(3, dtype=torch.float32)], mask, 2)
    with pytest.raises(TypeError):
        groupagg_sums(torch.zeros(3, dtype=torch.int32), [torch.zeros(4, dtype=torch.float64)], mask, 2)
    with pytest.raises(TypeError):
        compact([torch.zeros(3, dtype=torch.complex128)], mask)
    with pytest.raises(TypeError):
        compact([torch.zeros(3)], torch.ones(3, dtype=torch.int8))


@pytest.mark.parametrize("case", ["normal", "wide_range", "non_finite", "all_masked", "two_scales",
                                  "two_scales_60M_rows", "tiny_group_60M_rows"])
def test_groupagg_exact_words_sum_the_same_in_any_order(case):
    """K1's f64 sums in global scratch go through exact int64 words
    (``exact_words``/``from_words``): the i64 sums do not depend on the order
    of the adds, so two runs repeat bit for bit, and the result lies within
    an ulp or two of the exact sum (``math.fsum``); a group that sums a
    non-finite value gives inf or NaN as an f64 sum does. Here the i64 sums
    come from the plain version, in two row orders. In ``two_scales`` one
    group sums values near 1e12 and another values near 1e-20 in the same
    column; each value is split at its own group's scale, so both groups
    keep rtol 1e-9, at this call's 4000 rows (w = 50) and at the word width
    of a 60M-row call (w = 36). In ``tiny_group_60M_rows`` one group's values
    lie below 2^-108 of the column's largest, where one scale per column
    summed them to 0: each group is held to 4e-16 of ``math.fsum``."""
    import math

    rng = np.random.default_rng(17)
    n, cap = 4000, 23
    x = rng.normal(size=n) * 1000.0
    if case == "wide_range":
        x *= 10.0 ** rng.integers(-200, 200, n)
    if case == "non_finite":
        x[[5, 77, 901, 1500]] = [np.inf, -np.inf, np.nan, np.inf]
    mask = rng.random(n) < (0.0 if case == "all_masked" else 0.7)
    mask[[5, 77, 901, 1500]] = True if case == "non_finite" else mask[[5, 77, 901, 1500]]
    gids = rng.integers(0, cap, n).astype(np.int32)
    if case.startswith(("two_scales", "tiny_group")):
        x[gids == 0] = rng.uniform(0.5e12, 2e12, int((gids == 0).sum()))
        small = 2.0 ** -80 if case.startswith("tiny_group") else 1e-20  # 2^-80 < 2^-108 of 2^40 (~1e12)
        x[gids == 1] = rng.uniform(0.5, 2.0, int((gids == 1).sum())) * small
    rows = 60_000_000 if case.endswith("60M_rows") else n
    got = []
    for order in (np.arange(n), rng.permutation(n)):
        xt, mt, gt = (torch.from_numpy(np.ascontiguousarray(a[order])) for a in (x, mask, gids))
        words, e = K1.exact_words(xt, mt, gt, cap, rows)
        got.append(K1.from_words(K1.groupagg_sums_plain(gt, words, mt, cap), e, rows))
    assert torch.equal(got[0].view(torch.int64), got[1].view(torch.int64))
    for g in range(cap):
        sel = x[mask & (gids == g)]
        if not np.all(np.isfinite(sel)):
            want = float(np.sum(sel))
            assert (math.isnan(want) and math.isnan(got[0][g])) or want == float(got[0][g])
            continue
        want = math.fsum(sel.tolist())
        assert abs(float(got[0][g]) - want) <= 4e-16 * abs(want), (g, float(got[0][g]), want)
        if case.startswith("two_scales"):
            assert abs(float(got[0][g]) - want) <= 1e-9 * abs(want), (g, float(got[0][g]), want)
    if case.startswith("tiny_group"):
        assert 0.0 < float(got[0][1]) < 2.0 ** -60 * float(got[0][0])