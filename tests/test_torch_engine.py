"""The port's group machinery (``polars_tpu_torch.engine.groupby``) and its
Q1 kernel step (``polars_tpu_torch.entry``) against the JAX package on the
same numpy inputs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polars_tpu.datatypes as dtj
import polars_tpu_torch
import polars_tpu_torch.datatypes as dtt
from __graft_entry__ import entry as jax_entry
from polars_tpu.engine import groupby as GJ
from polars_tpu.engine.common import ROW as ROW_J
from polars_tpu.engine.common import Val as ValJ
from polars_tpu_torch.engine import groupby as GT
from polars_tpu_torch.engine.common import ROW as ROW_T
from polars_tpu_torch.engine.common import Val as ValT
from polars_tpu_torch.entry import entry as torch_entry


@pytest.fixture(autouse=True)
def _cpu_default_device():
    prev = polars_tpu_torch.set_default_device("cpu")
    yield
    polars_tpu_torch.set_default_device(prev)


def test_entry_matches_graft_entry():
    step_j, args_j = jax_entry()
    want = jax.jit(step_j)(*args_j)
    step_t, args_t = torch_entry()
    got = step_t(*args_t)
    assert len(got) == len(want) == 8
    for i in (0, 1, 2, 3, 4, 5):  # sums and means: f64 in another order
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-12)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))  # counts
    assert int(got[7]) == int(want[7])  # num_groups


def _keys(seed: int, n: int, null_key: bool):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, n).astype(np.int32)
    b = rng.integers(0, 2, n).astype(np.int32)
    a[a == 1] = 2  # code 1 never occurs: an empty group slot
    valid = rng.random(n) < 0.8 if null_key else None
    rowmask = rng.random(n) < 0.9
    return a, b, valid, rowmask


def _dense_jax(a, b, valid, rowmask):
    def f(a, b, valid, rowmask):
        ka = ValJ(a, valid, dtj.String(), None, ROW_J)
        kb = ValJ(b, None, dtj.String(), None, ROW_J)
        g = GJ.dense_group_ctx([ka, kb], rowmask, [3, 2])
        return g.gids, g.num_groups, g.group_valid, GJ.seg_count(rowmask, g.gids, g.capacity)

    return [np.asarray(x) for x in jax.jit(f)(a, b, valid, rowmask)] + [12]


def _dense_torch(a, b, valid, rowmask):
    ka = ValT(torch.from_numpy(a), None if valid is None else torch.from_numpy(valid), dtt.String(), None, ROW_T)
    kb = ValT(torch.from_numpy(b), None, dtt.String(), None, ROW_T)
    g = GT.dense_group_ctx([ka, kb], torch.from_numpy(rowmask), [3, 2])
    return g


@pytest.mark.parametrize("null_key", [False, True])
def test_dense_group_ctx_matches_jax(null_key):
    a, b, valid, rowmask = _keys(3, 2000, null_key)
    if valid is None:
        valid = np.ones_like(rowmask)
    gids_j, ng_j, gv_j, counts_j, cap_j = _dense_jax(a, b, valid, rowmask)
    g = _dense_torch(a, b, valid if null_key else None, rowmask)
    assert g.capacity == cap_j
    assert int(g.num_groups) == int(ng_j)
    np.testing.assert_array_equal(g.group_valid.numpy(), gv_j)
    # the occupancy pass's counts, kept for len/count/mean, in group order
    np.testing.assert_array_equal(g.counts.numpy(), counts_j)
    np.testing.assert_array_equal(g.gids.numpy()[rowmask], gids_j[rowmask])
    # the slot of each group decodes back to its keys
    slots = g.slots.numpy()[: int(g.num_groups)]
    codes = np.where(valid, a + 1, 0) * 3 + (b + 1)
    for gid, slot in enumerate(slots):
        assert set(codes[rowmask & (g.gids.numpy() == gid)]) == {slot}


@pytest.mark.parametrize("name", ["seg_sum", "seg_count", "seg_min", "seg_max", "seg_mean", "seg_first_idx"])
def test_segment_reductions_match_jax(name):
    rng = np.random.default_rng(11)
    n, cap = 3000, 12
    gids = rng.integers(0, cap - 1, n).astype(np.int32)  # slot cap-1 stays empty
    mask = rng.random(n) < 0.7
    vals = rng.normal(size=n) * 100.0
    vals[::97] = np.nan
    fj, ft = getattr(GJ, name), getattr(GT, name)
    if name == "seg_count":
        want = jax.jit(lambda m, g: fj(m, g, cap))(mask, gids)
        got = ft(torch.from_numpy(mask), torch.from_numpy(gids), cap)
    else:
        v = vals if name in ("seg_min", "seg_max") else np.nan_to_num(vals)
        if name == "seg_first_idx":
            want = jax.jit(lambda m, g: fj(m, g, cap))(mask, gids)
            got = ft(torch.from_numpy(mask), torch.from_numpy(gids), cap)
        else:
            want = jax.jit(lambda x, m, g: fj(x, m, g, cap))(v, mask, gids)
            got = ft(torch.from_numpy(v), torch.from_numpy(mask), torch.from_numpy(gids), cap)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy().astype(np.float64), np.asarray(w).astype(np.float64), rtol=1e-12)


def test_integer_seg_sum_is_exact():
    rng = np.random.default_rng(5)
    n, cap = 2000, 6
    gids = rng.integers(0, cap, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    v = rng.integers(-(2**40), 2**40, n)
    want = jax.jit(lambda x, m, g: GJ.seg_sum(x, m, g, cap))(jnp.asarray(v), mask, gids)
    got = GT.seg_sum(torch.from_numpy(v), torch.from_numpy(mask), torch.from_numpy(gids), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_validation_flags_ride_the_count_readback():
    from polars_tpu_torch.engine.executors import _read_count
    from polars_tpu_torch.errors import InvalidOperationError

    count = torch.tensor(4, dtype=torch.int64)  # K2's device total
    assert _read_count(count, [(torch.tensor(False), "never")]) == 4
    flags = [(torch.tensor(False), "first"), (torch.tensor(True), "second"), (torch.tensor(True), "third")]
    with pytest.raises(InvalidOperationError, match="second"):  # the earliest raised flag wins
        _read_count(count, flags)


def test_sorted_group_ctx_names_its_slice():
    """The sort-based group-by (ported with Q3/Q4): without keys every kept
    row is one group, as in the JAX package; a host-sized equi-join runs
    (an m:m self-join: 2 x 2 + 1 pairs) and a range join names its port queue
    item."""
    rowmask = np.asarray([False, True, True, False, True])
    g = GT.sorted_group_ctx([], torch.from_numpy(rowmask))
    gids_j, num_j, valid_j = jax.jit(lambda m: (lambda c: (c.gids, c.num_groups, c.group_valid))(
        GJ.sorted_group_ctx([], m)))(jnp.asarray(rowmask))
    assert int(g.num_groups) == int(num_j) == 1
    np.testing.assert_array_equal(g.group_valid.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(g.gids.numpy()[rowmask], np.asarray(gids_j)[rowmask])
    df = polars_tpu_torch.DataFrame({"k": [1, 1, 2]}, device="cpu")
    assert df.lazy().join(df.lazy(), on="k").collect().to_dict(as_series=False) == {"k": [1, 1, 1, 1, 2]}
    with pytest.raises(NotImplementedError, match="join_where and join_asof"):
        df.lazy().join_where(df.lazy(), polars_tpu_torch.col("k") < polars_tpu_torch.col("k"))
