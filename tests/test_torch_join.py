"""The port's in-segment joins and row hashing against polars_tpu.

The same inputs, made from a numpy seed, go through ``polars_tpu`` (JAX on
the CPU) and ``polars_tpu_torch`` (``device="cpu"``, where every kernel
wrapper runs its plain version). Keys, strings and counts must be equal;
floats agree to rtol 1e-9.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu.kernels import hashing as HJ
from polars_tpu_torch.kernels import hashing as HT


@pytest.fixture(autouse=True)
def _cpu_default_device():
    prev = plt.set_default_device("cpu")
    yield
    plt.set_default_device(prev)


def _assert_frames_match(got, want, *, rtol=1e-9):
    assert [(n, repr(d)) for n, d in got.schema.items()] == [(n, repr(d)) for n, d in want.schema.items()]
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    for name, wcol in w.items():
        if isinstance(want.schema[name], plj.datatypes.FloatType):
            assert [v is None for v in g[name]] == [v is None for v in wcol], name
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            np.testing.assert_allclose(gv, wv, rtol=rtol, equal_nan=True, err_msg=name)
        else:
            assert g[name] == wcol, name


def _both(data: dict):
    return plj.DataFrame(data), plt.DataFrame(data, device="cpu")


@pytest.fixture(scope="module")
def sides():
    """A probe side (many rows, keys with nulls and misses) and a build side
    (unique keys) with a column name in common."""
    rng = np.random.default_rng(23)
    n, m = 300, 40
    k = rng.integers(0, 60, n)
    left = {
        "row": np.arange(n),
        "k": [None if r < 0.08 else int(v) for r, v in zip(rng.random(n), k)],
        "s": np.asarray(["ant", "bee", "cat", "dog", "eel", None], object)[rng.integers(0, 6, n)],
        "f": np.round(rng.normal(size=n), 1),
        "k2": rng.integers(0, 3, n),
        "v": rng.normal(size=n),
    }
    left["f"][rng.random(n) < 0.05] = -0.0
    right = {
        "k": rng.permutation(80)[:m],
        "s": np.asarray(["bee", "cat", "dog", "fox", "gnu", "hen", "ant", "yak"] * 5, object)[:m],
        "f": np.round(np.linspace(-2.0, 2.0, m), 1),
        "k2": np.arange(m) % 3,
        "v": rng.normal(size=m),
        "w": rng.integers(-5, 5, m).astype(np.int32),
    }
    return _both(left), _both(right)


@pytest.mark.parametrize(
    "case",
    [
        "m1_inner", "m1_left_with_misses", "semi", "anti", "semi_string_key", "m1_semi", "m1_anti",
        "string_keys_two_dictionaries", "string_keys_left", "float_key_hash_verify", "two_column_key",
        "nulls_equal", "suffix_and_no_coalesce", "filter_both_sides",
    ],
)
def test_join_matches_polars_tpu(sides, case):
    def plan(pl, left, right):
        lf, rf = left.lazy(), right.lazy()
        if case == "m1_inner":
            out = lf.join(rf, on="k", validate="m:1")
        elif case == "m1_left_with_misses":
            out = lf.join(rf, on="k", how="left", validate="m:1")
        elif case == "semi":
            out = lf.join(rf, on="k", how="semi")
        elif case == "anti":
            out = lf.join(rf, on="k", how="anti")
        elif case == "semi_string_key":
            out = lf.join(rf.select("s", "w"), on="s", how="semi")
        elif case == "m1_semi":
            out = lf.join(rf, on="k", how="semi", validate="m:1")
        elif case == "m1_anti":
            out = lf.join(rf, on="k", how="anti", validate="m:1")
        elif case == "string_keys_two_dictionaries":
            out = lf.join(rf.select("s", "w").filter(pl.col("w") > -99).head(8), on="s", validate="m:1")
        elif case == "string_keys_left":
            out = lf.join(rf.select("s", "w").head(8), on="s", how="left", validate="m:1")
        elif case == "float_key_hash_verify":
            out = lf.join(rf.select("f", "w"), on="f", how="left", validate="m:1")
        elif case == "two_column_key":
            out = lf.join(rf.select("k", "k2", "w"), on=["k", "k2"], how="left", validate="m:1")
        elif case == "nulls_equal":  # the left side's null keys meet the right side's one null key
            nulls = pl.DataFrame({"k": [None, 1, 2, 3], "w": [7, 8, 9, 10]}, **({"device": "cpu"} if pl is plt else {}))
            out = lf.join(nulls.lazy(), on="k", how="left", validate="m:1", nulls_equal=True)
        elif case == "suffix_and_no_coalesce":
            out = lf.join(rf, left_on="k", right_on="k", how="inner", validate="m:1", suffix="_r", coalesce=False)
        else:  # filter_both_sides
            out = lf.filter(pl.col("v") > -1.0).join(rf.filter(pl.col("w") >= 0), on="k", validate="m:1")
        return out.sort("row")

    (lj, lt), (rj, rt) = sides
    want = plan(plj, lj, rj).collect()
    got = plan(plt, lt, rt).collect()
    assert want.height > 0
    _assert_frames_match(got, want)


def test_one_to_many_inner_join_is_flipped(sides):
    """validate="1:m": the right side probes the unique left side; the output
    follows the right side's rows, the left columns gathered to them."""
    (lj, lt), _ = sides

    # the 1:m build side is the LEFT frame: make its keys unique
    uj = plj.DataFrame({"k": np.arange(0, 80, 2), "w": np.arange(40, dtype=np.int32)})
    ut = plt.DataFrame({"k": np.arange(0, 80, 2), "w": np.arange(40, dtype=np.int32)})

    def plan2(pl, unique, many):
        return unique.lazy().join(many.lazy().select("row", "k", "v"), on="k", validate="1:m").sort("row")

    want = plan2(plj, uj, lj).collect()
    got = plan2(plt, ut, lt).collect()
    assert 0 < want.height < lj.height
    _assert_frames_match(got, want)


def test_one_to_one_join(sides):
    """validate="1:1" also counts each build row's matches (a K1 count)."""
    _, (rj, rt) = sides

    def plan(pl, right):
        lf = right.lazy().select("k", "v").filter(pl.col("v") > -0.5)
        return lf.join(right.lazy().select("k", "w", "s"), on="k", validate="1:1").sort("k")

    want = plan(plj, rj).collect()
    assert 0 < want.height < rj.height
    _assert_frames_match(plan(plt, rt).collect(), want)


def test_violated_validate_raises(sides):
    """A right side with a duplicate key breaks m:1: the flag rides the count
    read-back and collect raises ComputeError, as in polars_tpu."""
    (lj, lt), _ = sides
    dup = {"k": np.asarray([1, 2, 2, 3]), "z": np.arange(4)}
    rj, rt = _both(dup)
    with pytest.raises(plj.ComputeError, match="validation"):
        lj.lazy().join(rj.lazy(), on="k", validate="m:1").collect()
    with pytest.raises(plt.ComputeError, match="validation"):
        lt.lazy().join(rt.lazy(), on="k", validate="m:1").collect()


def test_two_violated_validations_raise_together(sides):
    """Two joins of one segment break their declared cardinality at once.
    The port raises; polars_tpu's count channel negates the already negated
    count for the second flag, so the two cancel there (a known fault of the
    reference, ROADMAP section 3)."""
    (lj, lt), _ = sides
    dup = {"k": np.asarray([1, 2, 2, 3]), "z": np.arange(4)}
    dup2 = {"k2": np.asarray([0, 0, 1]), "y": np.arange(3)}
    _, rt = _both(dup)
    _, rt2 = _both(dup2)
    lf = lt.lazy().join(rt.lazy(), on="k", validate="m:1").join(rt2.lazy(), on="k2", validate="m:1")
    with pytest.raises(plt.ComputeError, match="validation"):
        lf.collect()
    # one valid and one violated join: still raises
    ok = plt.DataFrame({"k2": np.asarray([0, 1, 2]), "y": np.arange(3)})
    lf = lt.lazy().join(ok.lazy(), on="k2", validate="m:1").join(rt.lazy(), on="k", validate="m:1")
    with pytest.raises(plt.ComputeError, match="validation"):
        lf.collect()


def test_host_sized_joins_name_their_queue_item(sides):
    """The joins that size their output on the host: equi-joins of every
    ``how`` run (``tests/test_torch_join_host.py``), a range or asof join
    still names its queue item."""
    (lj, lt), (rj, rt) = sides
    want = lj.lazy().join(rj.lazy(), on="k").collect()  # m:m inner
    _assert_frames_match(lt.lazy().join(rt.lazy(), on="k").collect(), want)
    with pytest.raises(NotImplementedError, match="join_where and join_asof"):
        lt.lazy().join_where(rt.lazy(), plt.col("k") < plt.col("k2"))


def test_join_kernel_calls(sides, monkeypatch):
    """A validated 1:1 join counts its build hits with K1; a join, like any
    segment, ends in one K2 compaction."""
    from polars_tpu_torch.engine import executors as X
    from polars_tpu_torch.engine import groupby as G
    from polars_tpu_torch.kernels.compact import compact_scatter
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    calls = []

    def k1(gids, cols, mask, cap):
        calls.append(("K1", cap))
        return groupagg_sums(gids, cols, mask, cap)

    def k2(cols, mask, offs, count):
        calls.append(("K2", mask.shape[0]))
        return compact_scatter(cols, mask, offs, count)

    monkeypatch.setattr(G, "groupagg_sums", k1)
    monkeypatch.setattr(X, "compact_scatter", k2)
    _, (_, rt) = sides
    rt.lazy().select("k", "v").join(rt.lazy().select("k", "w"), on="k", validate="1:1").collect()
    assert calls == [("K1", rt.height), ("K2", rt.height)]


# ---------------------------------------------------------------------------
# hashing: bit for bit against polars_tpu.kernels.hashing
# ---------------------------------------------------------------------------

_EDGE_INTS = np.asarray([0, -1, 1, -(2**63), 2**63 - 1, 2**32, -(2**31), 0x9E3779B97F4A7C15 - 2**64], np.int64)


def _edge_floats() -> np.ndarray:
    nan_payloads = np.asarray([0x7FF0000000000001, 0xFFF8000000000123, 0x7FF8000000000000], np.uint64).view(np.float64)
    specials = np.asarray([
        0.0, -0.0, np.inf, -np.inf, 1.5, -3.25e300, 1.7976931348623157e308, 3.4e38, 3.5e38, 1 / 3,
        2.0**-126, 2.0**-127, 2.0**-140, -(2.0**-140), 2.0**-100 + 2.0**-130, 1e-310, -1e-310,
    ])
    rng = np.random.default_rng(5)
    return np.concatenate([nan_payloads, specials, rng.normal(size=200) * 10.0 ** rng.integers(-40, 40, 200)])


def test_splitmix64_bit_for_bit():
    rng = np.random.default_rng(3)
    x = np.concatenate([_EDGE_INTS, rng.integers(-(2**63), 2**63 - 1, 500, dtype=np.int64)])
    want = np.asarray(jax.jit(HJ.splitmix64)(jnp.asarray(x)))
    np.testing.assert_array_equal(HT.splitmix64(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("kind", ["int64", "int32", "bool", "float64", "float32", "nulls"])
def test_hash_column_bit_for_bit(kind):
    rng = np.random.default_rng(4)
    validity = None
    if kind == "int64":
        x = np.concatenate([_EDGE_INTS, rng.integers(-(2**63), 2**63 - 1, 300, dtype=np.int64)])
    elif kind == "int32":
        x = rng.integers(-(2**31), 2**31 - 1, 300, dtype=np.int32)
    elif kind == "bool":
        x = rng.random(50) < 0.5
    elif kind == "float64":
        x = _edge_floats()
    elif kind == "float32":
        with np.errstate(over="ignore"):
            x = np.concatenate([_edge_floats().astype(np.float32), np.asarray([1e-40, -1e-40, 1e-45], np.float32)])
    else:
        x = np.concatenate([_EDGE_INTS, rng.integers(-100, 100, 100)])
        validity = rng.random(len(x)) < 0.7
    for seed in (0, 7, 13):
        want = np.asarray(jax.jit(lambda v, m, s=seed: HJ.hash_column(v, m, s))(
            jnp.asarray(x), None if validity is None else jnp.asarray(validity)))
        got = HT.hash_column(torch.from_numpy(x), None if validity is None else torch.from_numpy(validity), seed)
        np.testing.assert_array_equal(got.numpy(), want)


def test_combine_hashes_and_hash_columns_bit_for_bit():
    rng = np.random.default_rng(6)
    a = np.concatenate([_EDGE_INTS, rng.integers(-(2**63), 2**63 - 1, 300, dtype=np.int64)])
    b = rng.permutation(a)
    want = np.asarray(jax.jit(HJ.combine_hashes)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(HT.combine_hashes(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    f = rng.normal(size=len(a))
    valid = rng.random(len(a)) < 0.8
    want = np.asarray(jax.jit(lambda x, y, m: HJ.hash_columns([(x, None), (y, m)], 7))(
        jnp.asarray(a), jnp.asarray(f), jnp.asarray(valid)))
    got = HT.hash_columns([(torch.from_numpy(a), None), (torch.from_numpy(f), torch.from_numpy(valid))], 7)
    np.testing.assert_array_equal(got.numpy(), want)
