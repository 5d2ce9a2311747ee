"""The port's host-sized joins (``engine/join.py``) against polars_tpu.

Every ``how`` of ``LazyFrame.join`` (inner, left, right, full and its alias
outer, semi, anti, cross), with and without ``validate``, ``nulls_equal``,
``suffix`` and ``coalesce``, over integer, string, UInt64, float, bool, date,
multi-column and expression keys. The same inputs, made from a numpy seed, go
through ``polars_tpu`` (JAX on the CPU) and ``polars_tpu_torch``
(``device="cpu"``, where K2 runs its plain version). Rows must come out in
the same order; keys, strings, dates and counts must be equal, floats agree
to rtol 1e-9. Where the reference is wrong (ROADMAP section 3) the port is
held to a Python oracle of Polars' semantics instead, and the test says so.
"""

from __future__ import annotations

import contextlib
import datetime as dtm

import numpy as np
import pytest
import torch

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu_torch.errors import OutOfBoundsError

HOWS = ["inner", "left", "right", "full", "outer", "semi", "anti"]


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


def _side(rng, n: int, keys: int, prefix: str) -> dict:
    """One side of a join: keys of every supported type with nulls and
    repeats, and a payload column of its own."""
    wide = keys + (4 if prefix == "l" else 0)  # left keys the right side lacks
    k = rng.integers(0, wide, n)
    null = np.arange(n) % 9 == 4  # nulls on both sides: see test_nulls_equal_with_nulls_on_one_side
    words = np.asarray(["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen"], object)
    f = np.round(rng.integers(0, wide, n) * 0.5 - 1.0, 1)
    f[rng.random(n) < 0.1] = np.nan
    f[f == 0.0] = -0.0
    return {
        "k": [None if z else int(v) for z, v in zip(null, k)],
        "k2": rng.integers(0, 3, n).astype(np.int32),
        "s": [None if r < 0.05 else str(v) for r, v in zip(rng.random(n), words[rng.integers(0, len(words), n)])],
        "f": [None if r < 0.05 else float(v) for r, v in zip(rng.random(n), f)],
        "b": rng.random(n) < (0.4 if prefix == "l" else 0.0),  # the right side lacks True
        "u": (np.uint64(2**63) + rng.integers(0, 4, n).astype(np.uint64)) if prefix == "l" else
             np.uint64(2**63) + rng.integers(1, 5, n).astype(np.uint64),
        "d": np.datetime64("1995-01-01") + rng.integers(0, keys, n).astype("timedelta64[D]"),
        "big": rng.integers(0, 3, n) * (1 << 40) + rng.integers(0, 2, n),
        f"{prefix}row": np.arange(n),
        f"{prefix}v": np.round(rng.normal(size=n), 3),
    }


@pytest.fixture(scope="module")
def frames():
    """A left side, a right side with repeated keys and a right side with
    unique keys (one of them null), as numpy columns; ``_pick`` builds (once)
    a frame of some of them in either package."""
    rng = np.random.default_rng(61)
    uniq = {"k": [None, *range(0, 28, 2)], "k2": np.arange(15, dtype=np.int32) % 3, "rrow": np.arange(15),
            "rv": np.round(rng.normal(size=15), 3)}
    return {"raw": {"left": _side(rng, 60, 12, "l"), "right": _side(rng, 45, 12, "r"), "uniq": uniq}, "built": {}}


def _pick(frames, pl, name, cols=None):
    """A frame of the columns ``cols`` (default all) of side ``name``, built
    from numpy: the tests cut frames eagerly, so that only the join runs (a
    select would add a segment, and a compile of the reference, per case)."""
    raw = frames["raw"][name]
    cols = tuple(raw) if cols is None else tuple(cols)
    key = (pl.__name__, name, cols)
    if key not in frames["built"]:
        data = {c: raw[c] for c in cols}
        frames["built"][key] = plj.DataFrame(data) if pl is plj else plt.DataFrame(data, device="cpu")
    return frames["built"][key]


@pytest.mark.parametrize("nulls_equal", [False, True])
@pytest.mark.parametrize("validate", ["m:m", "m:1"])
@pytest.mark.parametrize("how", [h for h in HOWS if h != "outer"])
def test_join_how_matches_polars_tpu(frames, how, validate, nulls_equal):
    """One integer key with nulls: m:m against repeated right keys, m:1
    against unique ones (the fused path for inner/left/semi/anti, the host
    path with its check for right and full). ``outer`` is ``full``
    (``test_join_options_match_polars_tpu``)."""
    def plan(pl):
        left = _pick(frames, pl, "left", ["k", "lrow", "lv"]).lazy()
        right = _pick(frames, pl, "right" if validate == "m:m" else "uniq", ["k", "rrow", "rv"]).lazy()
        return left.join(right, on="k", how=how, validate=validate, nulls_equal=nulls_equal).collect()

    want = plan(plj)
    assert want.height > 0
    _assert_frames_match(plan(plt), want)


KEYS = {
    "string": ["s"],  # two dictionaries: the codes meet in the merged one
    "uint64": ["u"],
    "float": ["f"],  # hashed, verified: NaN equals NaN, -0.0 equals 0.0
    "bool": ["b"],
    "date": ["d"],
    "packed": ["k2", "s", "b"],  # packs exactly into one word
    "hashed": ["k", "big"],  # two Int64 keys: hashed and verified
}


@pytest.mark.parametrize("how", ["left", "right", "full"])
@pytest.mark.parametrize("kind", list(KEYS))
def test_key_types_match_polars_tpu(frames, kind, how):
    """Each key type through the pair-making joins (the words are made the
    same way for every ``how``; semi and anti joins over hashed keys are
    ``test_host_semi_anti_match_polars_tpu``)."""
    keys = KEYS[kind]

    def plan(pl):
        left = _pick(frames, pl, "left", [*keys, "lrow", "lv"]).lazy()
        right = _pick(frames, pl, "right", [*keys, "rrow", "rv"]).lazy()
        return left.join(right, on=keys, how=how).collect()

    want = plan(plj)
    assert want.height > 0
    _assert_frames_match(plan(plt), want)


@pytest.mark.parametrize("how", ["semi", "anti"])
@pytest.mark.parametrize("kind", ["two_keys", "float_key", "nulls_equal"])
def test_host_semi_anti_match_polars_tpu(frames, kind, how):
    """The semi and anti joins the segment cannot match exactly (they raised
    in the port before): two keys, a float key, ``nulls_equal=True``."""
    keys = {"two_keys": ["k", "k2"], "float_key": ["f"], "nulls_equal": ["k"]}[kind]

    def plan(pl):
        left = _pick(frames, pl, "left").lazy()
        right = _pick(frames, pl, "right", [*keys, "rrow"]).lazy()
        return left.join(right, on=keys, how=how, nulls_equal=kind == "nulls_equal").collect()

    want = plan(plj)
    assert 0 < want.height < _pick(frames, plj, "left").height
    _assert_frames_match(plan(plt), want)


@pytest.mark.parametrize("case", ["left_on_right_on", "expression_keys", "suffix", "outer_no_coalesce",
                                  "full_coalesce", "cross", "cross_suffix", "join_nulls", "empty_right"])
def test_join_options_match_polars_tpu(frames, case):
    def plan(pl):
        left = _pick(frames, pl, "left").lazy()
        right = _pick(frames, pl, "right").lazy()
        left_k, right_k = _pick(frames, pl, "left", ["k", "lv"]).lazy(), _pick(frames, pl, "right", ["k", "rv"]).lazy()
        if case == "left_on_right_on":
            return left_k.join(right.select(pl.col("k").alias("kr"), "rv"), left_on="k", right_on="kr",
                               how="left").collect()
        if case == "expression_keys":
            return left_k.join(_pick(frames, pl, "right", ["k2", "rv"]).lazy(), left_on=pl.col("k") % 3,
                               right_on=pl.col("k2").cast(pl.Int64), how="inner").collect()
        if case == "suffix":  # every non-key name collides
            return _pick(frames, pl, "left", ["k", "s", "f", "lv"]).lazy().join(
                _pick(frames, pl, "right", ["k", "s", "f", "rv"]).lazy(), on="k", suffix="_r").collect()
        if case in ("outer_no_coalesce", "full_coalesce"):
            return _pick(frames, pl, "left", ["k", "s", "lv"]).lazy().join(
                _pick(frames, pl, "right", ["k", "s", "rv"]).lazy(), on=["k", "s"], how=case.split("_")[0],
                                                    coalesce=case == "full_coalesce").collect()
        if case == "cross":
            return left.select("lrow", "s").head(7).join(right.select("rrow", "rv").head(5), how="cross").collect()
        if case == "cross_suffix":
            return left.select("k", "s").head(4).join(right.select("k", "s").head(6), how="cross").collect()
        if case == "join_nulls":
            return left_k.join(right_k, on="k", join_nulls=True).collect()
        return left_k.join(right_k.filter(pl.col("rv") > 99.0), on="k", how="left").collect()

    want = plan(plj)
    assert want.height > 0
    _assert_frames_match(plan(plt), want)


def test_large_many_to_many_matches_polars_tpu():
    """Randomized m:m joins at a few thousand rows (about 6,000 pairs)."""
    rng = np.random.default_rng(29)
    n = 3000
    lj, lt = _both({"k": rng.integers(0, 1500, n), "lv": rng.normal(size=n), "lrow": np.arange(n)})
    rj, rt = _both({"k": rng.integers(0, 1500, n), "rv": rng.normal(size=n), "rrow": np.arange(n)})
    for how in ("inner", "full"):
        want = lj.lazy().join(rj.lazy(), on="k", how=how).collect()
        _assert_frames_match(lt.lazy().join(rt.lazy(), on="k", how=how).collect(), want)


@pytest.mark.parametrize("coalesce", [None, True, False])
@pytest.mark.parametrize("how", [*HOWS, "cross"])
def test_join_schema_matches_polars_tpu(frames, how, coalesce):
    """``_join_schema`` (repaired: coalesce defaults to True for right joins,
    a coalesced right join drops the left keys, a cross join has no keys)
    equals the reference's, and the collected frame has that schema."""
    def plan(pl):
        left = _pick(frames, pl, "left", ["k", "s", "lv"]).lazy()
        right = _pick(frames, pl, "right", ["k", "s", "rv"]).lazy()
        kw = {} if how == "cross" else {"left_on": "k", "right_on": "k"}
        return left.join(right, how=how, coalesce=coalesce, **kw)

    want = plan(plj).collect_schema()
    lf = plan(plt)
    assert [(n, repr(d)) for n, d in lf.schema.items()] == [(n, repr(d)) for n, d in want.items()]
    assert lf.collect().columns == list(want.names())


# ---------------------------------------------------------------------------
# where the reference is wrong: held to Polars' semantics
# ---------------------------------------------------------------------------


def _oracle_pairs(lkeys: list, rkeys: list, how: str, nulls_equal: bool) -> list:
    """(left row or None, right row or None) of each output row, in Polars'
    order: a right join follows the right rows, the others the left rows,
    and a full join appends the unmatched right rows."""
    def eq(a, b):
        if a is None or b is None:
            return nulls_equal and a is None and b is None
        return a == b

    if how == "right":
        return [(i, j) for j, b in enumerate(rkeys)
                for i in ([i for i, a in enumerate(lkeys) if eq(a, b)] or [None])]
    pairs = [(i, j) for i, a in enumerate(lkeys)
             for j in ([j for j, b in enumerate(rkeys) if eq(a, b)] or ([None] if how != "inner" else []))]
    if how == "full":
        hit = {j for _, j in pairs}
        pairs += [(None, j) for j in range(len(rkeys)) if j not in hit]
    return pairs


def test_right_join_columns_come_from_their_own_side():
    """A right join whose sides share a column name, or with
    ``coalesce=False``: Polars takes each left column from the left frame and
    the suffixed one from the right. ``polars_tpu`` maps its flipped left join
    back by name (``engine/join.py`` ``_reorder_right``) and so swaps them
    (ROADMAP section 3); the port is held to the oracle."""
    a = {"k": [1, 2, 2, 4, None], "x": ["a", "b", "c", "d", "e"]}
    b = {"k": [2, 3, 4, 2, None], "x": ["P", "Q", "R", "S", "T"]}
    pairs = _oracle_pairs(a["k"], b["k"], "right", False)

    def col(side, name, idx):
        return [None if i is None else side[name][i] for i in idx]

    li, ri = [p[0] for p in pairs], [p[1] for p in pairs]
    lt, rt = plt.DataFrame(a), plt.DataFrame(b)
    got = lt.lazy().join(rt.lazy(), on="k", how="right").collect()
    assert got.to_dict(as_series=False) == {"x": col(a, "x", li), "k": col(b, "k", ri), "x_right": col(b, "x", ri)}
    got = lt.lazy().join(rt.lazy(), on="k", how="right", coalesce=False).collect()
    assert got.to_dict(as_series=False) == {"k": col(a, "k", li), "x": col(a, "x", li),
                                            "k_right": col(b, "k", ri), "x_right": col(b, "x", ri)}
    lj, rj = plj.DataFrame(a), plj.DataFrame(b)  # the reference's swap, as found
    assert lj.lazy().join(rj.lazy(), on="k", how="right").collect()["x"].to_list() == col(b, "x", ri)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
@pytest.mark.parametrize("validate", ["m:m", "m:1"])
def test_nulls_equal_with_nulls_on_one_side(how, validate):
    """``nulls_equal=True`` where only the left keys have nulls: the other
    keys still match. ``polars_tpu`` hashes the side with nulls and keeps the
    raw words of the other, so nothing matches there (ROADMAP section 3); the
    port decides for both sides at once and is held to the oracle."""
    a = {"k": [1, None, 2, 1], "v": [10, 20, 30, 40]}
    b = {"k": [1, 2, 3], "w": [100, 200, 300]}
    got = plt.DataFrame(a).lazy().join(plt.DataFrame(b).lazy(), on="k", how=how, nulls_equal=True,
                                       validate=validate).collect()
    if how in ("semi", "anti"):
        keep = [i for i, x in enumerate(a["k"]) if (x in b["k"]) == (how == "semi")]
        assert got.to_dict(as_series=False) == {"k": [a["k"][i] for i in keep], "v": [a["v"][i] for i in keep]}
        return
    pairs = _oracle_pairs(a["k"], b["k"], "inner" if how == "inner" else how, True)
    ko = [b["k"][j] if how == "right" or (i is None) else a["k"][i] for i, j in pairs]
    want = {"v": [None if i is None else a["v"][i] for i, _ in pairs],
            "w": [None if j is None else b["w"][j] for _, j in pairs]}
    out = got.to_dict(as_series=False)
    assert out["v"] == want["v"] and out["w"] == want["w"]
    if how != "full":
        assert out["k"] == ko


def _fulfills(lkeys: list, rkeys: list, validate: str) -> bool:
    """Polars' rule: m:1 = the non-null right keys are unique, 1:m = the
    left keys, 1:1 = both."""
    def unique(keys):
        present = [k for k in keys if k is not None]
        return len(set(present)) == len(present)

    return (validate not in ("1:m", "1:1") or unique(lkeys)) and (validate not in ("m:1", "1:1") or unique(rkeys))


@pytest.mark.parametrize("validate", ["m:1", "1:m", "1:1"])
@pytest.mark.parametrize("how", ["left", "right", "full"])
@pytest.mark.parametrize("dups", ["left", "right", "none"])
def test_validate_on_the_host_path(how, validate, dups):
    """The host path checks ``validate`` as Polars does, over all the keys
    of a side (not only the matched ones) and raises ComputeError with
    Polars' wording. ``polars_tpu`` never checks it there
    (``polars_tpu/engine/join.py:461-620`` does not read ``validate``), so
    a right or full join, or a left join with 1:m, returns rows for keys
    that break the declaration (ROADMAP section 3). A left join with m:1 or
    1:1 fuses into its segment instead, as in ``polars_tpu``, where only the
    keys that match are checked: there the port's frame equals the
    reference's, and the duplicates here (7 on the left, 9 on the right)
    match nothing."""
    extra_left, extra_right = dups == "left", dups == "right"
    a = {"k": [1, 2, 7, None, None] + [7] * extra_left, "v": [1, 2, 3, 4, 5] + [6] * extra_left}
    b = {"k": [1, 3, 9, None, None] + [9] * extra_right, "w": [10, 30, 90, 0, 0] + [91] * extra_right}
    lf = plt.DataFrame(a).lazy().join(plt.DataFrame(b).lazy(), on="k", how=how, validate=validate)
    if how == "left" and validate != "1:m":
        matched = {k for k in a["k"] if k is not None} & set(b["k"])
        assert _fulfills([k for k in a["k"] if k in matched], [k for k in b["k"] if k in matched], validate)
        want = plj.DataFrame(a).lazy().join(plj.DataFrame(b).lazy(), on="k", how=how, validate=validate).collect()
        _assert_frames_match(lf.collect(), want)
        assert want.height == len(a["k"])
    elif _fulfills(a["k"], b["k"], validate):
        assert lf.collect().height > 0
    else:
        with pytest.raises(plt.ComputeError, match=f"join keys did not fulfill {validate} validation"):
            lf.collect()


# ---------------------------------------------------------------------------
# host reads and kernel K2 on the join path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _count_host_reads(monkeypatch):
    """Counts every tensor-to-Python conversion (where a CUDA tensor would
    synchronise)."""
    seen = {"reads": 0}
    for name in ("__int__", "__bool__", "__float__", "__index__", "item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **kw):
            seen["reads"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    yield seen
    monkeypatch.undo()


@pytest.mark.parametrize(
    "case, reads",
    [("inner_exact", 1), ("left_exact", 1), ("right_exact", 1), ("inner_hashed", 2), ("left_hashed", 2),
     ("full_exact", 2), ("full_hashed", 3), ("semi_exact", 1), ("anti_hashed", 2), ("cross_keys", 0),
     ("validated_right", 1)],
)
def test_host_reads_per_join_kind(frames, monkeypatch, case, reads):
    """The module docstring's counts: 1 read for exact keys, 2 for hashed
    keys, one more for a full join, none for a cross join; a declared
    ``validate`` rides the first read."""
    how, kind = case.split("_")
    left = _pick(frames, plt, "left").lazy()  # scans: no segment runs, only the join reads
    right = _pick(frames, plt, "right" if how != "validated" else "uniq").lazy()
    if how == "cross":
        lf = left.join(right, how="cross")
    elif how == "validated":
        lf = left.join(right, on="k", how="right", validate="m:1")
    else:
        lf = left.join(right, on=["k"] if kind == "exact" else ["k", "big"], how=how)
    with _count_host_reads(monkeypatch) as seen:
        out = lf.collect()
    assert seen == {"reads": reads}
    assert out.height > 0


def test_host_joins_compact_through_k2(frames, monkeypatch):
    """A host-path anti join and a hashed join's verified pairs are compacted
    by K2 (``engine/join.py`` calls it through its module references, which
    the chip's run swaps to keep each call)."""
    from polars_tpu_torch.engine import join as J
    from polars_tpu_torch.kernels.compact import compact_scatter

    calls = []

    def k2(cols, mask, offs, count):
        calls.append((mask.shape[0], len(cols), count))
        return compact_scatter(cols, mask, offs, count)

    monkeypatch.setattr(J, "compact_scatter", k2)
    left, right = _pick(frames, plt, "left"), _pick(frames, plt, "right")
    anti = left.lazy().join(right.lazy(), on=["k", "big"], how="anti").collect()
    inner = left.lazy().join(right.lazy(), on=["k", "big"]).collect()
    n_cols = sum(1 + (c.buffer.validity is not None) for c in left._columns)
    assert len(calls) == 2
    assert calls[0] == (left.height, n_cols, anti.height)  # the kept left rows, every column at once
    assert calls[1][1:] == (3, inner.height)  # the verified pairs: probe row, build row, matched


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
def test_hash_collisions_are_verified_away(frames, monkeypatch, how):
    """Every hashed key made to collide (``hash_column`` of the join module
    returns one word): each candidate pair is then verified on the key
    values, a probe row none of whose candidates verify keeps its one
    unmatched row, and the frame equals the join without collisions."""
    from polars_tpu_torch.engine import join as J

    def run():
        left = _pick(frames, plt, "left", ["k", "big", "lrow"]).lazy()
        right = _pick(frames, plt, "right", ["k", "big", "rrow"]).lazy()
        return left.join(right, on=["k", "big"], how=how).collect()

    want = run()
    monkeypatch.setattr(J, "hash_column", lambda values, validity, seed=0: torch.zeros_like(values, dtype=torch.int64))
    got = run()
    assert got.height == want.height > 0
    assert got.to_dict(as_series=False) == want.to_dict(as_series=False)


# ---------------------------------------------------------------------------
# frames: gather, drop, concat
# ---------------------------------------------------------------------------


def test_gather_drop_and_concat_match_polars_tpu(frames):
    lj, lt = _pick(frames, plj, "left"), _pick(frames, plt, "left")
    idx = [3, -1, 0, 0, 17]
    _assert_frames_match(lt.gather(idx), lj.gather(idx))
    _assert_frames_match(lt.gather(torch.tensor([5, 2, 2])), lj.gather(np.asarray([5, 2, 2])))
    _assert_frames_match(lt.drop("s", "lv"), lj.drop("s", "lv"))
    with pytest.raises(plt.ColumnNotFoundError):
        lt.drop("nope")
    cols = ["k", "s", "f", "b", "d"]
    want = plj.concat([_pick(frames, plj, side, cols) for side in ("left", "right")], how="vertical_relaxed")
    got = plt.concat([_pick(frames, plt, side, cols) for side in ("left", "right")], how="vertical_relaxed")
    _assert_frames_match(got, want)
    with pytest.raises(OutOfBoundsError):
        lt.gather([lt.height])


def test_join_where_and_join_asof_name_their_queue_item(frames):
    lt = _pick(frames, plt, "left")
    with pytest.raises(NotImplementedError, match="join_where and join_asof"):
        lt.lazy().join_where(lt.lazy(), plt.col("k") < plt.col("k"))
    with pytest.raises(NotImplementedError, match="join_where and join_asof"):
        lt.lazy().join_asof(lt.lazy(), on="d")


def test_join_dates_stay_dates(frames):
    """A date key and a date payload keep their type through a full join."""
    def plan(pl):
        return _pick(frames, pl, "left", ["d", "lrow"]).lazy().join(
            _pick(frames, pl, "right", ["d", "rrow"]).lazy(), on="d", how="full", coalesce=True).collect()

    want = plan(plj)
    assert want.schema["d"] == plj.Date and isinstance(want["d"].to_list()[0], dtm.date)
    _assert_frames_match(plan(plt), want)
