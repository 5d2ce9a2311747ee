"""The eager DataFrame and Series API, the math and cast expressions, the
statistical aggregations, wildcards, selectors and the ``name`` namespace
of ``polars_tpu_torch``, on the CPU (``device="cpu"``).

- ``test_reference_eager_cases`` runs every test function of eight test
  files of the JAX package (``REFERENCE_FILES``) with ``polars_tpu``
  rebound to the port. Every function passes but those of ``WAITING``,
  each with the ROADMAP queue item that brings what it needs, and each of
  those must still fail, so that the table cannot go stale.
- ``test_math_casts_aggs_differential`` runs frames with nulls, NaN, the
  infinities, the integer extremes and unsigned columns through both
  packages in a few wide selects and group-bys (dense and sorted). Where
  the reference is wrong (ROADMAP section 3), the port is held to a Python
  oracle and the test names the fault: its integer ``product`` goes
  through floats, its float ``product`` of inf and 0 is 0, its float to
  integer cast nulls a value whose truncation fits, and it ignores
  ``wrap_numerical``.
- ``test_stats_phase_plans`` runs the three plans of ``chip_smoke.py``'s
  ``stats`` phase at SF 0.003 through both packages and against the numpy
  oracle of ``testing/phases.py``.

Integers, keys, strings and null masks are equal; Float64 agrees to rtol
1e-9 and Float32 to one unit in its last place.
"""

from __future__ import annotations

import inspect
import math
import pathlib
import re
import types

import numpy as np
import pytest

import polars_tpu as plj
import polars_tpu_torch as plt
import polars_tpu_torch.selectors as cst
from polars_tpu import selectors as csj

ROOT = pathlib.Path(__file__).resolve().parent

REFERENCE_FILES = ["test_dataframe.py", "test_series.py", "test_lazyframe.py", "test_exprs.py",
                   "conformance/test_conf_arithmetic.py", "conformance/test_conf_cast2.py",
                   "conformance/test_conf_agg2.py", "conformance/test_conf_ops.py"]

# the test functions that wait for a later item of ROADMAP queue 1 ("not
# to port": ROADMAP's list of what the port leaves out)
_ITEM_1B = "1b (replace, horizontal ops and folds, int_range, search_sorted, index_of, shrink_dtype)"
_ITEM_2 = "2 (window, order and position expressions)"
_ITEM_3 = "3 (strings, categoricals, binary)"
_ITEM_4 = "4 (nested types, reshaping, generators, map functions, functions/eager and parity)"
_ITEM_5 = "5 (scans, IO and pandas/Arrow interchange)"
WAITING = {
    ("test_dataframe", "test_init_pandas"): _ITEM_5,
    ("test_dataframe", "test_init_arrow"): _ITEM_5,
    ("test_dataframe", "test_concat_diagonal"): _ITEM_4,
    ("test_dataframe", "test_to_numpy_pandas_dicts"): _ITEM_5,
    ("test_dataframe", "test_unpivot"): _ITEM_4,
    ("test_series", "test_cum_and_shift"): _ITEM_2,
    ("test_series", "test_str_namespace"): _ITEM_3,
    ("test_series", "test_to_frame_numpy_jax"): "not to port (to_jax gives a JAX array)",
    ("test_series", "test_rank_arg_sort"): _ITEM_2,
    ("test_lazyframe", "test_profile"): "7 (LazyFrame.profile, the engine's node timer)",
    ("test_lazyframe", "test_map_batches"): _ITEM_4,
    ("test_lazyframe", "test_explain_contains_pushdown"): _ITEM_5,
    ("test_exprs", "test_fill_null_strategies"): _ITEM_2,
    ("test_exprs", "test_horizontal"): _ITEM_1B,
    ("test_exprs", "test_cum_ops"): _ITEM_2,
    ("test_exprs", "test_shift_diff"): _ITEM_2,
    ("test_exprs", "test_rank"): _ITEM_2,
    ("test_exprs", "test_unique_flags"): _ITEM_2,
    ("test_exprs", "test_expr_sort_reverse"): _ITEM_2,
    ("test_exprs", "test_expr_sort_by"): _ITEM_2,
    ("test_exprs", "test_arg_sort_gather"): _ITEM_2,
    ("test_exprs", "test_replace"): _ITEM_1B,
    ("test_exprs", "test_replace_strict"): _ITEM_1B,
    ("test_exprs", "test_map_batches"): _ITEM_4,
    ("test_exprs", "test_map_elements"): _ITEM_4,
    ("test_exprs", "test_int_range"): _ITEM_1B,
    ("test_exprs", "test_concat_str"): _ITEM_3,
    ("test_exprs", "test_fold"): _ITEM_1B,
    ("test_exprs", "test_filter_in_agg"): _ITEM_2,
    ("test_exprs", "test_drop_nulls_expr"): _ITEM_2,
    ("test_exprs", "test_arg_where_lowers_to_fused_filter"): _ITEM_4,
    ("test_exprs", "test_extend_constant_no_value_readback"): _ITEM_4,
    ("test_exprs", "test_cumulative_eval_traced_scans"): _ITEM_2,
    ("test_exprs", "test_cumulative_eval_host_fallback_matches"): _ITEM_2,
    ("test_exprs", "test_strict_exact_flags_honored"): _ITEM_3,
    ("test_conf_cast2", "test_categorical_to_string_and_back"): _ITEM_3,
    ("test_conf_cast2", "test_cat_to_physical_codes"): _ITEM_3,
    ("test_conf_cast2", "test_enum_cast_unknown_value"): _ITEM_3,
    ("test_conf_cast2", "test_list_inner_cast"): _ITEM_4,
    ("test_conf_agg2", "test_horizontal_sum_ignores_nulls"): _ITEM_1B,
    ("test_conf_agg2", "test_horizontal_min_max"): _ITEM_1B,
    ("test_conf_agg2", "test_horizontal_mean_with_nulls"): _ITEM_1B,
    ("test_conf_agg2", "test_any_all_horizontal"): _ITEM_1B,
    ("test_conf_agg2", "test_fold_with_accumulator"): _ITEM_1B,
    ("test_conf_agg2", "test_reduce"): _ITEM_1B,
    ("test_conf_agg2", "test_implode_in_group_by"): _ITEM_4,
    ("test_conf_agg2", "test_implode_select_context"): _ITEM_4,
    ("test_conf_agg2", "test_arr_sum_min_max"): _ITEM_4,
    ("test_conf_agg2", "test_arr_get_and_contains"): _ITEM_4,
    ("test_conf_agg2", "test_arr_to_list_dtype"): _ITEM_4,
    ("test_conf_agg2", "test_arr_join"): _ITEM_4,
    ("test_conf_agg2", "test_binary_contains_starts_ends"): _ITEM_3,
    ("test_conf_agg2", "test_binary_encode_decode"): _ITEM_3,
    ("test_conf_agg2", "test_binary_size"): _ITEM_3,
    ("test_conf_agg2", "test_struct_with_fields"): _ITEM_4,
    ("test_conf_agg2", "test_struct_unnest_and_schema"): _ITEM_4,
    ("test_conf_agg2", "test_struct_json_encode"): _ITEM_4,
    ("test_conf_agg2", "test_struct_field_arithmetic"): _ITEM_4,
    ("test_conf_agg2", "test_agg_filtered"): _ITEM_2,
    ("test_conf_ops", "test_fill_null_strategies"): _ITEM_2,
    ("test_conf_ops", "test_fill_null_limit"): _ITEM_2,
    ("test_conf_ops", "test_cum_ops"): _ITEM_2,
    ("test_conf_ops", "test_cum_sum_reverse"): _ITEM_2,
    ("test_conf_ops", "test_is_duplicated_is_unique"): _ITEM_2,
    ("test_conf_ops", "test_is_first_last_distinct"): _ITEM_2,
    ("test_conf_ops", "test_explode_basics"): _ITEM_4,
    ("test_conf_ops", "test_explode_multiple_columns"): _ITEM_4,
    ("test_conf_ops", "test_explode_mismatched_lengths_raises"): _ITEM_4,
    ("test_conf_ops", "test_gather_expr"): _ITEM_2,
    ("test_conf_ops", "test_shift"): _ITEM_2,
    ("test_conf_ops", "test_diff_null_behavior"): _ITEM_2,
    ("test_conf_ops", "test_interpolate_linear"): _ITEM_2,
    ("test_conf_ops", "test_horizontal_aggs"): _ITEM_1B,
    ("test_conf_ops", "test_fold"): _ITEM_1B,
    ("test_conf_ops", "test_concat_str"): _ITEM_3,
    ("test_conf_ops", "test_replace"): _ITEM_1B,
    ("test_conf_ops", "test_replace_strict"): _ITEM_1B,
    ("test_conf_ops", "test_unpivot"): _ITEM_4,
    ("test_conf_ops", "test_pivot"): _ITEM_4,
    ("test_conf_ops", "test_transpose"): _ITEM_4,
    ("test_conf_ops", "test_search_sorted"): _ITEM_1B,
    ("test_conf_ops", "test_index_of"): _ITEM_1B,
    ("test_conf_ops", "test_extend_constant"): _ITEM_4,
    ("test_conf_ops", "test_repeat_by"): _ITEM_4,
    ("test_conf_ops", "test_mode_multi_value"): _ITEM_4,
    ("test_conf_ops", "test_interpolate_methods"): _ITEM_2,
    ("test_conf_ops", "test_explode_nested_inners"): _ITEM_4,
    ("test_conf_ops", "test_arg_sort_by"): _ITEM_2,
    ("test_conf_ops", "test_shrink_and_cumulative_eval"): _ITEM_1B + " and " + _ITEM_2,
    ("test_conf_ops", "test_from_epoch_eager"): _ITEM_4,
}


@pytest.fixture(autouse=True)
def _cpu():
    prev = plt.set_default_device("cpu")
    yield
    plt.set_default_device(prev)


# -- the JAX package's own test files, with the port as ``pl`` ----------------------------------


def _load_reference_tests(rel: str) -> types.ModuleType:
    """A test file of the JAX package with its ``polars_tpu`` imports
    rebound to the port, executed as a module of its own."""
    path = ROOT / rel
    src = re.sub(r"^(\s*)(import|from) polars_tpu\b(?!_torch)", r"\1\2 polars_tpu_torch", path.read_text(),
                 flags=re.M)
    mod = types.ModuleType(f"port_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)  # noqa: S102
    return mod


def _df_basic():
    """``tests/conftest.py``'s ``df_basic``, built by the port."""
    return plt.DataFrame({"a": [1, 2, 3, 4, 5], "b": [1.5, 2.5, None, 4.5, 5.5], "s": ["x", "y", "x", "z", "y"],
                          "flag": [True, False, True, False, None]})


def _run_reference_function(mod: types.ModuleType, fn, tmp_path: pathlib.Path) -> None:
    """``fn`` over each case of its ``parametrize`` marker, its fixtures
    made as pytest would (the file's own, ``df_basic``, ``rng``,
    ``tmp_path``, ``monkeypatch``)."""
    cases = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            names = mark.args[0]
            names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
            cases = [dict(zip(names, v if len(names) > 1 else (v,))) for v in mark.args[1]]
    for case in cases:
        kwargs = dict(case)
        mp = pytest.MonkeyPatch()
        try:
            for p in inspect.signature(fn).parameters:
                if p in kwargs:
                    continue
                if p == "df_basic":
                    kwargs[p] = _df_basic()
                elif p == "rng":
                    kwargs[p] = np.random.default_rng(0)
                elif p == "tmp_path":
                    kwargs[p] = tmp_path
                elif p == "monkeypatch":
                    kwargs[p] = mp
                else:
                    kwargs[p] = getattr(mod, p)._get_wrapped_function()()
            fn(**kwargs)
        finally:
            mp.undo()


def test_reference_eager_cases(tmp_path):
    passed, failed, stale = [], [], []
    seen = set()
    for rel in REFERENCE_FILES:
        mod = _load_reference_tests(rel)
        stem = pathlib.Path(rel).stem
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or not callable(fn):
                continue
            key = (stem, name)
            seen.add(key)
            try:
                _run_reference_function(mod, fn, tmp_path)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 (pytest.raises fails with a BaseException)
                if key not in WAITING:
                    failed.append(f"{stem}::{name}: {type(e).__name__}: {str(e)[:300]}")
                continue
            if key in WAITING:
                stale.append(f"{stem}::{name} passes but WAITING says it waits for item {WAITING[key]}")
            else:
                passed.append(key)
    assert not failed, "\n".join(failed)
    assert not stale, "\n".join(stale)
    assert not set(WAITING) - seen, f"WAITING names functions the files lack: {sorted(set(WAITING) - seen)}"
    assert len(passed) + len(WAITING) == 236 and len(passed) >= 120, (len(passed), len(WAITING))


# -- the differential against polars_tpu ----------------------------------------------------------


def _assert_frames_match(got, want, *, rtol=1e-9, label=""):
    """Schemas equal; integers, strings, Booleans and null masks equal;
    Float64 to ``rtol`` and Float32 to one unit in its last place (the two
    libraries' f32 functions may round apart), subnormals as zero (NaN
    equals NaN)."""
    gs = [(n, repr(d)) for n, d in got.schema.items()]
    ws = [(n, repr(d)) for n, d in want.schema.items()]
    assert gs == ws, f"{label}: {gs} != {ws}"
    g, w = got.to_dict(as_series=False), want.to_dict(as_series=False)
    for name, wcol in w.items():
        if isinstance(want.schema[name], plj.datatypes.FloatType):
            assert [v is None for v in g[name]] == [v is None for v in wcol], f"{label} {name}"
            gv = np.asarray([np.nan if v is None else v for v in g[name]], np.float64)
            wv = np.asarray([np.nan if v is None else v for v in wcol], np.float64)
            f32 = isinstance(want.schema[name], plj.Float32)
            # XLA on the CPU flushes subnormal results to zero: below the
            # smallest normal number, 0 and the subnormal agree
            tiny = float(np.finfo(np.float32 if f32 else np.float64).tiny)
            np.testing.assert_allclose(gv, wv, rtol=2.0**-23 if f32 else rtol, atol=tiny, equal_nan=True,
                                       err_msg=f"{label} {name}")
        else:
            assert g[name] == wcol, f"{label} {name}: {g[name]} != {wcol}"


_I64 = (-(2**63), 2**63 - 1)
_INTS = {"i64": ("Int64", _I64), "i32": ("Int32", (-(2**31), 2**31 - 1)), "i16": ("Int16", (-(2**15), 2**15 - 1)),
         "i8": ("Int8", (-128, 127)), "u8": ("UInt8", (0, 255)), "u16": ("UInt16", (0, 2**16 - 1)),
         "u32": ("UInt32", (0, 2**32 - 1)), "u64": ("UInt64", (0, 2**64 - 1))}
_STRINGS = ["12", "-3", "7", "300", "1.5", "x", "inf", "true", "0", "-129", "255", "65536", "false", "-0.25"]


def _data(seed: int, n: int = 64) -> tuple[dict, dict]:
    """Columns of Python values (None for null) and their dtype names: a
    dense string key, a high-cardinality integer key, every integer type
    with its extremes, Float64 and Float32 with NaN and the infinities, a
    Boolean and numeric text, each with about 15% nulls."""
    rng = np.random.default_rng(seed)

    def nulls(values):
        return [None if z else v for z, v in zip(rng.random(n) < 0.15, values)]

    data = {"g": [str(x) for x in np.asarray(list("abcde"))[rng.integers(0, 5, n)]],
            "h": rng.integers(0, 40, n).tolist()}
    dtypes = {"g": "String", "h": "Int64"}
    for name, (dtype, (lo, hi)) in _INTS.items():
        span = min(hi, 1000)
        vals = rng.integers(max(lo, -1000), span + 1, n).tolist()
        vals[:3] = [lo, hi, 0]
        data[name], dtypes[name] = nulls(rng.permutation(np.asarray(vals, object)).tolist()), dtype
    f = (rng.normal(size=n) * 100).round(3).tolist()
    f[:8] = [math.nan, math.inf, -math.inf, 0.0, -0.0, 1e300, 2.5, -3.5]
    data["f64"], dtypes["f64"] = nulls(rng.permutation(np.asarray(f, object)).tolist()), "Float64"
    f32 = (rng.normal(size=n) * 10).astype(np.float32).astype(np.float64).tolist()
    f32[:3] = [math.nan, math.inf, 1e30]
    data["f32"], dtypes["f32"] = nulls(rng.permutation(np.asarray(f32, object)).tolist()), "Float32"
    data["b"], dtypes["b"] = nulls((rng.random(n) < 0.5).tolist()), "Boolean"
    data["s"], dtypes["s"] = nulls(np.asarray(_STRINGS, object)[rng.integers(0, len(_STRINGS), n)].tolist()), "String"
    return data, dtypes


def _frames(seed: int):
    data, dtypes = _data(seed)
    return (plj.DataFrame(data, schema={k: getattr(plj, d) for k, d in dtypes.items()}),
            plt.DataFrame(data, schema={k: getattr(plt, d) for k, d in dtypes.items()}))


_FLOAT_FNS = ["sqrt", "cbrt", "exp", "log10", "log1p", "sin", "cos", "tan", "cot", "arcsin", "arccos", "arctan",
              "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "degrees", "radians"]
_TARGETS = ["Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16", "UInt32", "UInt64", "Float32", "Float64", "Boolean",
            "String"]
_CAST_SOURCES = [*_INTS, "f64", "f32", "b", "s"]


def _math_exprs(pl, cs) -> list:
    """Every math function over every numeric column, through selectors,
    dtype columns and the ``name`` namespace."""
    c = pl.col
    wide = cs.numeric() - cs.by_dtype(pl.Float32)  # the f32 functions: against numpy (_F32_NUMPY)
    out = [getattr(wide, fn)().name.suffix(f"_{fn}") for fn in _FLOAT_FNS]
    out += [cs.numeric().abs().name.suffix("_abs"), cs.numeric().sign().name.suffix("_sign"),
            wide.log(2).name.suffix("_log2"), cs.numeric().floor().name.suffix("_floor"),
            cs.numeric().ceil().name.suffix("_ceil"), cs.float().round(0).name.suffix("_r0"),
            pl.col(pl.Float64, pl.Float32).round(2).name.prefix("r2_"),
            (-cs.signed_integer()).name.suffix("_neg"), (-cs.float()).name.to_uppercase(),
            cs.signed_integer().clip(-100, 100).name.suffix("_clip"), cs.unsigned_integer().clip(3, 100).name.map(
                lambda n: n + "_uclip"), cs.float().clip(c("i8").fill_null(0), 50.0).name.suffix("_fclip"),
            (cs.numeric() ** 2).name.suffix("_sq"), (c("u8") ** 3).alias("u8_cube"), (c("f64") ** 0.5).alias("f_half"),
            (2 ** c("i8").clip(0, 6)).alias("two_pow"), pl.arctan2("f64", "f32").alias("atan2"),
            pl.arctan2d(c("i64"), "i16").alias("atan2_int"), pl.all().exclude("g", "s", "b").null_count().name.suffix("_n"),
            c("i8", "u16").name.keep()]
    return out


_F32_NUMPY = {"sqrt": np.sqrt, "cbrt": np.cbrt, "exp": np.exp, "log10": np.log10, "log1p": np.log1p, "sin": np.sin,
              "cos": np.cos, "tan": np.tan, "cot": lambda x: 1.0 / np.tan(x), "arcsin": np.arcsin,
              "arccos": np.arccos, "arctan": np.arctan, "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
              "arcsinh": np.arcsinh, "arccosh": np.arccosh, "arctanh": np.arctanh, "degrees": np.degrees,
              "radians": np.radians}


def _check_f32_functions(lt) -> None:
    """The float functions of a Float32 column stay Float32 and agree with
    numpy's f64 answer rounded to f32 within two units in the last place
    (XLA's f32 functions, which the JAX package runs, are approximations a
    few units apart)."""
    x = np.asarray([np.nan if v is None else v for v in lt["f32"].to_list()], np.float64)
    got = lt.select([getattr(plt.col("f32"), fn)().alias(fn) for fn in _F32_NUMPY])
    with np.errstate(all="ignore"):
        for fn, ref in _F32_NUMPY.items():
            assert got[fn].dtype == plt.Float32, fn
            want = ref(x).astype(np.float32).astype(np.float64)
            g = np.asarray([np.nan if v is None else v for v in got[fn].to_list()], np.float64)
            assert np.array_equal(np.isnan(g), np.isnan(want)), fn
            np.testing.assert_allclose(g, want, rtol=2.0**-22, atol=float(np.finfo(np.float32).tiny),
                                       equal_nan=True, err_msg=f"f32 {fn}")


def _cast_exprs(pl, *, text: bool) -> list:
    """Every cast of the sources to String (``text``) or to the other
    targets."""
    return [pl.col(src).cast(getattr(pl, tgt), strict=False).alias(f"{src}_{tgt}")
            for src in _CAST_SOURCES for tgt in _TARGETS if (tgt == "String") == text]


def _text_oracle(values: list) -> list:
    """The JAX package's text of each value (one XLA program per cast to
    String there; the rules are these): ``true``/``false``, Python's
    ``repr`` of a float, the digits of an integer."""
    def text(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        return repr(float(v)) if isinstance(v, float) else str(v)

    return [None if v is None else text(v) for v in values]


def _agg_exprs(pl, cs) -> list:
    c = pl.col
    out = [cs.numeric().exclude("h").std().name.suffix("_std"), cs.numeric().exclude("h").var(ddof=0).name.suffix("_v0"),
           cs.numeric().exclude("h").median().name.suffix("_med"), c("b").null_count().alias("b_nulls"),
           c("b").any().alias("any"), c("b").all().alias("all"), c("b").any(ignore_nulls=False).alias("any_k"),
           c("b").all(ignore_nulls=False).alias("all_k"), cs.numeric().exclude("h").arg_min().name.suffix("_amin"),
           cs.numeric().exclude("h").arg_max().name.suffix("_amax"), pl.len()]
    out += [c("f64", "i32", "u64").quantile(0.3, interp).name.suffix(f"_q_{interp}")
            for interp in ("nearest", "lower", "higher", "midpoint", "linear")]
    return out


def _float_to_int_oracle(values: list, tgt: str) -> list:
    """Polars' cast of floats to an integer type: truncation toward zero;
    NaN, the infinities and what lies out of range after truncation are
    null."""
    lo, hi = _INTS[[k for k, (d, _) in _INTS.items() if d == tgt][0]][1]
    out = []
    for v in values:
        t = None if v is None or not math.isfinite(v) else math.trunc(v)
        out.append(t if t is not None and lo <= t <= hi else None)
    return out


def _product_oracle(values: list):
    """Python's exact product: an integer product wraps to Int64 as Polars'
    does; a float product follows IEEE (inf * 0 is NaN)."""
    vals = [v for v in values if v is not None]
    if vals and all(isinstance(v, int) for v in vals):
        p = math.prod(vals) % 2**64
        return p - 2**64 if p >= 2**63 else p
    return math.prod(vals) if vals else 1


def test_math_casts_aggs_differential():
    lj, lt = _frames(11)
    # math, with wildcards, selectors and the name namespace: one select each
    _assert_frames_match(lt.select(_math_exprs(plt, cst)), lj.select(_math_exprs(plj, csj)), label="math")
    _check_f32_functions(lt)

    # every cast pair, not strict; a float to an integer follows Polars
    texts = lt.select(_cast_exprs(plt, text=True))
    for src in _CAST_SOURCES:
        assert texts[f"{src}_String"].to_list() == _text_oracle(lt[src].to_list()), src
    assert lj.select(plj.col("b", "f64", "u64").cast(plj.String).name.suffix("_s")).to_dict(as_series=False) == {
        f"{c}_s": _text_oracle(lt[c].to_list()) for c in ("b", "f64", "u64")}
    got, want = lt.select(_cast_exprs(plt, text=False)), lj.select(_cast_exprs(plj, text=False))
    float_int = [f"{s}_{t}" for s in ("f64", "f32") for t in _TARGETS if t.startswith(("Int", "UInt"))]
    _assert_frames_match(got.drop(float_int), want.drop(float_int), label="casts")
    for name in float_int:
        src, tgt = name.split("_")
        assert got[name].to_list() == _float_to_int_oracle(lt[src].to_list(), tgt), name
    # the reference nulls what truncates into range (0.5 to UInt8, 127.5 to Int8)
    probe = [0.5, -0.5, 127.5]
    assert plj.Series(probe).cast(plj.Int8, strict=False).to_list() == [0, 0, None]
    assert plt.Series(probe).cast(plt.Int8, strict=False).to_list() == [0, 0, 127]
    assert plt.Series([-0.5]).cast(plt.UInt8, strict=False).to_list() == [0]
    # wrap_numerical wraps as Polars does; the reference ignores it
    assert plj.Series([300, -129]).cast(plj.Int8, strict=False, wrap_numerical=True).to_list() == [None, None]
    assert plt.Series([300, -129, 2**40 + 5]).cast(plt.Int8, wrap_numerical=True).to_list() == [44, 127, 5]
    assert plt.Series([2**64 - 1], dtype=plt.UInt64).cast(plt.Int16, wrap_numerical=True).to_list() == [-1]

    # strict casts raise where a value does not fit, each at the segment's
    # one count read; not strict, the value is null
    from polars_tpu_torch.engine import executors

    reads = []
    read = executors._read_count

    def counted(count, flags):
        reads.append(len(flags))
        return read(count, flags)

    executors._read_count = counted
    try:
        for bad in (plt.col("i64").cast(plt.Int8), plt.col("s").cast(plt.Int64), plt.col("f64").cast(plt.Int32),
                    plt.col("u64").cast(plt.Int64)):
            reads.clear()
            with pytest.raises(plt.InvalidOperationError, match="strict cast"):
                lt.select(bad)
            assert len(reads) == 1
        reads.clear()
        out = lt.select(plt.col("i64").cast(plt.Int8, strict=False))
        assert len(reads) == 1
        assert out.null_count().item() > lt["i64"].null_count()
    finally:
        executors._read_count = read
    with pytest.raises(Exception):
        lj.select(plj.col("i64").cast(plj.Int8)).to_dicts()

    # the statistical aggregations: one group, a dense group-by (string key,
    # capacity <= 1024) and a sorted one (an integer key of 40 values)
    _assert_frames_match(lt.select(_agg_exprs(plt, cst)), lj.select(_agg_exprs(plj, csj)), label="select aggs")
    for key in ("g", "h"):
        _assert_frames_match(lt.group_by(key).agg(_agg_exprs(plt, cst)).sort(key),
                             lj.group_by(key).agg(_agg_exprs(plj, csj)).sort(key), label=f"group_by {key}")

    # product follows Polars: exact integer products that wrap, IEEE floats
    for key in ("g", "h"):
        got = lt.group_by(key, maintain_order=True).agg(plt.col("i8", "u16", "i64", "f64", "f32").product())
        groups = lt.group_by(key, maintain_order=True).agg(plt.col("i8", "u16", "i64", "f64", "f32").first())[key]
        for name in ("i8", "u16", "i64", "f64", "f32"):
            col = lt[name].to_list()
            want = [_product_oracle([v for k, v in zip(lt[key].to_list(), col) if k == g]) for g in groups]
            assert got[name].dtype == (plt.Int64 if not name.startswith("f") else lt[name].dtype), name
            for gv, wv in zip(got[name].to_list(), want):
                if isinstance(wv, float) and (math.isnan(wv) or math.isinf(wv)):
                    assert (math.isnan(gv) and math.isnan(wv)) or gv == wv, (name, gv, wv)
                elif name == "f32":
                    assert gv == pytest.approx(wv, rel=1e-5), (name, gv, wv)
                else:
                    assert gv == pytest.approx(wv, rel=1e-9) if isinstance(wv, float) else gv == wv, (name, gv, wv)
    # the reference's integer product goes through exp(sum(log|x|)) and
    # rounds; it saturates on overflow; its float product of inf and 0 is 0
    for values, exact in (([99991, 99989, 99971, 7], 6996570475279903),
                          ([3000000007, 3000000019], 9000000078000000133), ([2**62, 4], 0)):
        assert plt.Series(values).product() == exact == _product_oracle(values)
        assert plj.Series(values).product() != exact
    assert math.isnan(plt.Series([math.inf, 0.0]).product())
    assert plj.Series([math.inf, 0.0]).product() == 0.0

    # the two-pass variance keeps its digits where a sum of squares would not
    assert plt.Series([1e9 + 1, 1e9 + 2, 1e9 + 3]).var() == 1.0 == plj.Series([1e9 + 1, 1e9 + 2, 1e9 + 3]).var()


def test_stats_phase_plans():
    from polars_tpu_torch.testing import pdsh
    from polars_tpu_torch.testing import phases as P

    scale = 0.003
    raw = pdsh.generate_pdsh(scale, seed=7, tables=("lineitem",))["lineitem"]
    line = {c: raw[c] for c in P.STATS_COLUMNS}
    lj, lt = plj.DataFrame(line), plt.DataFrame(line)
    want = P.stats_oracle(line, scale)
    plans_t, plans_j = P.stats_plans(plt, lt, scale), P.stats_plans(plj, lj, scale)

    flags = P.stats_flags(plt, lt)  # the eager query
    _assert_frames_match(flags, P.stats_flags(plj, lj), label="stats.flags")
    _assert_frames_match(plans_t["flags"].collect(), flags, label="stats.flags lazy")
    supp = plans_t["supp"].collect()
    _assert_frames_match(supp, plans_j["supp"].collect(), label="stats.supp")
    casts = plans_t["casts"].collect()
    _assert_frames_match(casts, plans_j["casts"].collect(), label="stats.casts")
    nulls = plans_t["cast_frame"].collect().null_count()
    _assert_frames_match(nulls, plans_j["cast_frame"].collect().null_count(), label="stats.casts nulls")

    for got, oracle in ((flags, want["flags"]), (supp, want["supp"])):
        for name, w in oracle.items():
            g = got[name].to_list()
            if isinstance(w, np.ndarray) and w.dtype.kind == "f":
                np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=1e-9, atol=0, err_msg=name)
            else:
                assert g == list(np.asarray(w).tolist()), name
    row = casts.to_dicts()[0]
    assert {k: v for k, v in row.items() if k != "net"} == {k: v for k, v in want["casts"].items() if k != "net"}
    assert row["net"] == pytest.approx(want["casts"]["net"], rel=1e-9)
    assert nulls.to_dicts()[0] == want["cast_nulls"] and want["cast_nulls"]["key_i32"] > 0
    with pytest.raises(plt.InvalidOperationError, match="strict cast"):
        plans_t["strict"].collect()
