"""The eager DataFrame and Series API, the math and cast expressions, the
statistical aggregations, wildcards, selectors and the ``name`` namespace
of ``polars_tpu_torch``, on the CPU (``device="cpu"``).

- ``test_reference_eager_cases`` runs every test function of sixteen test
  files of the JAX package (``REFERENCE_FILES``) with ``polars_tpu``
  rebound to the port. Every function passes but those of ``WAITING``,
  each with the ROADMAP queue item that brings what it needs, and each of
  those must still fail, so that the table cannot go stale. It then runs
  the List, Array and Struct checks (``_check_nested_differential``,
  ``_check_content_keys_differential``: nested values by their content;
  ``_check_item_4c_rest``; ``_check_nestkeys_phase_plans``).
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
- The other ``_check_*`` functions of this file run in a test of their
  topic in another port test file (windows, sorts, recoding, strings and
  the leftovers in ``test_torch_exprs.py``, rolling in
  ``test_torch_join_range_asof.py``, dynamic group-bys in
  ``test_torch_temporal.py``, empty group-bys in ``test_torch_q3q4.py``),
  each once, with ``port_on_cpu``.

Integers, keys, strings and null masks are equal; Float64 agrees to rtol
1e-9 and Float32 to one unit in its last place.
"""

from __future__ import annotations

import contextlib
import datetime as dtm
import inspect
import itertools
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
                   "conformance/test_conf_agg2.py", "conformance/test_conf_ops.py", "test_window.py",
                   "conformance/test_conf_window.py", "test_rolling_window.py", "test_dynamic.py", "test_strings.py",
                   "conformance/test_conf_strings2.py", "conformance/test_conf_enum.py", "test_highcard_strings.py",
                   "test_list.py", "test_list_namespace.py", "test_struct.py",
                   "conformance/test_conf_concat_explode.py", "test_pivot.py", "test_parity_batch.py",
                   "test_api_tail.py", "test_expr_tail.py", "conformance/test_conf_ops2.py"]

# the scan and IO files (ROADMAP item 5), run by
# ``test_torch_q1.py::test_q1_on_frames_built_by_the_port``
IO_REFERENCE_FILES = ["test_io.py", "test_io_ext.py", "test_parquet_index.py", "test_hive_scan.py",
                      "conformance/test_conf_csv.py", "test_hashed_strings.py"]

# the test functions that wait for a later item of ROADMAP queue 1 ("not
# to port": ROADMAP's list of what the port leaves out)
_ITEM_6 = "6 (streaming: collect(engine='streaming'), sinks)"
_ITEM_7 = "7 (SQL, serialization, Expr.meta, profiling, extension types)"
_ITEM_5B = "5b (the hashed strategy for high-cardinality strings: utils/hashstore.py)"
WAITING = {
    ("test_series", "test_to_frame_numpy_jax"): "not to port (to_jax gives a JAX array)",
    ("test_lazyframe", "test_profile"): "7 (LazyFrame.profile, the engine's node timer)",
    ("test_list", "test_explode_streams_through_chain"): _ITEM_6,
    ("test_parity_batch", "test_frame_sql"): _ITEM_7,
    ("test_parity_batch", "test_align_frames_and_misc"): _ITEM_7 + ": pl.sql_expr",
    ("test_parity_batch", "test_partitioned_sink"): _ITEM_6,
    ("test_parity_batch", "test_extension_types"): _ITEM_7,
    ("test_api_tail", "test_series_describe_dummies_sql"): _ITEM_7 + ": Series.sql",
    ("test_api_tail", "test_frame_serialize_roundtrip"): _ITEM_7,
    ("test_api_tail", "test_lazy_sink_batches"): _ITEM_6,
    ("test_expr_tail", "test_expr_serialize_roundtrip"): _ITEM_7,
    ("test_expr_tail", "test_meta_tail"): _ITEM_7,
    ("test_io", "test_sink_parquet"): _ITEM_6,
    ("test_io", "test_write_parquet_partition_by"): _ITEM_6 + ": write_parquet(partition_by=), io/partition.py",
    ("test_hive_scan", "test_hive_pruning_streaming_engine"): _ITEM_6,
    ("test_hive_scan", "test_multi_file_plain_list_matches_single"): _ITEM_6 + ": its collect(engine='streaming')",
    **{("test_hashed_strings", name): _ITEM_5B for name in (
        "test_ingest_is_hashed_no_dictionary", "test_groupby_and_key_materialization_match_pandas",
        "test_equality_filter_and_isnull", "test_join_hashed_both_sides_and_vs_dictionary",
        "test_order_ops_densify_correctly", "test_concat_unions_payloads", "test_collision_detected_not_silent",
        "test_write_roundtrip_materializes", "test_auto_threshold_respects_cardinality",
        "test_filter_literal_collision_backstop", "test_filter_literal_verify_clean_path")},
    ("test_hashed_strings", "test_distinct_and_streaming"): _ITEM_5B + " and " + _ITEM_6,
    ("test_hashed_strings", "test_pending_scopes_are_thread_local"): _ITEM_6 + ": engine/pending.py",
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
    mod._module_fixtures = {}  # the module-scoped fixtures made so far
    exec(compile(src, str(path), "exec"), mod.__dict__)  # noqa: S102
    return mod


def _df_basic():
    """``tests/conftest.py``'s ``df_basic``, built by the port."""
    return plt.DataFrame({"a": [1, 2, 3, 4, 5], "b": [1.5, 2.5, None, 4.5, 5.5], "s": ["x", "y", "x", "z", "y"],
                          "flag": [True, False, True, False, None]})


class _TmpPathFactory:
    """``tmp_path_factory``: numbered directories under one base."""

    def __init__(self, base: pathlib.Path) -> None:
        self.base = base

    def mktemp(self, name: str, numbered: bool = True) -> pathlib.Path:
        path = self.base / name
        i = 0
        while numbered and path.exists():
            i += 1
            path = self.base / f"{name}{i}"
        path.mkdir(parents=True)
        return path


def _run_reference_function(mod: types.ModuleType, fn, tmp_path: pathlib.Path) -> None:
    """``fn`` over each case of its ``parametrize`` marker, its fixtures
    made as pytest would (the file's own, once per module where they are
    module-scoped, ``df_basic``, ``rng``, ``tmp_path``,
    ``tmp_path_factory``, ``monkeypatch``)."""
    cases = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            names = mark.args[0]
            names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
            cases = [dict(zip(names, v if len(names) > 1 else (v,))) for v in mark.args[1]]
    module_fixtures = mod._module_fixtures
    for case in cases:
        kwargs = dict(case)
        mp = pytest.MonkeyPatch()
        builtin = {"tmp_path": lambda: tmp_path, "monkeypatch": lambda: mp,
                   "tmp_path_factory": lambda: _TmpPathFactory(tmp_path / "factory"),
                   "df_basic": _df_basic, "rng": lambda: np.random.default_rng(0)}

        def make(p: str):
            if p in builtin:
                return builtin[p]()
            fixture = getattr(mod, p)  # the file's own fixture, given the fixtures it asks for
            module_scoped = fixture._fixture_function_marker.scope == "module"
            if module_scoped and p in module_fixtures:
                return module_fixtures[p]
            wrapped = fixture._get_wrapped_function()
            got = wrapped(**{q: make(q) for q in inspect.signature(wrapped).parameters})
            if module_scoped:
                module_fixtures[p] = got
            return got

        try:
            for p in inspect.signature(fn).parameters:
                if p not in kwargs:
                    kwargs[p] = make(p)
            fn(**kwargs)
        finally:
            mp.undo()


def _raiser(error: Exception):
    def fails():
        raise error

    return fails


def run_reference_files(files: list[str], tmp_path: pathlib.Path) -> list[tuple[str, str]]:
    """Every test function of ``files`` with the port as ``pl``: each
    passes but those of ``WAITING``, each of which must still fail (so that
    the table cannot go stale). Returns the (file, function) keys that
    passed."""
    passed, failed, stale = [], [], []
    seen = set()
    for rel in files:
        stem = pathlib.Path(rel).stem
        try:
            mod = _load_reference_tests(rel)
        except ImportError as e:  # a module of a later item: each function of the file fails
            import ast

            mod = types.ModuleType(f"port_{stem}")
            for node in ast.parse((ROOT / rel).read_text()).body:
                if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
                    setattr(mod, node.name, _raiser(e))
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or not callable(fn):
                continue
            key = (stem, name)
            seen.add(key)
            own = tmp_path / stem / name  # each function's own tmp_path, as pytest gives it
            own.mkdir(parents=True)
            try:
                _run_reference_function(mod, fn, own)
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
    stems = {pathlib.Path(rel).stem for rel in files}
    missing = {k for k in WAITING if k[0] in stems} - seen
    assert not failed, "\n".join(failed)
    assert not stale, "\n".join(stale)
    assert not missing, f"WAITING names functions the files lack: {sorted(missing)}"
    return passed


def test_reference_eager_cases(tmp_path):
    passed = run_reference_files(REFERENCE_FILES, tmp_path)
    stems = {pathlib.Path(rel).stem for rel in REFERENCE_FILES}
    waiting = [k for k in WAITING if k[0] in stems]
    assert len(passed) + len(waiting) == 520 and len(passed) >= 508, (len(passed), len(waiting))
    _check_refusal_table()
    _release_compiled_programs()
    _check_nested_differential()
    _check_content_keys_differential()
    _check_item_4c_rest()
    _check_nestkeys_phase_plans()


def _reference_names() -> dict[str, set[str]]:
    """The public names of the JAX package's ``DataFrame``, ``LazyFrame``,
    ``Expr`` and ``Series`` (their class bodies, and ``Series.x = ...``
    after it) and of its package (its module-level imports and
    assignments), read with ``ast`` (nothing of it runs)."""
    import ast

    pkg = ROOT.parent / "polars_tpu"

    def module_level(tree) -> list:
        out, todo = [], list(tree.body)
        while todo:
            n = todo.pop()
            if isinstance(n, (ast.Try, ast.If)):
                todo += n.body + getattr(n, "orelse", []) + [s for h in getattr(n, "handlers", []) for s in h.body]
            else:
                out.append(n)
        return out

    names: dict[str, set[str]] = {}
    for rel, cls in (("core/frame.py", "DataFrame"), ("lazyframe.py", "LazyFrame"), ("expr/expr.py", "Expr"),
                     ("core/series.py", "Series")):
        tree = ast.parse((pkg / rel).read_text())
        got = set()
        for n in module_level(tree):
            if isinstance(n, ast.ClassDef) and n.name == cls:
                got |= {b.name for b in n.body if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
            if isinstance(n, ast.Assign):
                got |= {t.attr for t in n.targets if isinstance(t, ast.Attribute) and
                        isinstance(t.value, ast.Name) and t.value.id == cls}
        names[cls] = {n for n in got if not n.startswith("_")}
    got = set()
    for n in module_level(ast.parse((pkg / "__init__.py").read_text())):
        if isinstance(n, (ast.ImportFrom, ast.Import)):
            got |= {a.asname or a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.Assign):
            got |= {t.id for t in n.targets if isinstance(t, ast.Name)}
    names["package"] = {n for n in got if not n.startswith("_") and n != "annotations"}
    return names


def _check_refusal_table() -> None:
    """Every public name of the JAX package's four classes and package is
    in the port: implemented, or a stub of ``polars_tpu_torch/later.py``
    that raises ``NotImplementedError`` naming its ROADMAP item (none of
    them items 4b or 5, which are done). Every stub names something
    the JAX package has, so the table cannot go stale."""
    from polars_tpu_torch import later
    from polars_tpu_torch.core.frame import DataFrame
    from polars_tpu_torch.core.series import Series
    from polars_tpu_torch.expr.expr import Expr
    from polars_tpu_torch.lazyframe import LazyFrame

    owners = {"DataFrame": DataFrame, "LazyFrame": LazyFrame, "Expr": Expr, "Series": Series, "package": plt}
    ref = _reference_names()
    for owner, obj in owners.items():
        stubs = {n for names in later.LATER[owner].values() for n in names}
        assert stubs <= ref[owner], f"later.py names what the JAX package's {owner} lacks: {stubs - ref[owner]}"
        for name in sorted(ref[owner]):
            raw = vars(obj).get(name) if owner != "package" else getattr(obj, name, None)
            if raw is None and owner == "Series":  # an Expr method, run over the Series
                raw = vars(Expr).get(name)
            if raw is None:
                raw = next((vars(c)[name] for c in getattr(obj, "__mro__", ())[1:] if name in vars(c)), None)
            assert raw is not None, f"{owner}.{name} is neither ported nor in later.py"
            fn = raw.fget if isinstance(raw, property) else raw
            item = getattr(fn, "later_item", None)
            assert (item is not None) == (name in stubs), f"{owner}.{name}: stub {item!r}, table {name in stubs}"
    for owner, items in later.LATER.items():
        assert not any(item.startswith(("4b", "5")) for item in items), owner
    with pytest.raises(NotImplementedError, match="item 7"):
        plt.DataFrame({"a": [1]}).sql("select a from self")
    with pytest.raises(NotImplementedError, match="item 7"):
        plt.plugins.register_plugin_function(function_name="f")
    with pytest.raises(NotImplementedError, match="item 6"):
        plt.DataFrame({"a": [1]}).lazy().sink_parquet("x.parquet")


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


def _release_compiled_programs() -> None:
    """Drop the reference's compiled XLA programs this worker holds, before
    a test that compiles a few hundred: each keeps its memory mappings
    while JAX's caches hold it, and a worker past the kernel's
    ``vm.max_map_count`` crashes inside the compiler (ROADMAP section 3,
    the harness fault)."""
    import gc

    import jax

    jax.clear_caches()
    gc.collect()


def test_math_casts_aggs_differential():
    _release_compiled_programs()
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


@contextlib.contextmanager
def port_on_cpu():
    """The port's default device set to the CPU for the checks of this file
    that another port test file runs (its own fixture sets it here)."""
    prev = plt.set_default_device("cpu")
    try:
        yield
    finally:
        plt.set_default_device(prev)


def _check_expression_leftovers(lj, lt) -> None:
    """ROADMAP item 3b through both packages over the seeded frames: is_in
    against a column (the set of its kept values), a literal Series of the
    frame's length in an expression, and aggregations whose inputs keep
    different rows lined up by their place in the group. Where the
    reference is wrong, a Python oracle of Polars' semantics:
    ``search_sorted`` and ``qcut`` in a window run over the whole column
    there (``fn_core.py:1110-1155``), and two filtered inputs of one
    aggregation, or of ``pl.corr``, raise there. Integers and strings
    exact, floats to rtol 1e-9."""
    c, cj = plt.col, plj.col
    n = lt.height
    rng = np.random.default_rng(17)
    extra = rng.integers(-50, 50, n).tolist()

    def exprs(pl, col):
        return [col("h").is_in(col("i8")).alias("in_col"), col("g").is_in(col("s")).alias("in_str"),
                col("i16").is_in(col("h") - 5, nulls_equal=True).alias("in_expr"),
                (col("h") + pl.Series(extra)).alias("plus_series"), (col("f64") * pl.Series(extra)).alias("mul")]

    _assert_frames_match(lt.select(exprs(plt, c)), lj.select(exprs(plj, cj)), label="item 3b select")
    _assert_frames_match(lt.with_columns(z=plt.Series(extra)).select("h", "z"),
                         lj.with_columns(z=plj.Series(extra)).select("h", "z"), label="a Series column")
    per = [(lt.group_by("g").agg(c("h").filter(c("b")).sum() / c("i8").sum(), c("f64").filter(c("b")).max())
            .sort("g")),
           (lj.group_by("g").agg(cj("h").filter(cj("b")).sum() / cj("i8").sum(), cj("f64").filter(cj("b")).max())
            .sort("g"))]
    _assert_frames_match(per[0], per[1], label="filtered aggregations")

    # two inputs that keep different rows in one aggregation: paired by
    # their place in the group (a Python oracle; the reference raises)
    rows = lt.select("g", "h", "i8", "b", "f64", "f32").rows()
    m = lambda r: r[3] is True  # noqa: E731
    got = lt.group_by("g").agg(
        (c("h").filter(c("b")) + c("i8").filter(c("b"))).sum().alias("s"),
        c("h").filter(c("b")).alias("kept"),
        plt.corr(c("h").filter(c("b")), c("i8").filter(c("b"))).alias("r")).sort("g")
    with pytest.raises(Exception):
        lj.group_by("g").agg((cj("h").filter(cj("b")) + cj("i8").filter(cj("b"))).sum())
    for key, s_, kept_h, r_ in got.rows():
        kept = [r for r in rows if r[0] == key and m(r)]
        assert s_ == sum(a + b for a, b in ((r[1], r[2]) for r in kept) if b is not None), key
        assert kept_h == [r[1] for r in kept], key
        both = [(r[1], r[2]) for r in kept if r[2] is not None]
        if len(both) > 2:
            assert r_ == pytest.approx(float(np.corrcoef(np.asarray(both, float).T)[0, 1]), rel=1e-9), key

    # search_sorted and qcut in a window: each group on its own (Polars);
    # the reference runs both over the whole column
    k = rng.integers(0, 4, 40)
    v = np.sort(rng.integers(0, 30, 40))[np.argsort(k, kind="stable")]
    k = np.sort(k)
    needle = rng.integers(-2, 32, 40)
    w = plt.DataFrame({"k": k, "v": v, "e": needle})
    out = w.select(c("v").search_sorted(c("e")).over("k").alias("row"),
                   c("v").search_sorted(12, side="right").over("k").alias("scalar"),
                   c("v").cast(plt.Float64).qcut([0.3, 0.6], allow_duplicates=True).over("k").alias("q"))
    import bisect

    for i in range(40):
        grp = v[k == k[i]].tolist()
        assert out["row"][i] == bisect.bisect_left(grp, needle[i]), i
        assert out["scalar"][i] == bisect.bisect_right(grp, 12), i
    alone = {g: plt.DataFrame({"v": v[k == g].astype(float)}).select(
        c("v").qcut([0.3, 0.6], allow_duplicates=True))["v"].to_list() for g in set(k.tolist())}
    assert out["q"].to_list() == [x for g in sorted(alone) for x in alone[g]]
    # groups that share their breaks share their labels (labelled once each)
    same = plt.DataFrame({"k": [0, 0, 0, 1, 1, 1, 2, 2], "v": [1.0, 2.0, 3.0, 3.0, 2.0, 1.0, 5.0, 9.0]})
    assert same.select(c("v").qcut([0.5]).over("k"))["v"].to_list() == \
        ["(-inf, 2]", "(-inf, 2]", "(2, inf]", "(2, inf]", "(-inf, 2]", "(-inf, 2]", "(-inf, 7]", "(7, inf]"]
    wj = plj.DataFrame({"k": k, "v": v, "e": needle}).select(
        plj.col("v").search_sorted(12, side="right").over("k").alias("s"))
    assert wj["s"].to_list() != out["scalar"].to_list(), "the reference searches the whole column"
    agg = w.group_by("k").agg(c("v").search_sorted(12).alias("at")).sort("k")
    assert agg["at"].to_list() == [[bisect.bisect_left(v[k == g].tolist(), 12)] for g in sorted(set(k.tolist()))]


_SPLIT_EXACT = "fn_strings.py:711-722: str.split_exact(by, n) keeps the rest of the string in its last field"
_MOVED_EMPTY = ("fn_position.py:306-330 (reverse), shift, reverse and sort_by of a Struct, shift within a window "
                "and coalesce rebuild the value without its child: its lists and structs come back empty")


def _nested_data(seed: int, n: int = 30) -> dict:
    """Lists of integers, floats, strings and Booleans with null elements,
    empty lists and null lists, a second integer list of the same lengths,
    index lists, a group key and a text column to split."""
    rng = np.random.default_rng(seed)
    words = ["ab", "cd", "e", "fgh", "i"]

    def lists(make):
        out = []
        for _ in range(n):
            r = rng.random()
            if r < 0.1:
                out.append(None)
            elif r < 0.2:
                out.append([])
            else:
                m = int(rng.integers(1, 6))
                out.append([None if rng.random() < 0.15 else make() for _ in range(m)])
        return out

    li = lists(lambda: int(rng.integers(-20, 20)))
    return {
        "k": rng.integers(0, 4, n).tolist(), "li": li,
        "lj": [None if x is None else [int(rng.integers(-5, 5)) for _ in x] for x in li],
        "lf": lists(lambda: float(np.round(rng.normal() * 100, 3))),
        "ls": lists(lambda: words[int(rng.integers(0, 5))]),
        "lb": lists(lambda: bool(rng.random() < 0.5)),
        "ix": [[int(rng.integers(-2, 2)) for _ in range(int(rng.integers(0, 3)))] for _ in range(n)],
        "t": [None if rng.random() < 0.1 else
              " ".join(words[int(j)] for j in rng.integers(0, 5, int(rng.integers(1, 4)))) + f"-{i}" for i in range(n)],
        "x": rng.integers(0, 100, n).tolist(),
    }


def _list_exprs(pl) -> list:
    c = pl.col
    e = pl.element()
    return [c("li").list.len().alias("len"), c("li").list.sum().alias("sum"), c("lf").list.mean().alias("mean"),
            c("li").list.min().alias("min"), c("lf").list.max().alias("max"), c("ls").list.min().alias("smin"),
            c("li").list.first().alias("first"), c("li").list.last().alias("last"),
            c("li").list.get(1, null_on_oob=True).alias("get1"), c("li").list.contains(3).alias("has3"),
            c("li").list.count_matches(0).alias("zeros"),
            c("lb").list.any().alias("any"), c("lb").list.all().alias("all"), c("li").list.n_unique().alias("nu"),
            c("li").list.arg_min().alias("amin"), c("lf").list.arg_max().alias("amax"),
            c("li").list.std().alias("std"), c("li").list.var(ddof=0).alias("var0"),
            c("li").list.median().alias("med"),
            c("li").list.sort().alias("sorted"), c("li").list.sort(descending=True, nulls_last=True).alias("sdesc"),
            c("ls").list.sort().alias("ssort"), c("li").list.reverse().alias("rev"),
            c("li").list.unique(maintain_order=True).alias("uniq"), c("ls").list.unique().alias("suniq"),
            c("li").list.head(2).alias("head"), c("li").list.tail(2).alias("tail"),
            c("li").list.slice(1, 2).alias("slice"), c("li").list.shift(1).alias("shift"),
            c("li").list.diff().alias("diff"), c("li").list.drop_nulls().alias("dn"),
            c("li").list.gather_every(2).alias("every"), c("li").list.concat(c("lj")).alias("cat"),
            c("li").list.set_union(c("lj")).alias("union"), c("li").list.set_intersection(c("lj")).alias("inter"),
            c("li").list.set_difference(c("lj")).alias("minus"),
            c("li").list.set_symmetric_difference(c("lj")).alias("xor"),
            c("li").list.eval(e * 2 + 1).alias("ev"), c("li").list.filter(e > 0).alias("pos"),
            c("li").list.gather(c("ix"), null_on_oob=True).alias("gat"),
            c("li").list.gather([0], null_on_oob=True).alias("g0"), c("li").cast(pl.List(pl.Float64)).alias("cast"),
            pl.concat_list("x", "k").alias("cl"), c("x").is_in(c("li")).alias("x_in"),
            c("ls").list.join("-").alias("joined")]


def _set_oracle(kind: str, a: list | None, b: list) -> list | None:
    """Polars' set operations: the distinct elements in order of first
    appearance, those of ``a`` before those of ``b``."""
    if a is None:
        return None
    sa, sb = list(dict.fromkeys(a)), list(dict.fromkeys(b))
    return {"set_union": list(dict.fromkeys(sa + sb)), "set_intersection": [v for v in sa if v in sb],
            "set_difference": [v for v in sa if v not in sb],
            "set_symmetric_difference": [v for v in sa if v not in sb] + [v for v in sb if v not in sa]}[kind]


def _check_list_literal_arguments(ft, fj, data: dict) -> None:
    """A Python list as a list function's argument is a one-row List
    literal for every row (it raised "unsupported literal shape" before):
    each set operation, ``is_in`` and ``list.contains`` against such a
    literal, through both packages where the reference is right and
    against Python where it is not (its ``list.concat`` with a literal
    gives one row, its ``list.contains`` of a literal list refuses, its
    ``is_in`` a List literal; ROADMAP section 3). A ``struct.drop`` of a
    missing field raises (the port ignored it), as do ``struct.field`` and
    ``with_fields`` reading one."""
    c, cj = plt.col, plj.col
    kinds = ("set_union", "set_intersection", "set_difference", "set_symmetric_difference")
    lit_b = [3, None, 9, 3]
    got = ft.select([getattr(c("li").list, k)(lit_b).alias(k) for k in kinds])
    for k in kinds:
        assert got[k].to_list() == [_set_oracle(k, x, lit_b) for x in data["li"]], k
    want = fj.select([getattr(cj("li").list, k)([3, 9]).alias(k) for k in ("set_intersection", "set_difference")])
    _assert_frames_match(ft.select([getattr(c("li").list, k)([3, 9]).alias(k)
                                    for k in ("set_intersection", "set_difference")]), want, label="set literal")
    cat = ft.select(c("li").list.concat([7]).alias("cat"), c("li").list.concat(plt.lit(plt.Series([[7, 8]]))).alias("c2"))
    assert cat["cat"].to_list() == [None if x is None else x + [7] for x in data["li"]]
    assert cat["c2"].to_list() == [None if x is None else x + [7, 8] for x in data["li"]]
    member = ft.select(c("x").is_in(plt.lit(plt.Series([[1, 2, 3]]))).alias("in_lit"),
                       c("li").list.contains(plt.lit(3)).alias("has3"))
    assert member["in_lit"].to_list() == [None if v is None else v in (1, 2, 3) for v in data["x"]]
    assert member["has3"].to_list() == [None if x is None else 3 in x for x in data["li"]]
    s = plt.DataFrame({"s": [{"a": 1, "b": 2, "c": 3}, None]})
    assert s.select(c("s").struct.drop(["b"]))["s"].to_list() == [{"a": 1, "c": 3}, None]
    for bad in (c("s").struct.drop(["zzz"]), c("s").struct.field("zzz"),
                c("s").struct.with_fields(plt.field("zzz") + 1)):
        with pytest.raises(plt.PolarsError):
            s.select(bad)


def _check_nested_differential() -> None:
    """List, Array and Struct columns through both packages over seeded
    lists (null elements, empty and null lists): the list functions in one
    select, explode and implode, the Struct functions, ``str.split`` and
    the other string functions that give nested values, a gather in each
    group and ``over(mapping_strategy="join")``. Where the reference is
    wrong, a Python oracle of Polars' semantics: ``list.gather`` of an
    empty literal index list crashes there (``fn_nested.py:1129-1132``);
    ``qcut(include_breaks=True)`` labels by the fractions. Integers,
    strings and null masks exact, floats to rtol 1e-9."""
    data = _nested_data(23)
    fj, ft = plj.DataFrame(data), plt.DataFrame(data)
    assert [repr(d) for d in ft.schema.values()] == [repr(d) for d in fj.schema.values()]
    et, ej = _list_exprs(plt), _list_exprs(plj)
    for k in range(0, len(et), 8):  # eight at a time: the reference compiles a wide select of them piecewise
        _assert_frames_match(ft.select(et[k:k + 8]), fj.select(ej[k:k + 8]), label="list functions")
    # an empty literal index list gives empty lists (the reference crashes);
    # a string element and an aggregation per list against Python (the
    # reference evaluates these per list on the host: compiles kept few)
    c, cj = plt.col, plj.col
    few = ft.select(c("li").list.gather([]).alias("none"), c("ls").list.contains("e").alias("has_e"),
                    c("li").list.eval(plt.element().sum()).alias("evsum"))
    assert few["none"].to_list() == [None if x is None else [] for x in data["li"]]
    assert few["has_e"].to_list() == [None if x is None else "e" in x for x in data["ls"]]
    assert few["evsum"].to_list() == [None if x is None else [sum(v for v in x if v is not None)] for x in data["li"]]
    _check_list_literal_arguments(ft, fj, data)

    # explode and implode: a null or empty list gives one null row
    _assert_frames_match(ft.explode("li", "lj").select("k", "li", "lj"), fj.explode("li", "lj").select("k", "li", "lj"),
                         label="explode")
    assert ft.select(c("ls").explode())["ls"].to_list() == [v for x in data["ls"] for v in (x or [None])]
    imp = [f.group_by("k").agg(col("x"), col("lf").list.len().alias("n"), col("x").implode().alias("xi"),
                               col("x").agg_groups().alias("rows")).sort("k") for f, col in ((ft, c), (fj, cj))]
    _assert_frames_match(imp[0], imp[1], label="implode")
    _assert_frames_match(ft.select(c("x").implode()), fj.select(cj("x").implode()), label="implode select")
    back = imp[0].explode("x").select("k", "x")  # each group's rows in row order, the groups by key
    assert back.rows() == sorted(zip(data["k"], data["x"]), key=lambda r: r[0])
    _assert_frames_match(ft.filter(c("k") > 0).explode("ls").filter(c("ls") != "e").select("x", "ls"),
                         fj.filter(cj("k") > 0).explode("ls").filter(cj("ls") != "e").select("x", "ls"),
                         label="filter explode filter")

    # the row functions move nested values with their elements; where the
    # reference returns them empty (_MOVED_EMPTY), against Python
    def moved(pl):
        col = pl.col
        return [col("li").shift(1).alias("sh"), col("lf").sort_by("x").alias("sb"),
                col("li").forward_fill().alias("ff"), col("ls").backward_fill().alias("bf")]

    _assert_frames_match(ft.select(moved(plt)), fj.select(moved(plj)), label="moved lists")
    rows = ft.select(c("ls").reverse().alias("rv"), plt.struct("x", "k").shift(-2).alias("ssh"),
                     plt.struct("x", "k").reverse().alias("srv"),
                     plt.struct("x", "k").sort_by("x", descending=True).alias("ssb"),
                     c("li").shift(1).over("k").alias("sho"), plt.coalesce(c("li"), c("ix")).alias("co"),
                     plt.when(c("x") > 50).then(plt.struct("x", "k")).forward_fill().alias("sff"))
    recs = [{"x": x, "k": k} for x, k in zip(data["x"], data["k"])]
    prev = [next((data["li"][j] for j in range(i - 1, -1, -1) if data["k"][j] == k), None)
            for i, k in enumerate(data["k"])]
    assert rows["rv"].to_list() == data["ls"][::-1] != fj.select(cj("ls").reverse())["ls"].to_list(), _MOVED_EMPTY
    assert rows["ssh"].to_list() == recs[2:] + [None, None]
    assert rows["srv"].to_list() == recs[::-1]
    assert rows["ssb"].to_list() == sorted(recs, key=lambda r: r["x"], reverse=True)
    assert rows["sho"].to_list() == prev
    assert rows["co"].to_list() == [b if a is None else a for a, b in zip(data["li"], data["ix"])]
    assert rows["sff"].to_list() == _ffill([r if r["x"] > 50 else None for r in recs])
    one = ft.with_row_index("r").group_by("r").agg(c("li").item(), c("ls").item().alias("s1")).sort("r")
    assert one["li"].to_list() == data["li"] and one["s1"].to_list() == data["ls"]
    # a gather of one index in a window: each group's value at it, on its rows
    firsts = {k: data["li"][data["k"].index(k)] for k in set(data["k"])}
    assert ft.select(c("li").gather(0).over("k"))["li"].to_list() == [firsts[k] for k in data["k"]]
    # a nested value orders, groups and compares by its content, never by
    # the word that points into its child (_check_content_keys_differential
    # holds each consumer to Python); a join on one raises, as the
    # reference and Polars do, and so does a mean of one
    lx = ft.select("x", "li", "k", s=plt.struct("x", "k"))
    by_li = sorted(range(len(data["x"])), key=lambda i: _content_key(data["li"][i]))
    assert lx.sort("li", maintain_order=True)["x"].to_list() == [data["x"][i] for i in by_li]
    distinct = len({repr(_content_key(v)) for v in data["li"]})
    assert lx.select(c("li").n_unique()).item() == distinct == lx.group_by("li").agg(c("x").sum()).height
    assert lx.unique(subset=["s"]).height == len(set(zip(data["x"], data["k"])))
    assert lx.with_row_index("i").rolling("i", period="2i").agg(c("li").max())["li"].to_list() == [
        max(data["li"][max(i - 1, 0):i + 1], key=_content_key) for i in range(len(data["li"]))]
    for run in (lambda: lx.join(lx, on="li"), lambda: lx.join(lx, on="s")):
        with pytest.raises(plt.InvalidOperationError, match="cannot join on dtype"):
            run()
    with pytest.raises(plt.InvalidOperationError, match="not supported for dtype"):
        lx.select(c("li").mean())
    assert lx.unique(subset=["k"], keep="first", maintain_order=True)["li"].to_list() == \
        [data["li"][data["k"].index(k)] for k in dict.fromkeys(data["k"])]
    with pytest.raises(plt.InvalidOperationError, match="strategy='zero'"):
        lx.select(c("li").fill_null(strategy="zero"))
    lost = plt.Series("li", data["li"])._column
    with pytest.raises(plt.ComputeError, match="lost its elements"):
        type(lost)("li", lost.dtype, lost.buffer).to_pylist()

    # structs and the string functions that give nested values; the rest
    # against Python (each costs the reference compiles of its own)
    def structs(pl):
        col = pl.col
        return [pl.struct("x", "k").alias("s"), pl.struct(col("x").alias("a"), col("ls")).struct.field("ls"),
                pl.struct("x", "k").struct.rename_fields(["p", "q"]).alias("r"),
                col("t").str.split(" ").alias("split"), col("t").str.extract_all(r"[a-e]+").alias("all"),
                col("t").str.split(" ").list.len().alias("words")]

    _assert_frames_match(ft.select(structs(plt)), fj.select(structs(plj)), label="structs and splits")
    more = ft.select(plt.struct("x", "k").struct.with_fields((plt.field("x") * 2).alias("x2")).alias("w"),
                     (plt.struct("x", "k") == plt.struct("k", "x").struct.rename_fields(["x", "k"])).alias("eq"),
                     c("t").str.split(" ", inclusive=True).alias("isplit"), c("t").str.split_exact(" ", 1).alias("se"),
                     c("t").str.splitn(" ", 2).alias("sn"), c("t").str.extract_groups(r"(\w+)-(\d+)").alias("eg"))
    assert more["w"].to_list() == [{"x": x, "k": k, "x2": 2 * x} for x, k in zip(data["x"], data["k"])]
    assert more["eq"].to_list() == [x == k for x, k in zip(data["x"], data["k"])]
    texts = data["t"]
    assert more["isplit"].to_list() == [None if t is None else [p + " " for p in t.split(" ")[:-1]] + [t.split(" ")[-1]]
                                        for t in texts]
    # split_exact takes the first n + 1 parts (Polars); the reference keeps
    # the rest in the last field, as splitn does (_SPLIT_EXACT)
    def fields(parts):
        return dict(zip(("field_0", "field_1"), (parts + [None])[:2]))

    assert more["se"].to_list() == [None if t is None else fields(t.split(" ")) for t in texts], _SPLIT_EXACT
    assert more["sn"].to_list() == [None if t is None else fields(t.split(" ", 1)) for t in texts]
    groups = [None if t is None else re.search(r"(\w+)-(\d+)", t) for t in texts]
    assert more["eg"].to_list() == [None if t is None else {"1": m.group(1), "2": m.group(2)} if m else
                                    {"1": None, "2": None} for t, m in zip(texts, groups)]
    st = ft.select(plt.struct("x", "k").alias("s"), "t")
    _assert_frames_match(st.unnest("s"), fj.select(plj.struct("x", "k").alias("s"), "t").unnest("s"), label="unnest")
    assert st.select(c("s").struct.json_encode())["s"].to_list() == [f'{{"x":{x},"k":{k}}}' for x, k in
                                                                    zip(data["x"], data["k"])]

    # a gather in each group, over() joined as lists, include_breaks
    per = [f.group_by("k").agg(col("x").gather([0, -1]).alias("ends"), col("x").gather(0).alias("first"))
           .sort("k") for f, col in ((ft, c), (fj, cj))]
    _assert_frames_match(per[0], per[1], label="gather in groups")
    joins = [f.select(col("x").over("k", mapping_strategy="join").alias("j"),
                      col("x").sum().over("k", mapping_strategy="join").alias("js")) for f, col in ((ft, c), (fj, cj))]
    _assert_frames_match(joins[0], joins[1], label="over join")
    q = ft.select(c("x").cast(plt.Float64).qcut([0.5], include_breaks=True))["x"].to_list()
    med = float(np.quantile(np.asarray(data["x"], float), 0.5))
    label = str(int(med)) if med.is_integer() else repr(med)
    assert q == [{"breakpoint": med, "category": f"(-inf, {label}]"} if x <= med else
                 {"breakpoint": math.inf, "category": f"({label}, inf]"} for x in data["x"]]

    # the Series namespaces and printing
    s = plt.Series("li", data["li"])
    assert s.list.len().to_list() == [None if x is None else len(x) for x in data["li"]]
    assert s.explode().to_list() == fj["li"].explode().to_list()
    assert plt.Series("s", [{"a": 1}, None]).struct.fields == ["a"]
    assert "[" in repr(ft.select("li").head(3)) and "{" in repr(st.head(2))
    arr = plt.DataFrame({"a": [[1, 2], [3, None]]}, schema={"a": plt.Array(plt.Int64, 2)})
    assert arr.select(c("a").arr.sum(), c("a").arr.get(1).alias("g"))["g"].to_list() == [2, None]


# -- nested values by their content, and the rest of item 4b (ROADMAP item 4c) ----------------


def _content_key(v):
    """Polars' order of a value, nested or not: a List element by element,
    a list that is a prefix of another first, a Struct field by field, and
    a null least at any place (the order ``kernels/nested_keys.py``
    writes). Equal contents give equal keys."""
    if v is None:
        return (0,)
    if isinstance(v, dict):
        return (1, [_content_key(x) for x in v.values()])
    if isinstance(v, list):
        return (1, [_content_key(x) for x in v])
    return (1, v)


def _sorted_rows(values: list, descending: bool, nulls_last: bool) -> list[int]:
    """The row order of a stable sort by content; top-level nulls first
    unless ``nulls_last``, whatever ``descending`` is."""
    rows = [i for i, v in enumerate(values) if v is not None]
    rows = sorted(rows, key=lambda i: _content_key(values[i]), reverse=descending)
    nulls = [i for i, v in enumerate(values) if v is None]
    return rows + nulls if nulls_last else nulls + rows


def _content_data(seed: int, n: int = 28) -> dict:
    """Lists with null elements, empty lists, null lists and lists that are
    prefixes of others; lists of strings; a Struct with a null field and a
    List field; fixed-width Arrays; a group key and values."""
    rng = np.random.default_rng(seed)
    pool = [[1, 2], [1, 2, 3], [1], [], [None], [1, None], [2], [None, 1], [3, 0], [1, 2]]
    spool = [["b", "a"], ["a"], ["a", None], [], ["b"], ["a", "b"]]

    def pick(p, null):
        return None if rng.random() < null else list(p[int(rng.integers(len(p)))])

    li = [pick(pool, 0.12) for _ in range(n)]
    return {
        "li": li, "lj": [pick(pool, 0.1) for _ in range(n)], "ls": [pick(spool, 0.1) for _ in range(n)],
        "s": [None if rng.random() < 0.1 else {"a": None if rng.random() < 0.2 else int(rng.integers(0, 3)),
                                                "b": ["x", "y", None][int(rng.integers(3))],
                                                "l": pick(pool[:4], 0.2)} for _ in range(n)],
        "ar": [[int(rng.integers(0, 2)), int(rng.integers(0, 3))] for _ in range(n)],
        "sd": [None if rng.random() < 0.15 else {"c": [None, "p", "q"][int(rng.integers(3))],
                                                  "f": [None, True, False][int(rng.integers(3))]} for _ in range(n)],
        "k": rng.integers(0, 3, n).tolist(), "x": rng.integers(0, 50, n).tolist(),
    }


@contextlib.contextmanager
def _list_ranking(refines: bool):
    """Force one of the two ways a List is ranked
    (``kernels/nested_keys._refines``): a frame of the CPU tests is too small
    for refinement to be chosen, the card's SF10 columns take it."""
    from polars_tpu_torch.kernels import nested_keys

    prev = nested_keys._refines
    nested_keys._refines = lambda longest, total: refines
    try:
        yield
    finally:
        nested_keys._refines = prev


def _check_content_column(ft, data: dict, col: str) -> None:
    """One column of ``_content_data`` by its content through the port,
    held to Python: sorts, group-by, distinct, flags, ranks and the
    functions of a column of its own length."""
    c = plt.col
    n = len(data["x"])
    vals = data[col]
    for desc, nl in ((False, False), (True, True), (True, False)):
        order = _sorted_rows(vals, desc, nl)
        got = ft.sort(col, descending=desc, nulls_last=nl, maintain_order=True)
        assert got["x"].to_list() == [data["x"][i] for i in order], (col, desc, nl)
        assert got[col].to_list() == [vals[i] for i in order], (col, desc, nl)
    keys = [repr(_content_key(v)) for v in vals]
    first = list(dict.fromkeys(keys))
    g = ft.group_by(col, maintain_order=True).agg(plt.len(), c("x").sum())
    assert g[col].to_list() == [vals[keys.index(k)] for k in first], col
    assert g["len"].to_list() == [keys.count(k) for k in first], col
    assert g["x"].to_list() == [sum(x for x, kk in zip(data["x"], keys) if kk == k) for k in first], col
    assert ft.unique(subset=[col], keep="first", maintain_order=True)["x"].to_list() == [
        data["x"][keys.index(k)] for k in first], col
    flags = ft.select(c(col).n_unique().alias("nu"), c(col).is_duplicated().alias("dup"),
                      c(col).is_unique().alias("uq"), c(col).is_first_distinct().alias("fd"),
                      c(col).is_last_distinct().alias("ld"), c(col).rle_id().alias("run"),
                      c(col).unique(maintain_order=True).alias("u").implode(),
                      c("x").sum().over(col).alias("ov"), c(col).is_in(c(col).implode()).alias("isin"))
    assert flags["nu"].to_list() == [len(first)] * n, col
    assert flags["dup"].to_list() == [keys.count(k) > 1 for k in keys], col
    assert flags["uq"].to_list() == [keys.count(k) == 1 for k in keys], col
    assert flags["fd"].to_list() == [keys.index(k) == i for i, k in enumerate(keys)], col
    assert flags["ld"].to_list() == [n - 1 - keys[::-1].index(k) == i for i, k in enumerate(keys)], col
    runs = np.cumsum([i == 0 or keys[i] != keys[i - 1] for i in range(n)]) - 1
    assert flags["run"].to_list() == runs.tolist(), col
    assert flags["u"].to_list()[0] == [vals[keys.index(k)] for k in first], col
    assert flags["ov"].to_list() == [sum(x for x, kk in zip(data["x"], keys) if kk == k) for k in keys], col
    assert flags["isin"].to_list() == [None if v is None else True for v in vals], col
    order = ft.select(c(col).arg_sort().alias("as"), c(col).arg_sort(descending=True, nulls_last=True).alias("asd"),
                      c(col).rank("dense").alias("rk"), c(col).rank("min", descending=True).alias("rkm"),
                      c(col).cum_count().alias("cc"), plt.arg_sort_by(col, "x").alias("asb"))
    ck = [_content_key(v) for v in vals]
    dense = {repr(k): i + 1 for i, k in enumerate(sorted({repr(k): k for k in ck if k != (0,)}.values()))}
    assert order["as"].to_list() == _sorted_rows(vals, False, False), col
    assert order["asd"].to_list() == _sorted_rows(vals, True, True), col
    assert order["rk"].to_list() == [None if v is None else dense[repr(k)] for v, k in zip(vals, ck)], col
    assert order["rkm"].to_list() == [None if v is None else 1 + sum(kk != (0,) and kk > k for kk in ck)
                                      for v, k in zip(vals, ck)], col
    assert order["cc"].to_list() == np.cumsum([v is not None for v in vals]).tolist(), col
    assert order["asb"].to_list() == sorted(range(n), key=lambda i: (ck[i], data["x"][i])), col
    # the functions of a column of its own length, over a nested value
    starts = [i for i in range(n) if i == 0 or keys[i] != keys[i - 1]]
    assert ft.select(c(col).rle())[col].to_list() == [
        {"len": e - i, "value": vals[i]} for i, e in zip(starts, starts[1:] + [n])], col
    counts = ft.select(c(col).value_counts(sort=True))[col].to_list()
    assert [(repr(_content_key(d[col])), d["count"]) for d in counts] == sorted(
        ((k, keys.count(k)) for k in first), key=lambda kc: -kc[1]), col
    assert ft.select(c(col).unique_counts())[col].to_list() == [keys.count(k) for k in first], col
    assert ft.select(c(col).extend_constant(None, 2))[col].to_list() == vals + [None, None], col
    assert ft.select(c(col).append(c(col).reverse()))[col].to_list() == vals + vals[::-1], col
    assert ft.select(c(col).repeat_by("k"))[col].to_list() == [[v] * k for v, k in zip(vals, data["k"])], col
    shuf = ft.select(c(col).shuffle(seed=3))[col].to_list()
    assert shuf == ft.select(c(col).shuffle(seed=3))[col].to_list(), col
    assert sorted(map(repr, map(_content_key, shuf))) == sorted(keys), col
    for repl in (False, True):
        picked = ft.select(c(col).sample(n=n // 2, with_replacement=repl, seed=5))[col].to_list()
        assert len(picked) == n // 2 and {repr(_content_key(v)) for v in picked} <= set(keys), (col, repl)


def _check_content_keys_differential() -> None:
    """List, Array and Struct values by their content through the port (a
    Struct of dictionary-coded and Boolean fields by the dense group-by),
    held to a Python oracle of Polars' semantics (``_content_key``): the
    reference orders, groups, compares and hashes them by the word into
    their child (ROADMAP section 3), and is held to that fault on the
    probe frame of ROADMAP section 3. Sort (descending with ``nulls_last`` too),
    group-by, ``unique``, ``n_unique``, the distinct flags, ``rle_id``,
    ``hash`` (equal for equal contents built in two frames), ``==`` of two
    columns, ``is_in`` a List of such values, ``over`` a List key, a Struct's
    ``min``/``max``/``arg_min``/``arg_max``; a join on a nested key raises in
    both packages."""
    c = plt.col
    # ROADMAP section 3's probe: by content in the port, by the word in the reference
    probe = {"a": [[1, 2], [3], [1, 2], None, [3]],
             "s": [{"x": 1, "y": "a"}, {"x": 2, "y": "b"}, {"x": 1, "y": "a"}, {"x": 1, "y": None},
                   {"x": 2, "y": "b"}], "v": [5, 4, 3, 2, 1]}
    pt, pj = plt.DataFrame(probe), plj.DataFrame(probe)

    def probes(pl):
        col = pl.col
        return [col("a").n_unique().alias("nu_a"), col("s").n_unique().alias("nu_s"),
                col("a").is_duplicated().sum().alias("dup"), (col("a") == col("a").shift(2)).alias("eq")]

    got, ref = pt.select(probes(plt)), pj.select(probes(plj))
    assert got["nu_a"][0] == 3 == got["nu_s"][0] != ref["nu_a"][0]  # the aggregates broadcast
    assert got["dup"][0] == 4 != ref["dup"][0]
    assert got["eq"].to_list() == [None, None, True, None, False] != ref["eq"].to_list()
    assert pt.group_by("a").agg(c("v").sum()).sort("a").rows() == [(None, 2), ([1, 2], 8), ([3], 5)]
    assert pt.group_by("s", maintain_order=True).agg(plt.len()).rows() == [
        ({"x": 1, "y": "a"}, 2), ({"x": 2, "y": "b"}, 2), ({"x": 1, "y": None}, 1)]
    assert pj.group_by("a").agg(plj.col("v").sum()).height == 5  # five groups with empty keys
    assert pt.select(c("s").max(), c("s").min().alias("mn")).rows() == [({"x": 2, "y": "b"}, {"x": 1, "y": None})]
    assert pt.select(c("a").hash())["a"].to_list()[0] == pt.select(c("a").hash())["a"].to_list()[2]
    for pl, f in ((plt, pt), (plj, pj)):
        with pytest.raises(pl.InvalidOperationError, match="cannot join on dtype"):
            f.join(f, on="a")

    data = _content_data(41)
    ft = plt.DataFrame(data, schema_overrides={"ar": plt.Array(plt.Int64, 2)})
    n = len(data["x"])
    for refines, col in itertools.product((False, True), ("li", "ls", "s", "ar", "sd")):  # sd: the dense group-by
        with _list_ranking(refines):
            _check_content_column(ft, data, col)

    # == of two columns; equal contents hash equal in another frame, whose
    # child is laid out otherwise
    eq = ft.select((c("li") == c("lj")).alias("eq"), (c("li") != c("lj")).alias("ne"),
                   c("li").eq_missing(c("lj")).alias("eqm"), (c("s") == c("s").reverse()).alias("seq"))
    assert eq["eq"].to_list() == [None if a is None or b is None else a == b for a, b in zip(data["li"], data["lj"])]
    assert eq["ne"].to_list() == [None if a is None or b is None else a != b for a, b in zip(data["li"], data["lj"])]
    assert eq["eqm"].to_list() == [a == b for a, b in zip(data["li"], data["lj"])]
    assert eq["seq"].to_list() == [None if a is None or b is None else a == b
                                   for a, b in zip(data["s"], data["s"][::-1])]
    for col in ("li", "ls", "s"):
        vals = data[col]
        other = plt.DataFrame({col: [vals[0], None] + vals[::-1]})
        h1 = dict(zip(map(repr, vals), ft.select(c(col).hash(7))[col].to_list()))
        h2 = dict(zip(map(repr, [vals[0], None] + vals[::-1]), other.select(c(col).hash(7))[col].to_list()))
        assert h1 == {k: h2[k] for k in h1}, col
        assert len(set(h1.values())) == len(h1), col  # distinct contents, distinct hashes
    # a Struct's extremes by content, null rows left out, per group too
    s = data["s"]
    live = [i for i, v in enumerate(s) if v is not None]
    lo = min(live, key=lambda i: _content_key(s[i]))
    hi = max(live, key=lambda i: _content_key(s[i]))
    hi = min(i for i in live if _content_key(s[i]) == _content_key(s[hi]))
    got = ft.select(c("s").min().alias("mn"), c("s").max().alias("mx"), c("s").arg_min().alias("amn"),
                    c("s").arg_max().alias("amx"), c("li").max().alias("lmx"))
    assert got.rows() == [(s[lo], s[hi], lo, hi, max((v for v in data["li"] if v is not None), key=_content_key))]
    per = ft.group_by("k").agg(c("s").max(), c("li").min()).sort("k")
    for k, smax, lmin in per.rows():
        rows = [i for i in range(n) if data["k"][i] == k]
        sv = [s[i] for i in rows if s[i] is not None]
        lv = [data["li"][i] for i in rows if data["li"][i] is not None]
        assert smax == (max(sv, key=_content_key) if sv else None), k
        assert lmin == (min(lv, key=_content_key) if lv else None), k
    # rolling extremes by content: a null row never stands for an empty
    # list, though a left join leaves its word pointing at content
    keep = [k for k in range(n) if data["x"][k] > 25]
    right = plt.DataFrame({"x": [data["x"][k] for k in keep], "m": [data["li"][k] for k in keep]},
                          schema_overrides={"m": plt.List(plt.Int64)})
    roll = ft.with_row_index("i").join(right.unique("x", keep="first"), on="x", how="left").sort("i").rolling(
        "i", period="3i").agg(c("m").min().alias("mn"), c("m").max().alias("mx"))
    masked = [next((data["li"][k] for k in keep if data["x"][k] == x), None) for x in data["x"]]
    for i, (mn, mx) in enumerate(zip(roll["mn"].to_list(), roll["mx"].to_list())):
        live = [v for v in masked[max(i - 2, 0):i + 1] if v is not None]
        assert (mn, mx) == ((min(live, key=_content_key), max(live, key=_content_key)) if live else (None, None)), i
    left = plt.DataFrame({"k": [1, 2, 3, 4], "i": [0, 1, 2, 3]}).join(
        plt.DataFrame({"k": [1, 3, 4], "m": [[5, 6], [], [9]]}), on="k", how="left").sort("i")
    assert left.rolling("i", period="2i").agg(c("m").min())["m"].to_list() == [[5, 6], [5, 6], [], []]
    # lists of thousands of elements rank by prefix doubling, in a few passes
    long = list(range(3000))
    vals = [long + [1], long, None, long[:-1] + [0], long, [0], [], long[:-1] + [None]]
    lf = plt.DataFrame({"li": vals, "x": list(range(len(vals)))})
    for desc, nl in ((False, False), (True, True)):
        assert lf.sort("li", descending=desc, nulls_last=nl)["x"].to_list() == _sorted_rows(vals, desc, nl)
    distinct = len({repr(_content_key(v)) for v in vals})
    assert lf.select(c("li").n_unique(), c("li").is_first_distinct().sum().alias("fd")).row(0) == (distinct, distinct)


def _check_item_4c_rest() -> None:
    """The rest of item 4b through the port: against the reference where it
    is right (``str.json_decode``, a gather in each group by per-row
    indices and its aggregation, the monthly ``date_ranges`` not from a
    month's end, a user's function under ``+ 1`` in a group-by), and
    against Python where it is wrong (``over(mapping_strategy="explode")``
    is read as ``group_to_rows`` there; ``date_ranges`` from the 31st
    raises there; ``datetime_ranges`` with ``time_zone`` is naive there) or
    draws otherwise (``list.sample(with_replacement=True)``: properties)."""
    c, cj = plt.col, plj.col
    d = {"k": [2, 1, 2, 1, 3, 2], "v": [5, 4, 3, 2, 1, 9], "i": [1, 0, -1, 0, 0, 2]}
    ft, fj = plt.DataFrame(d), plj.DataFrame(d)

    # over(mapping_strategy="explode"): each group's results after another,
    # the groups in order of their first rows
    got = ft.select(c("v").sort(descending=True).over("k", mapping_strategy="explode").alias("sd"))
    ref = fj.select(cj("v").sort(descending=True).over("k", mapping_strategy="explode").alias("sd"))
    groups = list(dict.fromkeys(d["k"]))
    want = [v for g in groups for v in sorted((v for v, k in zip(d["v"], d["k"]) if k == g), reverse=True)]
    assert got["sd"].to_list() == want != ref["sd"].to_list()
    agg = ft.lazy().filter(c("v") != 3).select(c("v").sum().over("k", mapping_strategy="explode")).collect()
    assert agg["v"].to_list() == [sum(v for v, k in zip(d["v"], d["k"]) if k == g and v != 3) for g in groups]

    # a gather in each group by per-row indices; its aggregations against
    # Python (the reference sums other rows, and recurses without end on
    # the three in one agg)
    _assert_frames_match(ft.group_by("k", maintain_order=True).agg(c("v").gather(c("i"))),
                         fj.group_by("k", maintain_order=True).agg(cj("v").gather(cj("i"))), label="gather per row")
    members = {g: [v for v, k in zip(d["v"], d["k"]) if k == g] for g in groups}
    picked = {g: [members[g][i] for i, k in zip(d["i"], d["k"]) if k == g] for g in groups}
    aggs = ft.group_by("k", maintain_order=True).agg(c("v").gather(c("i")).sum().alias("gs"),
                                                     c("v").gather(c("i")).max().alias("gm"),
                                                     c("v").gather(0).sum().alias("g0"))
    assert aggs.rows() == [(g, sum(picked[g]), max(picked[g]), members[g][0]) for g in groups]
    assert fj.group_by("k", maintain_order=True).agg(cj("v").gather(cj("i")).sum())["v"].to_list() != [
        sum(picked[g]) for g in groups]
    assert ft.select(c("v").gather(c("i")).over("k"))["v"].to_list() == [
        members[k][i] for k, i in zip(d["k"], d["i"])]
    two = plt.DataFrame({"k": [1, 1, 2, 2], "v": [1, 2, 3, 4]})
    assert two.select(c("v").gather([1, 0]).over("k"))["v"].to_list() == [2, 1, 4, 3]
    nulls = plt.DataFrame({"k": [1, 1, 2], "v": [1, 2, 3], "i": [None, 1, -1]})
    assert nulls.group_by("k", maintain_order=True).agg(c("v").gather(c("i")))["v"].to_list() == [[None, 2], [3]]
    with pytest.raises(plt.ComputeError, match="out of bounds"):
        ft.group_by("k").agg(c("v").gather(c("i") + 5))

    # str.json_decode: each dictionary value parsed once
    texts = {"j": ['{"a": 1, "b": [1, 2]}', None, '{"a": 2, "b": []}', '{"a": 1, "b": [1, 2]}', "oops"]}
    st = {"a": plt.Int64, "b": plt.List(plt.Int64)}
    _assert_frames_match(plt.DataFrame(texts).select(c("j").str.json_decode(), c("j").str.json_decode(
        plt.Struct(st)).alias("typed")), plj.DataFrame(texts).select(cj("j").str.json_decode(), cj("j").str.json_decode(
            plj.Struct({"a": plj.Int64, "b": plj.List(plj.Int64)})).alias("typed")), label="json_decode")

    # list.sample with replacement: each value from its list, the lengths,
    # the same draw for the same seed, an empty list asked for values raises
    lists = plt.DataFrame({"l": [[1, 2, 3], [4], None, [5, 6]]})
    draw = lists.select(c("l").list.sample(n=3, with_replacement=True, seed=7))["l"].to_list()
    assert draw == lists.select(c("l").list.sample(n=3, with_replacement=True, seed=7))["l"].to_list()
    for out, src in zip(draw, [[1, 2, 3], [4], None, [5, 6]]):
        assert (out is None) == (src is None) and (out is None or (len(out) == 3 and set(out) <= set(src)))
    frac = lists.select(c("l").list.sample(fraction=2.0, with_replacement=True, seed=1))["l"].to_list()
    assert [None if x is None else len(x) for x in frac] == [6, 2, None, 4]
    with pytest.raises(plt.ShapeError, match="empty list"):
        plt.DataFrame({"l": [[1], []]}).select(c("l").list.sample(n=1, with_replacement=True))

    # calendar intervals in the ranges per row
    days = {"a": [dtm.date(2023, 11, 15), dtm.date(2024, 2, 1), None], "b": [dtm.date(2024, 5, 20)] * 3}
    for iv in ("1mo", "2mo", "1y"):
        _assert_frames_match(plt.DataFrame(days).select(plt.date_ranges("a", "b", iv)),
                             plj.DataFrame(days).select(plj.date_ranges("a", "b", iv)), label=f"date_ranges {iv}")

    def months_from(start, end, k):
        out, i = [], 0
        while True:
            y, m = divmod(start.month - 1 + i * k, 12)
            y += start.year
            nxt = dtm.date(y, m + 1, min(start.day, [31, 29 if y % 4 == 0 and (y % 100 or y % 400 == 0) else 28, 31,
                                                         30, 31, 30, 31, 31, 30, 31, 30, 31][m]))
            if nxt > end:
                return out
            out.append(nxt)
            i += 1

    end31 = {"a": [dtm.date(2024, 1, 31), dtm.date(2023, 8, 31)], "b": [dtm.date(2024, 6, 30), dtm.date(2024, 3, 1)]}
    got = plt.DataFrame(end31).select(plt.date_ranges("a", "b", "1mo", closed="left"))["date_range"].to_list()
    assert got == [months_from(a, b, 1)[:-1] if months_from(a, b, 1)[-1] == b else months_from(a, b, 1)
                   for a, b in zip(end31["a"], end31["b"])]
    with pytest.raises(Exception):
        plj.DataFrame(end31).select(plj.date_ranges("a", "b", "1mo"))
    quarters = plt.DataFrame(days).select(plt.date_ranges("a", "b", "1q"))["date_range"].to_list()
    assert quarters == [None if a is None else months_from(a, b, 3) for a, b in zip(days["a"], days["b"])]
    # datetime_ranges with a time zone: days on the wall clock, hours in UTC
    from zoneinfo import ZoneInfo

    ny = ZoneInfo("America/New_York")
    w = {"a": [dtm.datetime(2024, 3, 8, 12)], "b": [dtm.datetime(2024, 3, 11, 12)]}
    out = plt.DataFrame(w).select(plt.datetime_ranges("a", "b", "1d", time_zone="America/New_York").alias("d"))
    assert out.schema["d"] == plt.List(plt.Datetime("us", "America/New_York"))
    assert out["d"].to_list()[0] == [dtm.datetime(2024, 3, d, 12, tzinfo=ny) for d in range(8, 12)]
    hours = plt.DataFrame(w).select(plt.datetime_ranges("a", "b", "36h", time_zone="America/New_York"))
    start = dtm.datetime(2024, 3, 8, 12, tzinfo=ny).astimezone(dtm.timezone.utc)
    end = dtm.datetime(2024, 3, 11, 12, tzinfo=ny).astimezone(dtm.timezone.utc)
    steps = [start + dtm.timedelta(hours=36 * j) for j in range(4)]
    assert hours.to_series().to_list()[0] == [t.astimezone(ny) for t in steps if t <= end]
    assert plj.DataFrame(w).select(plj.datetime_ranges("a", "b", "1d", time_zone="America/New_York")).to_series(
        ).dtype != out.schema["d"]

    # a user's function under a larger expression in a group-by
    def udf(col):
        return (col("v").map_batches(lambda s: s * 2) + 1).sum().alias("u")

    _assert_frames_match(ft.group_by("k", maintain_order=True).agg(udf(c), c("v").sum().alias("s")),
                         fj.group_by("k", maintain_order=True).agg(udf(cj), cj("v").sum().alias("s")), label="udf + 1")


def _check_nestkeys_phase_plans(scale: float = 0.002) -> None:
    """The plans of ``chip_smoke.py``'s ``nestkeys`` phase at a small scale,
    against the numpy oracle of ``testing/phases.py`` only: the reference
    groups, sorts and counts nested values by the word into their child
    (ROADMAP section 3)."""
    from polars_tpu_torch.testing import pdsh
    from polars_tpu_torch.testing import phases as P

    raw = pdsh.generate_pdsh(scale, tables=("orders", "lineitem"))
    line = plt.DataFrame({k: raw["lineitem"][k] for k in P.NESTKEYS_LINE_COLUMNS})
    orders = plt.DataFrame({k: raw["orders"][k] for k in P.NESTKEYS_ORDER_COLUMNS})
    want = P.nestkeys_oracle(raw["lineitem"], raw["orders"])
    for name, lf in P.nestkeys_plans(plt, line, orders).items():
        P.check_nestkeys(lf.collect(), want[name], f"nestkeys.{name}", floats=("rev", "qty"), lists=("modes",),
                         strings=("l_returnflag", "l_linestatus", "l_shipmode"))


def _check_zero_row_group_bys() -> None:
    """A sorted group-by (an integer key), ``over`` an integer key and
    ``group_by_dynamic`` over no rows (an empty frame, and a filter that
    keeps nothing) give an empty frame of the right schema through both
    packages; K1 is not called at capacity 0 (ROADMAP section 3, repaired)."""
    data = {"k": [1, 2], "i": [3, 4], "ts": [dtm.datetime(2024, 1, 1), dtm.datetime(2024, 1, 2)]}
    frames = {plt: plt.DataFrame(data), plj: plj.DataFrame(data)}
    for cut in (lambda pl, f: f.head(0).lazy(), lambda pl, f: f.lazy().filter(pl.col("k") > 5)):
        outs = {}
        for pl, frame in frames.items():
            c, src = pl.col, cut(pl, frame)
            outs[pl] = [src.group_by("k").agg(c("i").sum(), c("i").max().alias("mx"), pl.len(),
                                              c("i").mean().alias("m")).collect(),
                        src.with_columns(s=c("i").sum().over("k")).collect(),
                        src.group_by_dynamic("ts", every="1d").agg(c("i").sum()).collect()]
        for g, w in zip(outs[plt], outs[plj]):
            assert g.height == 0 == w.height and repr(g.schema) == repr(w.schema), (g.schema, w.schema)



_WORDS = ["apple", "Banana", "  pad me ", "héllo wörld", "a1b22c333", "xyz", "", "ÉCOLE", "x.y*z", "42", "-7",
          "0x1f", '{"a": {"b": 3}}', "AIR MAIL", "aaa", "dog cat dog"]
# the reference's faults that the strings differential holds to a Python oracle
_STRING_FAULTS = {
    "ib": "is_between of strings compares the column's codes with each bound's own one-entry dictionary "
          "(polars_tpu/engine/fn_core.py is_between over raw codes)",
    "shf": "shift(fill_value=) of a string drops the fill value (an empty string or the first value in its place)",
}


def _strings_frame(seed: int, n: int = 48) -> dict:
    rng = np.random.default_rng(seed)

    def pick():
        return [None if rng.random() < 0.12 else _WORDS[int(rng.integers(0, len(_WORDS)))] for _ in range(n)]

    return {"s": pick(), "t": pick(), "k": [str(x) for x in rng.choice(list("pqr"), n)],
            "i": rng.integers(-5, 9, n).tolist(),
            "b": [None if rng.random() < 0.1 else bytes(rng.integers(0, 256, int(rng.integers(0, 5))).tolist())
                  for _ in range(n)]}


def _string_exprs(pl) -> list:
    """Every ported ``str.`` function that maps one value to one."""
    s = pl.col("s").str
    return [s.len_chars().alias("lc"), s.len_bytes().alias("lb"), s.to_uppercase().alias("up"),
            s.to_lowercase().alias("lo"), s.to_titlecase().alias("ti"), s.reverse().alias("rev"),
            s.strip_chars().alias("st"), s.strip_chars_start(" a").alias("sts"), s.strip_chars_end("z ").alias("ste"),
            s.strip_prefix("a").alias("spre"), s.strip_suffix("e").alias("ssuf"), s.pad_start(8, "*").alias("ps"),
            s.pad_end(7).alias("pe"), s.zfill(5).alias("zf"), s.head(3).alias("hd"), s.tail(2).alias("tl"),
            s.slice(1, 3).alias("sl"), s.replace(r"\d", "#").alias("r1"),
            s.replace_all("a", "A", literal=True).alias("ra"),
            s.replace(r"(\w)(\d)", "$2$1").alias("rg"), s.replace_many(["a", "o"], ["0", "1"]).alias("rm"),
            s.extract(r"(\d+)", 1).alias("ex"), s.find("a", literal=True).alias("fi"), s.find(r"\d").alias("fr"),
            s.count_matches(r"[a-z]").alias("cm"), s.contains_any(["an", "og"]).alias("ca"),
            s.contains_any(["AIR", "xy"], ascii_case_insensitive=True).alias("cai"),
            s.normalize("NFD").str.len_chars().alias("nf"), s.escape_regex().alias("er"),
            s.json_path_match("$.a.b").alias("jp"), s.encode("hex").alias("eh"), s.encode("base64").alias("eb"),
            s.starts_with("a").alias("sw"), s.ends_with("z").alias("ew"), s.contains("o.*o").alias("co"),
            s.to_integer(strict=False).alias("int"), s.to_integer(base=16, strict=False).alias("hex")]


def _string_ops(pl) -> list:
    """Operators, order, casts and host functions over strings."""
    c = pl.col
    cat = c("s").cast(pl.Categorical)
    return [(c("s") + c("t")).alias("add"), (c("s") + "!").alias("addl"), (pl.lit("<") + c("t")).alias("laddr"),
            (c("s") < c("t")).alias("lt"), (c("s") >= "b").alias("ge"), c("s").is_between("a", "m").alias("ib"),
            c("s").min().alias("mn"), c("s").max().alias("mx"), c("s").arg_min().alias("amn"),
            c("s").arg_max().alias("amx"), c("s").rank("dense").alias("rk"), c("s").sort().alias("so"),
            cat.alias("cat"), cat.cat.len_bytes().alias("cat_lb"), cat.cat.starts_with("a").alias("cat_sw"),
            cat.cat.slice(0, 2).alias("cat_sl"), cat.cast(pl.String).alias("cat_s"),
            c("s").cast(pl.Enum(sorted(set(_WORDS)))).alias("enum"),
            c("s").cast(pl.Enum(sorted(set(_WORDS)))).to_physical().alias("enum_p"),
            pl.concat_str(["s", "t", "i"], separator="/").alias("cs"),
            pl.concat_str(["s", "t"], separator="-", ignore_nulls=True).alias("csn"),
            pl.format("<{}:{}>", "k", "i").alias("fmt"), c("s").fill_null(strategy="min").alias("fmin"),
            c("s").shift(2, fill_value="zz").alias("shf"), c("s").fill_null(strategy="backward").alias("fb"),
            pl.lit(None, dtype=pl.String).alias("nul")]


def _binary_exprs(pl) -> list:
    b = pl.col("b").bin
    return [b.size().alias("size"), b.contains(b"\x01").alias("has"), b.starts_with(b"\x00").alias("sw"),
            b.ends_with(b"\xff").alias("ew"), b.encode("hex").alias("hex"), b.encode("base64").alias("b64"),
            b.slice(1, 2).alias("sl"), b.head(1).alias("hd"), b.tail(1).alias("tl"), b.get(0).alias("g0"),
            b.encode("hex").str.decode("hex").alias("rt")]


def _string_oracle(name: str, s: list, t: list) -> list | None:
    """Python's answer for the names of ``_STRING_FAULTS``."""
    if name == "ib":
        return [None if v is None else "a" <= v <= "m" for v in s]
    if name == "shf":
        return ["zz", "zz", *s[:-2]]
    return None


def _check_strings_differential(lj, lt) -> None:
    """Every ported ``str.``, ``cat.`` and ``bin.`` function, the string
    operators, casts and host functions, over one seeded frame with nulls
    and non-ASCII text, through both packages: integer, string and key
    columns equal. The port runs it over sorted dictionaries and again over
    unordered ones (``ordinal_dict_max = 0``, every dictionary in order of
    first occurrence), where order-sensitive results must not change and a
    Categorical's physical codes follow that order. Where the reference is
    wrong (``_STRING_FAULTS``) the port is held to a Python oracle."""
    from polars_tpu_torch.config import config

    data = _strings_frame(3)
    fj = plj.DataFrame(data)
    # two selects (the reference recompiles a select around each of its host
    # functions) whose frames are compared whole (each select of a column
    # would compile a program)
    want_fns, want = fj.select(_string_exprs(plj)), fj.select(_string_ops(plj))
    apart = [*_STRING_FAULTS, "cat", "cat_s"]
    want_rest = want.drop(apart)
    wbin = fj.select(_binary_exprs(plj))
    groups_j = fj.group_by("k").agg(plj.col("s").min().alias("mn"), plj.col("t").max().alias("mx"),
                                    plj.col("s").str.join("|").alias("j"), plj.col("s").first()).sort("k")
    prev = config().ordinal_dict_max
    for limit in (prev, 0):
        config().ordinal_dict_max = limit
        try:
            ft = plt.DataFrame(data)
            assert ft["s"]._column.table.sorted_order == (limit > 0)
            _assert_frames_match(ft.select(_string_exprs(plt)), want_fns, label=f"str functions (limit {limit})")
            got = ft.select(_string_ops(plt))
            _assert_frames_match(got.drop(apart), want_rest, label=f"string operators (limit {limit})")
            for name in _STRING_FAULTS:
                oracle = _string_oracle(name, data["s"], data["t"])
                assert got[name].to_list() == oracle, name
                assert want[name].to_list() != oracle, (name, _STRING_FAULTS[name])
            for name in ("cat", "cat_s"):
                assert got[name].to_list() == data["s"] == want[name].to_list(), name
            # a Categorical's physical codes: its dictionary's, the sorted
            # values' ranks, or, unordered, the order of first occurrence
            seen = [v for v in dict.fromkeys(data["s"]) if v is not None]
            levels = sorted(seen) if limit else seen
            phys = ft.select(plt.col("s").cast(plt.Categorical).to_physical())["s"].to_list()
            assert phys == [None if v is None else levels.index(v) for v in data["s"]]
            if limit:
                assert phys == fj.select(plj.col("s").cast(plj.Categorical).to_physical())["s"].to_list()
            _assert_frames_match(ft.select(_binary_exprs(plt)), wbin, label="bin")
            groups = ft.group_by("k").agg(plt.col("s").min().alias("mn"), plt.col("t").max().alias("mx"),
                                          plt.col("s").str.join("|").alias("j"), plt.col("s").first()).sort("k")
            _assert_frames_match(groups, groups_j, label=f"string aggregations (limit {limit})")
            assert ft.sort("s", "i")["s"].to_list() == fj.sort("s", "i")["s"].to_list()
            cats = ft.select(plt.col("s").cast(plt.Categorical).cat.get_categories())["s"].to_list()
            assert sorted(cats) == sorted(seen) and (cats == seen or limit)
        finally:
            config().ordinal_dict_max = prev
    # the casts: an Enum from text (strict raises through the segment's
    # read), back to text; the string key of the shared frames joined by +
    e = plt.Enum(["p", "q"])
    with pytest.raises(plt.InvalidOperationError, match="strict cast"):
        plt.DataFrame(data).select(plt.col("k").cast(e))
    assert plt.DataFrame(data).select(plt.col("k").cast(e, strict=False))["k"].to_list() == \
        [None if v == "r" else v for v in data["k"]]
    out = lt.select((plt.col("g") + plt.col("s")).alias("gs"), plt.concat_str(["g", "i64"], separator=":").alias("c"))
    g, s, i = lt["g"].to_list(), lt["s"].to_list(), lt["i64"].to_list()
    assert out["gs"].to_list() == [None if a is None or b is None else a + b for a, b in zip(g, s)]
    assert out["c"].to_list() == [None if a is None or b is None else f"{a}:{b}" for a, b in zip(g, i)]
    assert lj.select(plj.col("g") + plj.col("s"))["g"].to_list() == out["gs"].to_list()

# -- windows, order and position functions ------------------------------------------------


def _ffill(xs: list, limit=None) -> list:
    out, last, gap = [], None, 0
    for x in xs:
        if x is not None:
            last, gap = x, 0
            out.append(x)
        else:
            gap += 1
            out.append(last if last is not None and (limit is None or gap <= limit) else None)
    return out


def _interp(xs: list, nearest: bool) -> list:
    idx = [i for i, x in enumerate(xs) if x is not None]
    out = []
    for i, x in enumerate(xs):
        if x is not None:
            out.append(x if nearest else float(x))
            continue
        p = max((j for j in idx if j < i), default=None)
        q = min((j for j in idx if j > i), default=None)
        if p is None or q is None:
            out.append(None)
        elif nearest:
            out.append(xs[p] if (i - p) / (q - p) < 0.5 else xs[q])
        else:
            out.append(xs[p] + (xs[q] - xs[p]) * ((i - p) / (q - p)))
    return out


def _order_key(x, desc: bool, nulls_last: bool):
    """A sort key of one value: nulls first (or last) whatever ``desc``."""
    if x is None:
        return (1 if nulls_last else -1, 0)
    if isinstance(x, float) and math.isnan(x):
        x = math.inf * 2  # NaN is greatest
    return (0, -x if desc else x)


def _rank(xs: list, method: str, desc: bool) -> list:
    vals = sorted((i for i, x in enumerate(xs) if x is not None), key=lambda i: _order_key(xs[i], desc, True))
    out = [None] * len(xs)
    pos = 0
    dense = 0
    while pos < len(vals):
        run = [vals[pos]]
        while pos + len(run) < len(vals) and _order_key(xs[vals[pos + len(run)]], desc, True) == _order_key(
                xs[vals[pos]], desc, True):
            run.append(vals[pos + len(run)])
        dense += 1
        for k, i in enumerate(run):
            out[i] = {"average": pos + (len(run) + 1) / 2, "min": pos + 1, "max": pos + len(run),
                      "dense": dense, "ordinal": pos + k + 1}[method]
        pos += len(run)
    return out


def _cum(xs: list, op, reverse: bool) -> list:
    seq = xs[::-1] if reverse else xs
    out, acc = [], None
    for x in seq:
        if x is not None:
            acc = x if acc is None else op(acc, x)
        out.append(None if x is None else acc)
    return out[::-1] if reverse else out


def _flags(xs: list, kind: str) -> list:
    def key(x):
        return ("nan",) if isinstance(x, float) and math.isnan(x) else (x,)

    counts: dict = {}
    for x in xs:
        counts[key(x)] = counts.get(key(x), 0) + 1
    seen, out = set(), []
    for i, x in enumerate(xs):
        k = key(x)
        first, last = k not in seen, key(x) not in {key(y) for y in xs[i + 1:]}
        seen.add(k)
        out.append({"dup": counts[k] > 1, "uniq": counts[k] == 1, "first": first, "last": last}[kind])
    return out


def _peak(xs: list, is_max: bool) -> list:
    out = []
    for i, x in enumerate(xs):
        prev = xs[i - 1] if i > 0 else 0
        nxt = xs[i + 1] if i + 1 < len(xs) else 0
        sides = []
        for other in (prev, nxt):
            sides.append(None if x is None or other is None else (other < x if is_max else other > x))
        if False in sides:
            out.append(False)
        elif None in sides:
            out.append(None)
        else:
            out.append(True)
    return out


def _nan_min(a, b):
    """``min`` where a NaN carries on, as the reference's running minimum."""
    return a if a != a else (b if b != b or b < a else a)


def _nan_max(a, b):
    return a if a != a else (b if b != b or b > a else a)


def _fill_stat(xs: list, how: str) -> list:
    vals = [x for x in xs if x is not None]
    if not vals:
        return list(xs)
    numbers = [x for x in vals if x == x]  # NaN is the greatest value: a min skips it, a max is it
    fill = {"min": min(numbers) if numbers else math.nan,
            "max": math.nan if len(numbers) < len(vals) else max(vals)}.get(how)
    if how == "mean":
        m = sum(vals) / len(vals)
        fill = m if isinstance(vals[0], float) else int(m)
    return [fill if x is None else x for x in xs]


def _pct(xs: list) -> list:
    f = _ffill(xs)
    out = [None]
    for a, b in zip(f[1:], f[:-1]):
        if a is None or b is None:
            out.append(None)
        elif a != a or b != b:
            out.append(math.nan)
        elif b == 0:
            out.append(math.nan if a == 0 else math.copysign(math.inf, a))
        else:
            out.append(a / b - 1.0)
    return out


def _sorted_by(xs: list, keys: list, desc: list, nl: list) -> list:
    order = sorted(range(len(xs)), key=lambda i: tuple(_order_key(k[i], d, n) for k, d, n in zip(keys, desc, nl)))
    return order


def _position_cases(pl) -> dict:
    """name -> (expression, the oracle over one segment: (columns of the
    segment's rows) -> values)."""
    c = pl.col

    def sh(xs, n, fill=None):
        return [xs[i - n] if 0 <= i - n < len(xs) else fill for i in range(len(xs))]

    def diff(xs, n):
        return [xs[i] - xs[i - n] if 0 <= i - n < len(xs) and xs[i] is not None and xs[i - n] is not None else None
                for i in range(len(xs))]

    return {
        "shift": (c("x").shift(1), lambda s: sh(s["x"], 1)),
        "shift_neg": (c("x").shift(-2), lambda s: sh(s["x"], -2)),
        "shift_fill": (c("x").shift(1, fill_value=100), lambda s: sh(s["x"], 1, 100)),
        "diff": (c("x").diff(), lambda s: diff(s["x"], 1)),
        "diff2": (c("f").diff(2), lambda s: diff(s["f"], 2)),
        "pct": (c("f").pct_change(), lambda s: _pct(s["f"])),
        "rank_avg": (c("x").rank(), lambda s: _rank(s["x"], "average", False)),
        "rank_min": (c("x").rank("min"), lambda s: _rank(s["x"], "min", False)),
        "rank_max": (c("x").rank("max"), lambda s: _rank(s["x"], "max", False)),
        "rank_dense": (c("f").rank("dense", descending=True), lambda s: _rank(s["f"], "dense", True)),
        "rank_ord": (c("x").rank("ordinal"), lambda s: _rank(s["x"], "ordinal", False)),
        # ties broken by a seeded hash of the row: held to the reference alone
        "rank_rand": (c("x").rank("random", seed=3), None),
        "arg_sort": (c("x").arg_sort(), lambda s: _sorted_by(s["x"], [s["x"]], [False], [False])),
        "arg_sort_dn": (c("f").arg_sort(descending=True, nulls_last=True),
                        lambda s: _sorted_by(s["f"], [s["f"]], [True], [True])),
        "arg_sort_by": (pl.arg_sort_by(["p", "x"]), lambda s: _sorted_by(s["x"], [s["p"], s["x"]], [False] * 2,
                                                                        [False] * 2)),
        "cum_sum": (c("x").cum_sum(), lambda s: _cum(s["x"], lambda a, b: a + b, False)),
        "cum_sum_f": (c("f").cum_sum(), lambda s: _cum(s["f"], lambda a, b: a + b, False)),
        "cum_prod": (c("x").cum_prod(), lambda s: _cum(s["x"], lambda a, b: a * b, False)),
        "cum_min": (c("f").cum_min(), lambda s: _cum(s["f"], _nan_min, False)),
        "cum_max": (c("x").cum_max(reverse=True), lambda s: _cum(s["x"], _nan_max, True)),
        "cum_max_f": (c("f").cum_max(), lambda s: _cum(s["f"], _nan_max, False)),
        "cum_count": (c("x").cum_count(), lambda s: _cum([int(x is not None) for x in s["x"]],
                                                          lambda a, b: a + b, False)),
        "cum_count_rev": (c("f").cum_count(reverse=True),
                          lambda s: _cum([int(x is not None) for x in s["f"]], lambda a, b: a + b, True)),
        "reverse": (c("x").reverse(), lambda s: s["x"][::-1]),
        "ffill": (c("x").forward_fill(), lambda s: _ffill(s["x"])),
        "bfill": (c("f").backward_fill(), lambda s: _ffill(s["f"][::-1])[::-1]),
        "ffill_lim": (c("f").forward_fill(limit=1), lambda s: _ffill(s["f"], 1)),
        "fn_bwd_lim": (c("x").fill_null(strategy="backward", limit=1), lambda s: _ffill(s["x"][::-1], 1)[::-1]),
        "fn_min": (c("f").fill_null(strategy="min"), lambda s: _fill_stat(s["f"], "min")),
        "fn_max": (c("x").fill_null(strategy="max"), lambda s: _fill_stat(s["x"], "max")),
        "fn_mean": (c("x").fill_null(strategy="mean"), lambda s: _fill_stat(s["x"], "mean")),
        "fn_zero": (c("f").fill_null(strategy="zero"), lambda s: [0.0 if x is None else x for x in s["f"]]),
        "interp": (c("x").interpolate(), lambda s: _interp(s["x"], False)),
        "interp_f": (c("f").interpolate(), lambda s: _interp(s["f"], False)),
        "interp_near": (c("x").interpolate("nearest"), lambda s: _interp(s["x"], True)),
        "is_dup": (c("x").is_duplicated(), lambda s: _flags(s["x"], "dup")),
        "is_uniq": (c("g").is_unique(), lambda s: _flags(s["g"], "uniq")),
        "first_d": (c("x").is_first_distinct(), lambda s: _flags(s["x"], "first")),
        "last_d": (c("f").is_last_distinct(), lambda s: _flags(s["f"], "last")),
        "peak_min": (c("x").peak_min(), lambda s: _peak(s["x"], False)),
        "peak_max": (c("f").peak_max(), lambda s: _peak(s["f"], True)),
        "sort": (c("x").sort(), lambda s: [s["x"][i] for i in _sorted_by(s["x"], [s["x"]], [False], [False])]),
        "sort_dn": (c("f").sort(descending=True, nulls_last=True),
                    lambda s: [s["f"][i] for i in _sorted_by(s["f"], [s["f"]], [True], [True])]),
        "sort_by": (c("x").sort_by("f"), lambda s: [s["x"][i] for i in _sorted_by(s["x"], [s["f"]], [False],
                                                                                   [False])]),
        "sort_by2": (c("f").sort_by(["p", "x"], descending=[True, False]),
                     lambda s: [s["f"][i] for i in _sorted_by(s["f"], [s["p"], s["x"]], [True, False],
                                                               [False, False])]),
    }


def _position_oracle(rows: dict, oracle, ctx: str) -> list:
    """The oracle over the kept rows ``rows`` (columns of Python values):
    per group of ``g`` (null one group) in ``t`` order under ``over``."""
    n = len(rows["x"])
    if ctx == "plain":
        groups = [list(range(n))]
    else:
        keys: dict = {}
        for i, k in enumerate(rows["g"]):
            keys.setdefault(k, []).append(i)
        groups = list(keys.values())
        if ctx == "over_t":
            groups = [sorted(ix, key=lambda i: rows["t"][i]) for ix in groups]
    out = [None] * n
    for ix in groups:
        for i, v in zip(ix, oracle({k: [col[i] for i in ix] for k, col in rows.items()})):
            out[i] = v
    return out


# the reference's faults (ROADMAP section 3): (case, context, filtered)
# -> where the JAX package is wrong; there the port is held to the oracle only
_MASKED = ("fn_position.py:56-60: without over(), a position function runs over the padded rows, so a row the "
           "filter dropped still counts")
_ORDER_BY = ("over(order_by=) is ignored: compiler.py:1272-1293 (_grouped_reorder) sorts into row order, "
             "fn_position.py:306 (reverse), :451 (rank's ties), fn_core.py:340-381 (distinct flags)")
_ARGSORT = "fn_position.py:541-558, :901-923: arg_sort and arg_sort_by ignore the window's groups"
_PCT = "fn_position.py:207-225: pct_change forward-fills no null and nulls a zero before"
_FILL_MIN = ("fn_position.py:1094-1095: without over(), fill_null(strategy='min') takes a minimum that a NaN "
             "poisons, where min() skips NaN")
_SORT_MASKED = "compiler.py:1303-1308: sort() without over() puts the values in the first padded rows, not the kept"
_ARGSORT_MASKED = "fn_position.py:541-558, :901-923: arg_sort and arg_sort_by give positions among the padded rows"
_MASKED_FNS = ("shift", "shift_neg", "shift_fill", "diff", "diff2", "ffill", "bfill", "ffill_lim", "fn_bwd_lim",
               "interp", "interp_f", "interp_near")


def _position_fault(case: str, ctx: str, filtered: bool) -> str | None:
    if case == "pct":
        return _PCT
    if case == "fn_min" and ctx == "plain":
        return _FILL_MIN
    if case.startswith("arg_sort") and ctx != "plain":
        return _ARGSORT
    if ctx == "over_t" and case in ("sort", "sort_dn", "sort_by", "sort_by2", "reverse", "first_d", "last_d",
                                    "rank_ord"):
        return _ORDER_BY
    if ctx == "plain" and filtered:
        if case in _MASKED_FNS:
            return _MASKED
        if case.startswith("sort"):
            return _SORT_MASKED
        if case.startswith("arg_sort"):
            return _ARGSORT_MASKED
    return None


def _values_match(got: list, want: list) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g is None or w is None:
            if g is not w:
                return False
        elif isinstance(g, float) or isinstance(w, float):
            g, w = float(g), float(w)
            if not (g == w or (math.isnan(g) and math.isnan(w)) or abs(g - w) <= 1e-9 * max(abs(g), abs(w))):
                return False
        elif g != w:
            return False
    return True


def _position_frame(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)

    def nulls(values):
        return [None if z else v for z, v in zip(rng.random(n) < 0.15, values)]

    f = rng.normal(size=n).round(2).tolist()
    if n > 3:
        f[1], f[2] = 0.0, math.nan
    return {"g": nulls([str(x) for x in np.asarray(list("abc"))[rng.integers(0, 3, n)]]),
            "t": rng.permutation(n).tolist(), "x": nulls(rng.integers(-5, 6, n).tolist()),
            "f": nulls(f), "p": rng.integers(0, 3, n).tolist()}


_POSITION_SCHEMA = {"g": "String", "t": "Int64", "x": "Int64", "f": "Float64", "p": "Int64"}
_POSITION_FRAMES = ((5, 40), (6, 23), (7, 0))  # (seed, rows); the first also through the reference


def _check_window_position_differential(frames=_POSITION_FRAMES, filters=(False, True)) -> None:
    """Every order and position function, without ``over``, with it and
    with ``over(order_by=)``, each with and without a filter before it,
    through the port and a Python oracle of Polars' semantics over
    ``frames`` of ``_POSITION_FRAMES``, as written and filtered
    (``filters``), and for the first frame through the reference too (one
    select per filter), but where it is wrong (``_position_fault``). The probes of the reference's
    faults are among the cases (the reference's probes are
    :func:`_check_position_probes`, the expression-level sort, filter,
    slice and gather :func:`_check_sort_filter_slice_gather`)."""
    schema = _POSITION_SCHEMA
    contexts = ("plain", "over", "over_t")

    def exprs(pl):
        out = []
        for ctx in contexts:
            for case, (e, _) in _position_cases(pl).items():
                e = e if ctx == "plain" else e.over("g", order_by="t" if ctx == "over_t" else None)
                out.append(e.alias(f"{case}:{ctx}"))
        return out

    for seed, n in frames:
        data = _position_frame(seed, n)
        lt = plt.DataFrame(data, schema={k: getattr(plt, d) for k, d in schema.items()}).lazy()
        lj = plj.DataFrame(data, schema={k: getattr(plj, d) for k, d in schema.items()}).lazy()
        for filtered in filters:
            keep = [p != 0 for p in data["p"]] if filtered else [True] * n
            rows = {k: [v for v, kp in zip(col, keep) if kp] for k, col in data.items()}
            t = lt.filter(plt.col("p") != 0) if filtered else lt
            got = t.select(exprs(plt)).collect()
            ref = None
            if (seed, n) == _POSITION_FRAMES[0]:
                ref = (lj.filter(plj.col("p") != 0) if filtered else lj).select(exprs(plj)).collect()
            for ctx in contexts:
                for case, (_, oracle) in _position_cases(plt).items():
                    name, label = f"{case}:{ctx}", f"{case} {ctx} filtered={filtered} n={n}"
                    g = got[name].to_list()
                    if oracle is not None:
                        assert _values_match(g, _position_oracle(rows, oracle, ctx)), (label, g)
                    if ref is not None and _position_fault(case, ctx, filtered) is None:
                        assert repr(got[name].dtype) == repr(ref[name].dtype), label
                        assert _values_match(g, ref[name].to_list()), (label, g, ref[name].to_list())


def _rolling_frame(seed: int, n: int) -> dict:
    """A group key, a sorted integer index with ties (and a Datetime one), a
    Float64 with nulls and a NaN, a Float64 without nulls that has ties (so
    that weights apply and ranks tie), an Int64 with nulls."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 3 * n, n)).tolist()
    x = [None if z else float(v) for z, v in zip(rng.random(n) < 0.2, np.round(rng.normal(5, 3, n), 3))]
    if n:
        x[n // 2] = float("nan")
    return {"g": [str(v) for v in np.asarray(list("abc"))[rng.integers(0, 3, n)]], "t": t,
            "ts": [dtm.datetime(2024, 3, 1) + dtm.timedelta(minutes=3 * v) for v in t], "x": x,
            "y": np.round(rng.normal(10, 4, n)).tolist(),
            "i": [None if z else int(v) for z, v in zip(rng.random(n) < 0.2, rng.integers(-50, 50, n))]}


_W = [0.5, 1.0, 2.0]


def _rolling_cases(pl) -> dict:
    """Row windows, time windows over an integer and a Datetime index (every
    ``closed``), EWMs, ``interpolate_by`` and ``cumulative_eval``, plain and
    per group."""
    c, e = pl.col, pl.element()
    cases = {
        "sum3": c("y").rolling_sum(3), "mean4_m2": c("y").rolling_mean(4, min_samples=2),
        "min3_c": c("y").rolling_min(3, center=True), "max5_m1": c("x").rolling_max(5, min_samples=1),
        "std4": c("y").rolling_std(4), "var3_d0": c("x").rolling_var(3, ddof=0, min_samples=2),
        "sum_x": c("x").rolling_sum(3, min_samples=1), "mean_x_c": c("x").rolling_mean(4, min_samples=1, center=True),
        "isum": c("i").rolling_sum(3, min_samples=1), "imax": c("i").rolling_max(2),
        "wsum": c("y").rolling_sum(3, weights=_W), "wmean": c("y").rolling_mean(3, weights=_W, min_samples=1),
        "wvar": c("y").rolling_var(3, weights=_W), "wstd_c": c("y").rolling_std(3, weights=_W, center=True),
        "wmin": c("y").rolling_min(3, weights=_W), "wmax": c("y").rolling_max(3, weights=_W, min_samples=1),
        "wmed": c("y").rolling_median(3, weights=_W), "wq": c("y").rolling_quantile(0.4, "linear", 3, weights=_W),
        "wmed_m1": c("y").rolling_median(3, weights=_W, min_samples=1),
        "med3": c("x").rolling_median(3, min_samples=1), "q_lin": c("y").rolling_quantile(0.3, "linear", 4),
        "q_near_c": c("y").rolling_quantile(0.7, "nearest", 3, center=True),
        "q_low": c("y").rolling_quantile(0.5, "lower", 4, min_samples=2),
        "q_high": c("y").rolling_quantile(0.5, "higher", 4), "q_mid": c("y").rolling_quantile(0.5, "midpoint", 4),
        "r_avg": c("y").rolling_rank(3), "r_min": c("y").rolling_rank(4, method="min"),
        "r_max": c("y").rolling_rank(4, method="max", min_samples=2),
        "r_dense": c("y").rolling_rank(4, method="dense"), "r_ord": c("y").rolling_rank(3, method="ordinal"),
        "r_desc": c("y").rolling_rank(3, descending=True),
        "skew": c("y").rolling_skew(4), "skew_u": c("y").rolling_skew(5, bias=False),
        "kurt": c("y").rolling_kurtosis(5),
        "ewm": c("x").ewm_mean(alpha=0.3), "ewm_noadj": c("x").ewm_mean(alpha=0.3, adjust=False),
        "ewm_ign": c("x").ewm_mean(com=2.0, ignore_nulls=True, min_samples=2),
        "ewm_var": c("x").ewm_var(alpha=0.4), "ewm_var_b": c("x").ewm_var(alpha=0.4, bias=True, adjust=False),
        "ewm_std": c("x").ewm_std(span=4.0, ignore_nulls=True), "ewm_sum": c("x").ewm_sum(alpha=0.5),
        "ewm_sum_ign": c("x").ewm_sum(alpha=0.5, ignore_nulls=True, min_samples=2),
        "ewm_hl": c("y").ewm_mean(half_life=3.0),
        "ewm_by": c("y").ewm_mean_by("t", half_life="3i"), "ewm_sum_by": c("x").ewm_sum_by("ts", half_life="10m"),
        "interp_by": c("x").interpolate_by("t"),
        "ce_sum": c("i").cumulative_eval(e.sum()), "ce_min": c("x").cumulative_eval(e.min()),
        "ce_mean": c("i").cumulative_eval(e.mean()), "ce_max3": c("y").cumulative_eval(e.max(), min_samples=3),
    }
    for closed in ("right", "left", "both", "none"):
        cases[f"sum_by_{closed}"] = c("x").rolling_sum_by("t", "4i", closed=closed, min_samples=2)
        cases[f"mean_ts_{closed}"] = c("y").rolling_mean_by("ts", "10m", closed=closed)
    cases.update({
        "std_by": c("y").rolling_std_by("t", "5i"), "var_by_d0": c("x").rolling_var_by("ts", "12m", ddof=0),
        "min_by": c("x").rolling_min_by("t", "3i"), "max_by": c("i").rolling_max_by("t", "6i", min_samples=2),
        "isum_by": c("i").rolling_sum_by("ts", "9m"),
        "expr_rolling": c("y").sum().rolling(index_column="ts", period="15m"),
        "expr_rolling_std": c("x").std().rolling(index_column="t", period="4i", closed="both"),
    })
    out = [v.alias(k) for k, v in cases.items()]
    for name in ("mean4_m2", "max5_m1", "var3_d0", "isum", "med3", "r_avg", "ewm", "ewm_var", "ewm_sum_ign",
                 "ewm_by", "ce_sum", "ce_mean", "interp_by", "sum_by_both", "std_by", "mean_ts_left", "max_by"):
        out.append(cases[name].over("g").alias(f"{name}:g"))
    return out


def _window_values(rows: dict, col: str, members: list[int]) -> list:
    return [rows[col][j] for j in members if rows[col][j] is not None]


def _time_window_oracle(rows: dict, col: str, by: str, period, closed: str, minp: int, fn, grouped: bool) -> list:
    """Each row's window ``(t - period, t]`` (``closed`` says which ends
    belong) of its group, ``fn`` of its non-null values (None below
    ``minp``)."""
    out = []
    for i, t in enumerate(rows[by]):
        lo_ok = (lambda u: u >= t - period) if closed in ("left", "both") else (lambda u: u > t - period)
        hi_ok = (lambda u: u <= t) if closed in ("right", "both") else (lambda u: u < t)
        members = [j for j, u in enumerate(rows[by])
                   if lo_ok(u) and hi_ok(u) and (not grouped or rows["g"][j] == rows["g"][i])]
        vals = _window_values(rows, col, members)
        out.append(fn(vals) if len(vals) >= max(minp, 1) and vals else None)
    return out


def _var(vals: list, ddof: int):
    if len(vals) <= ddof:
        return None
    if any(math.isnan(v) for v in vals):
        return float("nan")
    m = math.fsum(vals) / len(vals)
    return math.fsum((v - m) ** 2 for v in vals) / (len(vals) - ddof)


def _interp_by_oracle(rows: dict) -> list:
    """x interpolated linearly by t between the non-null neighbours of its
    group, in t order."""
    out = list(rows["x"])
    for g in set(rows["g"]):
        idx = sorted((j for j in range(len(out)) if rows["g"][j] == g), key=lambda j: rows["t"][j])
        known = [j for j in idx if rows["x"][j] is not None]
        for j in idx:
            if rows["x"][j] is not None:
                continue
            before = [k for k in known if idx.index(k) < idx.index(j)]
            after = [k for k in known if idx.index(k) > idx.index(j)]
            if before and after:
                a, b = before[-1], after[0]
                t0, t1 = rows["t"][a], rows["t"][b]
                frac = (rows["t"][j] - t0) / (t1 - t0) if t1 != t0 else 0.0
                out[j] = rows["x"][a] + (rows["x"][b] - rows["x"][a]) * frac
    return out


def _centered_mean_oracle(rows: dict) -> list:
    """``x.rolling_mean(4, min_samples=1, center=True)``: rows i - 2 to
    i + 1."""
    n = len(rows["x"])
    return [(lambda v: math.fsum(v) / len(v) if v else None)(_window_values(rows, "x", range(max(i - 2, 0),
                                                                                             min(i + 2, n))))
            for i in range(n)]


def _weighted_median_oracle(rows: dict) -> list:
    """``y.rolling_median(3, weights=_W, min_samples=1)``: StatsBase's
    weighted quantile (the reference's ``compute_wq``) of each window, a
    window the frame's start cuts with the weights' tail and their own
    sum."""
    out = []
    for i in range(len(rows["y"])):
        vals = rows["y"][max(i - 2, 0): i + 1]
        buf = sorted(zip(vals, _W[len(_W) - len(vals):]), key=lambda p: p[0])
        h = 0.5 * (sum(w for _, w in buf) - buf[0][1]) + buf[0][1]
        s = s_old = vk = v_old = 0.0
        for v, w in buf:
            if s > h:
                break
            s_old, v_old, vk = s, vk, v
            s += w
        out.append(v_old if h == s_old else v_old + (h - s_old) / (s - s_old) * (vk - v_old))
    return out


def _fsum(vals: list):
    return float("nan") if any(math.isnan(v) for v in vals) else math.fsum(vals)


# the cases where the reference is wrong, each held to a Python oracle of
# Polars' semantics instead (ROADMAP section 3): a NaN poisons the JAX
# package's prefix sums for every later time window
# (``polars_tpu/engine/rolling.py:79-97``); its one-pass variance of a
# window of one value with ddof=0 is not 0 (``:99-104``); a centred window
# drops what lies ahead of the first rows (``fn_position.py:620-625``,
# ``_inb``); ``interpolate_by`` ignores ``over`` (``fn_position.py:1023``);
# a weighted median of a window the frame's start cuts takes every weight's
# sum (``fn_position.py:1207-1229``)
_ROLLING_FAULTS = {
    **{f"sum_by_{cl}": lambda r, cl=cl: _time_window_oracle(r, "x", "t", 4, cl, 2, _fsum, False)
       for cl in ("right", "left", "both", "none")},
    "sum_by_both:g": lambda r: _time_window_oracle(r, "x", "t", 4, "both", 2, _fsum, True),
    "var_by_d0": lambda r: _time_window_oracle(r, "x", "ts", dtm.timedelta(minutes=12), "right", 1,
                                               lambda v: _var(v, 0), False),
    "expr_rolling_std": lambda r: _time_window_oracle(r, "x", "t", 4, "both", 1,
                                                      lambda v: None if _var(v, 1) is None else math.sqrt(_var(v, 1)),
                                                      False),
    "mean_x_c": _centered_mean_oracle,
    "wmed_m1": _weighted_median_oracle,
    "interp_by:g": _interp_by_oracle,
}


def _host_rolling_cases(pl) -> list:
    """The median, quantile and rank over time windows: host functions, in
    a select of their own (a select that calls one runs each of its other
    expressions apart in the reference, a compile each)."""
    c = pl.col
    return [c("x").rolling_median_by("t", "4i").alias("med_by"),
            c("y").rolling_quantile_by("t", "5i", quantile=0.25, interpolation="linear").alias("q_by"),
            c("y").rolling_rank_by("t", "5i", method="min").alias("rank_by")]


_ROLLING_SCHEMA = {"g": "String", "t": "Int64", "ts": "Datetime", "x": "Float64", "y": "Float64", "i": "Int64"}


def _rolling_frames(seed: int, n: int):
    data = _rolling_frame(seed, n)
    return (data, plt.DataFrame(data, schema={k: getattr(plt, d) for k, d in _ROLLING_SCHEMA.items()}),
            plj.DataFrame(data, schema={k: getattr(plj, d) for k, d in _ROLLING_SCHEMA.items()}))


_ROLLING_FRAMES = ((21, 37), (22, 12), (23, 0))  # (seed, rows); every fault shows on the first


def _check_host_rolling_differential() -> None:
    """``_host_rolling_cases`` (the rolling functions the port runs on the
    host) in one select per frame through both packages, over the three
    frames of :func:`_check_rolling_differential`."""
    for seed, n in _ROLLING_FRAMES:
        _, lt, lj = _rolling_frames(seed, n)
        _assert_frames_match(lt.select(_host_rolling_cases(plt)), lj.select(_host_rolling_cases(plj)),
                             label=f"rolling on the host n={n}")


def _check_rolling_differential(frames=_ROLLING_FRAMES) -> None:
    """``_rolling_cases`` in one wide select per frame through both packages
    (``frames`` of ``_ROLLING_FRAMES``: three, one with no rows), but where
    the reference is wrong (``_ROLLING_FAULTS``: there a Python oracle, and
    on the first frame, where each fault shows, the reference must still
    differ from it). The dynamic and rolling group-bys are
    :func:`_check_dynamic_differential`."""
    for seed, n in frames:
        data, lt, lj = _rolling_frames(seed, n)
        ref_wrong = dict.fromkeys(_ROLLING_FAULTS, False)
        got, want = lt.lazy().select(_rolling_cases(plt)).collect(), lj.lazy().select(_rolling_cases(plj)).collect()
        faults = list(_ROLLING_FAULTS)
        _assert_frames_match(got.drop(faults), want.drop(faults), label=f"rolling n={n}")
        for name, oracle in _ROLLING_FAULTS.items():
            expect = oracle(data)
            assert _values_match(got[name].to_list(), expect), (name, n, got[name].to_list(), expect)
            ref_wrong[name] |= not _values_match(want[name].to_list(), expect)
        assert (seed, n) != _ROLLING_FRAMES[0] or all(ref_wrong.values()), ref_wrong


def _dynamic_cases(pl) -> list:
    c = pl.col
    return [
        ("calendar", lambda lf: lf.group_by_dynamic("d", every="1mo", label="right", include_boundaries=True).agg(
            c("y").sum().alias("s"), pl.len().alias("n"))),
        ("quarter_groups", lambda lf: lf.group_by_dynamic("d", every="1q", group_by="g").agg(c("x").mean())),
        ("fixed_overlap", lambda lf: lf.group_by_dynamic("ts", every="2h", period="5h", closed="right").agg(
            c("y").max().alias("mx"), c("x").count().alias("cnt"))),
        ("datapoint", lambda lf: lf.group_by_dynamic("ts", every="3h", label="datapoint", start_by="datapoint",
                                                     group_by="g").agg(c("y").first().alias("f"))),
        ("offset_bounds", lambda lf: lf.group_by_dynamic("ts", every="1d", offset="-6h", include_boundaries=True)
         .agg(c("i").sum().alias("si"))),
        ("int_index", lambda lf: lf.group_by_dynamic("t", every="5i", period="8i", group_by="g").agg(
            c("y").mean().alias("m"), pl.len())),
        ("rolling", lambda lf: lf.rolling("ts", period="3h", group_by="g").agg(
            c("y").sum().alias("s"), c("x").mean().alias("m"), c("y").min().alias("lo"), c("x").max().alias("hi"),
            c("x").count().alias("n"), pl.len(), c("y").first().alias("f"), c("y").last().alias("l"),
            c("x").std().alias("sd"), c("y").var().alias("v"))),
        ("rolling_offset", lambda lf: lf.rolling("t", period="6i", offset="-2i", closed="both").agg(
            c("i").sum().alias("s"), c("y").max().alias("mx"))),
        ("rolling_left", lambda lf: lf.rolling("ts", period="2h", closed="left").agg(c("y").mean().alias("m"))),
    ]


def _check_dynamic_differential() -> None:
    """The dynamic and rolling group-bys through both packages: calendar
    and fixed windows, ``label``, ``closed``, ``include_boundaries``,
    ``offset``, ``start_by="datapoint"``, an integer index, groups;
    ``LazyFrame.rolling`` with ``offset``, ``closed`` and groups."""
    rng = np.random.default_rng(31)
    n = 60
    minutes = np.sort(rng.integers(0, 60 * 24 * 200, n))
    data = {"ts": [dtm.datetime(2023, 11, 20) + dtm.timedelta(minutes=int(m)) for m in minutes],
            "d": [dtm.date(2023, 11, 20) + dtm.timedelta(days=int(m) // 1440) for m in minutes],
            "t": np.sort(rng.integers(0, 100, n)).tolist(), "g": [str(v) for v in rng.choice(list("pq"), n)],
            "x": [None if z else float(v) for z, v in zip(rng.random(n) < 0.2, np.round(rng.normal(0, 2, n), 2))],
            "y": np.round(rng.normal(3, 1, n), 2).tolist(), "i": rng.integers(-9, 9, n).tolist()}
    lt, lj = plt.DataFrame(data).lazy(), plj.DataFrame(data).lazy()
    for (label, qt), (_, qj) in zip(_dynamic_cases(plt), _dynamic_cases(plj)):
        _assert_frames_match(qt(lt).collect(), qj(lj).collect(), label=label)
    assert plt.DataFrame(data).group_by_dynamic("t", every="10i").agg(plt.len()).height == 10


def _resizing_cases(pl) -> list:
    """(label, query of a LazyFrame): the expression-level sort, filter,
    slice and gather in a select, where they change the column's length,
    and under a group-by's aggregations."""
    c = pl.col
    return [
        ("head_tail_slice", lambda lf: lf.select(c("x").head(7), c("f").tail(7).alias("t7"),
                                                 c("t").slice(3, 7).alias("s"))),
        ("top_bottom_k", lambda lf: lf.select(c("x").top_k(5), c("f").bottom_k(5).alias("b"),
                                              c("x").sort().head(5).alias("sh"))),
        ("drop_filter", lambda lf: lf.select(c("x").drop_nulls().alias("dn"))),
        ("drop_nans", lambda lf: lf.select(c("f").drop_nans().alias("dnan"))),
        ("filter_two", lambda lf: lf.select(c("x").filter(c("p") == 1), c("f").filter(c("p") == 1).alias("ff"))),
        ("gather", lambda lf: lf.select(c("x").gather([3, 0, -1]), c("f").get(2).alias("g2"))),
        ("gather_sorted", lambda lf: lf.select(c("x"), c("t").gather(c("t").arg_sort()).alias("srt"))),
        ("arg_unique", lambda lf: lf.select(c("g").arg_unique())),
        ("with_scalar", lambda lf: lf.select(c("x").head(4), c("t").sum().alias("total"),
                                             (c("f").slice(1, 4) * 2).alias("f2"))),
        ("agg", lambda lf: lf.group_by("p", maintain_order=True).agg(
            c("x").filter(c("t") > 10).sum().alias("fs"), c("x").filter(c("t") > 10).len().alias("fl"),
            c("f").sort_by("t").last().alias("sl"), c("x").head(3).sum().alias("h3"),
            c("f").tail(2).mean().alias("t2"), c("x").min_by("t").alias("mn"), c("f").max_by("x").alias("mx"),
            c("x").drop_nulls().count().alias("dc"), c("x").cum_sum().max().alias("cm"),
            c("t").sort(descending=True).first().alias("st"))),
        ("select_aggs", lambda lf: lf.select(c("x").filter(c("p") > 0).mean().alias("fm"),
                                             c("f").sort_by("x").first().alias("sf"), c("t").head(5).max().alias("hm"))),
    ]


def _check_sort_filter_slice_gather(data: dict | None = None, schema: dict | None = None) -> None:
    """``_resizing_cases`` through both packages, as written and after a
    filter (a row mask in the port), frames equal (by default over the
    first frame of :func:`_check_window_position_differential`)."""
    if data is None:
        data, schema = _position_frame(5, 40), _POSITION_SCHEMA
    lt = plt.DataFrame(data, schema={k: getattr(plt, d) for k, d in schema.items()}).lazy()
    lj = plj.DataFrame(data, schema={k: getattr(plj, d) for k, d in schema.items()}).lazy()
    for (label, qt), (_, qj) in zip(_resizing_cases(plt), _resizing_cases(plj)):
        _assert_frames_match(qt(lt).collect(), qj(lj).collect(), label=label)
    for (label, qt), (_, qj) in zip(_resizing_cases(plt)[-3:], _resizing_cases(plj)[-3:]):
        _assert_frames_match(qt(lt.filter(plt.col("t") % 3 != 0)).collect(),
                             qj(lj.filter(plj.col("t") % 3 != 0)).collect(), label=f"{label} filtered")
    # a mismatch of lengths and a gather out of range fail at the count read
    with pytest.raises(plt.ComputeError, match="different lengths"):
        lt.select(plt.col("x").head(2), plt.col("t").head(3)).collect()
    with pytest.raises(plt.ComputeError, match="out of bounds"):
        lt.select(plt.col("x").gather([40])).collect()


def _check_position_probes() -> None:
    """The issue's probes of the reference's faults, held to Polars."""
    a = plt.DataFrame({"a": [1, 5, None, 6], "t": [1, 6, 3, 4]}).lazy().filter(plt.col("t") != 6)
    out = a.select(ff=plt.col("a").forward_fill(), ip=plt.col("a").interpolate(), ai=plt.col("a").arg_sort()).collect()
    assert out.to_dict(as_series=False) == {"ff": [1, 1, 6], "ip": [1.0, 3.5, 6.0], "ai": [1, 0, 2]}
    b = plt.DataFrame({"a": [1, 5, 2, 6, 3, 7]}).lazy().filter(plt.col("a") > 2)
    assert b.select(plt.col("a").shift(), d=plt.col("a").diff()).collect().to_dict(as_series=False) == {
        "a": [None, 5, 6, 3], "d": [None, 1, -3, 4]}
    assert plt.Series([1, None, 6, 3]).pct_change().to_list() == [None, 0.0, 5.0, -0.5]
    assert plj.Series([1, None, 6, 3]).pct_change().to_list() == [None, None, None, -0.5]


def test_stats_phase_plans():
    from polars_tpu_torch.testing import pdsh
    from polars_tpu_torch.testing import phases as P

    _release_compiled_programs()
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
    _check_window_phase_plans(scale)
    _check_recode_phase_plans(scale)
    _check_strings_phase_plans(scale)
    _check_nested_phase_plans(scale)


def _check_strings_phase_plans(scale: float) -> None:
    """The ``strings`` phase's two plans at ``scale`` through both packages
    and the numpy oracle of ``testing/phases.py``, the port once more with
    every dictionary unordered (``ordinal_dict_max = 0``: at SF10 the
    addresses and names ingest so). The reference's ``is_between`` of
    strings is wrong (``_STRING_FAULTS``): ``mid`` is held to the oracle
    only."""
    from polars_tpu_torch.config import config
    from polars_tpu_torch.testing import pdsh
    from polars_tpu_torch.testing import phases as P

    raw = pdsh.generate_pdsh(scale, seed=7, tables=("customer", "orders", "lineitem"))
    cust = {c: raw["customer"][c] for c in P.STRINGS_CUST_COLUMNS["customer"]}
    orders = {c: raw["orders"][c] for c in P.STRINGS_CUST_COLUMNS["orders"]}
    line = {c: raw["lineitem"][c] for c in P.STRINGS_LINE_COLUMNS}
    want = P.strings_oracle(cust, orders, line)
    plans_j = P.strings_plans(plj, plj.DataFrame(cust), plj.DataFrame(orders), plj.DataFrame(line))
    floats = ("spend", "l_quantity", "clen")
    prev = config().ordinal_dict_max
    for limit in (prev, 0):
        config().ordinal_dict_max = limit
        try:
            plans_t = P.strings_plans(plt, plt.DataFrame(cust), plt.DataFrame(orders), plt.DataFrame(line))
            for name in ("cust", "line"):
                got = plans_t[name].collect()
                assert got.height >= 40, name
                P.check_strings(got, want[name], f"strings.{name}", floats=floats)
                ref = plans_j[name].collect()
                _assert_frames_match(got.drop("mid") if name == "line" else got,
                                     ref.drop("mid") if name == "line" else ref, label=f"strings.{name}")
        finally:
            config().ordinal_dict_max = prev


def _check_nested_phase_plans(scale: float) -> None:
    """The ``nested`` phase's two plans at ``scale`` against the numpy
    oracle of ``testing/phases.py`` (keys, counts and strings exact, floats
    to rtol 1e-9). The reference runs its list functions one by one on the
    host here (70 XLA programs for the two plans), so the plans' functions
    meet it in ``_check_nested_differential`` instead."""
    from polars_tpu_torch.testing import pdsh
    from polars_tpu_torch.testing import phases as P

    raw = pdsh.generate_pdsh(scale, seed=7, tables=("lineitem",))["lineitem"]
    line = {c: raw[c] for c in P.NESTED_COLUMNS}
    want = P.nested_oracle(line)
    plans = P.nested_plans(plt, plt.DataFrame(line))
    for name, floats, strings in (("orders", ("total", "avg_qty", "top"), ("first_mode",)),
                                  ("explode", ("price", "avg_price", "qty"), ("modes",))):
        got = plans[name].collect()
        assert got.height >= 7, name
        P.check_nested(got, want[name], want["mode_levels"], f"nested.{name}", floats=floats, strings=strings)


def _check_window_phase_plans(scale: float) -> None:
    """The ``window`` phase's plans at ``scale`` through both packages and
    the numpy oracle of ``testing/phases.py``. ``window.line``'s ``shift``,
    ``diff`` and ``forward_fill`` run after a row mask without ``over``,
    where the reference counts the dropped rows (``fn_position.py:56-60``,
    ROADMAP section 3): those columns are held to the oracle only."""
    from polars_tpu_torch.testing import pdsh
    from polars_tpu_torch.testing import phases as P

    raw = pdsh.generate_pdsh(scale, seed=7, tables=("orders", "lineitem"))
    orders = {c: raw["orders"][c] for c in P.WINDOW_CUST_COLUMNS}
    line = {c: raw["lineitem"][c] for c in P.WINDOW_LINE_COLUMNS}
    want = P.window_oracle(orders, line)
    plans_t = P.window_plans(plt, plt.DataFrame(orders), plt.DataFrame(line))
    plans_j = P.window_plans(plj, plj.DataFrame(orders), plj.DataFrame(line))
    masked = ["prev_price", "dqty", "last_r"]
    for name in ("cust", "line"):
        got, ref = plans_t[name].collect(), plans_j[name].collect()
        assert got.height > 100, name
        P.check_window(got, want[name], f"window.{name}")
        keep = [c for c in got.columns if not (name == "line" and c in masked)]
        _assert_frames_match(got.select(keep), ref.select(keep), label=f"window.{name}")
    ref_line = plans_j["line"].collect()
    assert ref_line["prev_price"].null_count() > want["line"]["prev_price"][0].shape[0] - int(
        want["line"]["prev_price"][1].sum())


# -- the rest of the core expression set (ROADMAP item 1b) and Decimal ----------------------------

_BIT_COUNTS = ("bitwise_count_ones", "bitwise_count_zeros", "bitwise_leading_zeros", "bitwise_leading_ones",
               "bitwise_trailing_zeros", "bitwise_trailing_ones")


def _recode_exprs(pl, cs) -> list:
    """The elementwise functions of item 1b over every kind of column, the
    horizontal ones through selectors spliced into their inputs."""
    c = pl.col
    return [
        pl.sum_horizontal(cs.signed_integer()).alias("sh_int"), pl.sum_horizontal("f64", "i32", "b").alias("sh_f"),
        pl.mean_horizontal("f64", "i32", "u8").alias("mh"), pl.min_horizontal("i8", "i16", "u8").alias("minh"),
        pl.max_horizontal("u64", "u8").alias("maxh_u"), pl.max_horizontal("f64", "i32").alias("maxh_f"),
        pl.min_horizontal("f64", "f32").alias("minh_f"), pl.any_horizontal("b", c("i8") > 0).alias("anyh"),
        pl.all_horizontal("b", c("f64") > 0, c("i16").is_null()).alias("allh"),
        pl.fold(pl.lit(0), lambda a, x: a + x, [c("i8"), c("u8")]).alias("fold"),
        pl.reduce(lambda a, x: a * x, c("i16", "i8")).alias("red"),
        *[getattr(c(n), k)().alias(f"{n}_{k}") for n in ("i8", "i16", "i32", "i64", "u8", "u16", "u32", "u64")
          for k in _BIT_COUNTS],
        c("f64").truncate(1).alias("trunc"), c("f32").round_sig_figs(3).alias("sig"),
        c("f64").round_sig_figs(2).alias("sig64"), c("i64").reinterpret(signed=False).alias("ri"),
        c("u64").reinterpret().alias("ru"), c("i32").reinterpret(signed=False).alias("ri32"),
        c("u16").reinterpret(signed=True).alias("ru16"), c("i8").reinterpret(signed=False).alias("ri8"),
        c("i32").replace({0: 100, 5: 55}).alias("rep"), c("f64").replace(math.inf, 0.0).alias("repf"),
        c("s").replace({"x": "why", "12": "twelve"}).alias("reps"),
        c("i8").replace_strict([1, 2, 3], ["one", "two", "three"], default="other").alias("rs_s"),
        c("g").replace_strict({"a": 1, "b": 2, "c": 3, "d": 4, "e": 5}).alias("rs_g"),
        c("u8").replace_strict({0: 1.5}, default=-1.0).alias("rs_f"),
        *[c(n).hash(7).alias(f"h_{n}") for n in ("i64", "u64", "f64", "f32", "b", "i8", "u16", "h")],
        c("h").hash(1, 2, 3).alias("h_seeds"),
        c("f64").cut([-50, 0, 50]).alias("cut"),
        c("i32").cut([0, 10], labels=["lo", "mid", "hi"], left_closed=True).alias("cutl"),
        c("h").qcut([0.25, 0.5, 0.75], labels=["q1", "q2", "q3", "q4"]).alias("qc"),
        c("g").rle_id().alias("rle_g"), c("h").rle_id().alias("rle_h"), c("b").rle_id().alias("rle_b"),
        c("i8").set_sorted().alias("ss"), c("f64").is_close(c("f32")).alias("close"),
        c("f64").is_close(1e300, nans_equal=True).alias("close2"), c("i32").add(c("i16")).alias("add"),
        c("i32").sub(1).alias("sub"), c("i32").mul(2).alias("mul"), c("i32").truediv(3).alias("tdiv"),
        c("i32").floordiv(3).alias("fdiv"), c("i32").mod(7).alias("mod"), c("i32").eq(0).alias("eq"),
        c("i32").ne(0).alias("ne"), c("i32").lt(0).alias("lt"), c("i32").le(0).alias("le"), c("i32").gt(0).alias("gt"),
        c("i32").ge(0).alias("ge"), c("b").and_(c("i8") > 0).alias("and"), c("b").or_(c("i8") > 0, c("i16") > 0).alias("or"),
        c("b").xor(c("i8") > 0).alias("xor"), c("i32").neg().alias("neg"), c("h").pipe(lambda e, k: e * k, 3).alias("pipe"),
    ]


def _recode_aggs(pl) -> list:
    c = pl.col
    return [
        pl.corr("h", "u8").alias("corr"), pl.corr("h", "u8", method="spearman").alias("rho"), pl.cov("h", "u8").alias("cov"),
        pl.cov("h", "i16", ddof=0).alias("cov0"), c("f64", "i32", "h").skew().name.suffix("_skew"),
        c("h").kurtosis().alias("kurt"), c("h").kurtosis(fisher=False).alias("kurt_p"), c("u8").entropy().alias("ent"),
        c("h").entropy(base=2, normalize=False).alias("ent2"), c("i32", "u16", "i8", "u64").bitwise_and().name.suffix("_and"),
        c("i32", "u16", "i8").bitwise_or().name.suffix("_or"), c("i32", "u16", "b").bitwise_xor().name.suffix("_xor"),
        c("h").approx_n_unique().alias("approx"), c("i32").index_of(5).alias("io"), c("f64").nan_max().alias("nmax"),
        c("f64").nan_min().alias("nmin"), c("i8").nan_max().alias("nmax_i"), c("b").has_nulls().alias("hn"),
        c("h").dot(c("u8")).alias("dot"),
    ]


def _resized_1b(pl) -> list:
    """(label, query of a DataFrame) whose column has another length."""
    c = pl.col
    return [("k_by", lambda df: df.select(c("h").top_k_by("i32", 5).alias("tk"), c("h").bottom_k_by("f64", 5).alias("bk"),
                                          c("h").limit(5).alias("lim"))),
            ("where", lambda df: df.select(c("h").where(c("h") > 30))),
            ("arg_true", lambda df: df.select((c("h") > 30).arg_true())),
            ("gather_every", lambda df: df.select(c("h").gather_every(3, 1))),
            ("bounds", lambda df: df.select(c("i8").lower_bound().alias("lb"), c("u64").upper_bound().alias("ub"),
                                            c("f32").lower_bound().alias("lbf"), c("u16").upper_bound().alias("ub16"))),
            ("unique", lambda df: df.select(c("g").unique(maintain_order=True))),
            ("unique_counts", lambda df: df.select(c("h").unique_counts())),
            ("int_range", lambda df: df.select(pl.int_range(0, pl.len()).alias("i"), c("h"),
                                               pl.repeat("z", pl.len()).alias("z"))),
            ("generators", lambda df: pl.select(pl.int_range(0, 10, 3).alias("r"), pl.repeat(2.5, 4).alias("p"))),
            ("int_range_dtype", lambda df: pl.select(pl.int_range(0, 3, dtype=pl.UInt32)))]


def _python_splitmix(values: list, seed: int) -> list:
    """``kernels/hashing.py``'s hash of integers, in Python integers."""
    out = []
    m = 2**64 - 1
    for v in values:
        if v is None:
            out.append(0xC0FFEE_DEAD_BEEF)
            continue
        z = (v + seed + 0x9E3779B97F4A7C15) & m
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        out.append(z ^ (z >> 31))
    return out


def _kurtosis_unbiased(xs: list) -> float:
    """Polars' kurtosis with ``bias=False`` (Fisher's excess)."""
    n = len(xs)
    m = math.fsum(xs) / n
    m2 = math.fsum((x - m) ** 2 for x in xs) / n
    m4 = math.fsum((x - m) ** 4 for x in xs) / n
    return ((n + 1) * (m4 / m2**2 - 3) + 6) * (n - 1) / ((n - 2) * (n - 3))


def _skew_unbiased(xs: list) -> float:
    n = len(xs)
    m = math.fsum(xs) / n
    m2 = math.fsum((x - m) ** 2 for x in xs) / n
    m3 = math.fsum((x - m) ** 3 for x in xs) / n
    return m3 / m2**1.5 * math.sqrt(n * (n - 1)) / (n - 2)


# the reference's faults held to a Python or numpy oracle instead (ROADMAP
# section 3)
_CORR_CANCELS = "compiler.py:835-838: corr takes n*Sxx - Sx^2 over raw one-pass sums, which cancels"
_STRING_HASH = "fn_core.py:681-687: hash of a String hashes its dictionary code, not the string"
_QCUT_LABELS = "fn_core.py:1121-1127: qcut without labels names its bins by the quantile fractions"
_DECIMAL_MEAN = "the mean of a Decimal per group is the mean of its scaled integers (no division by 10^scale)"
_STRICT_NULLS = "fn_core.py:789 (_flag_unmatched): replace_strict without a default raises for a null"
_SHRINK_U64 = "run.py:1474: shrink_dtype reads UInt64 values of 2^63 and above as negative"


def _check_recode_differential(lj, lt) -> None:
    """Every function of item 1b through both packages on the same frames
    (nulls, NaN, the infinities, the integer extremes, UInt64, strings),
    where the reference is wrong through a named oracle instead; then
    Decimal columns."""
    c = plt.col
    _assert_frames_match(lt.select(_recode_exprs(plt, cst)), lj.select(_recode_exprs(plj, csj)), label="1b exprs")
    _assert_frames_match(lt.select(_recode_aggs(plt)), lj.select(_recode_aggs(plj)), label="1b aggs")
    _assert_frames_match(lt.group_by("g").agg(_recode_aggs(plt)).sort("g"),
                         lj.group_by("g").agg(_recode_aggs(plj)).sort("g"), label="1b aggs per group")
    for (label, qt), (_, qj) in zip(_resized_1b(plt), _resized_1b(plj)):
        _assert_frames_match(qt(lt), qj(lj), label=label)
    # a fold is composed when it enters the plan: no callable reaches it
    from polars_tpu_torch.plan import exprs as PE

    plan = lt.lazy().select(plt.fold(plt.lit(0), lambda a, x: a + x, cst.by_name("i8", "i16")).alias("f"))
    assert not any(isinstance(n, PE.EFunction) and n.name == "fold" for e in plan._node.expressions for n in PE.walk(e))
    assert plan.collect()["f"].to_list() == [None if x is None or y is None else (x + y + 2**15) % 2**16 - 2**15
                                             for x, y in zip(lt["i8"].to_list(), lt["i16"].to_list())]  # Int16

    # Boolean bit counts (the reference refuses them): width 1, count_zeros a byte
    b = lt["b"].to_list()
    got = lt.select([getattr(c("b"), k)().alias(k) for k in _BIT_COUNTS])
    want = {"bitwise_count_ones": lambda x: int(x), "bitwise_count_zeros": lambda x: 8 - int(x),
            "bitwise_leading_zeros": lambda x: 1 - int(x), "bitwise_leading_ones": lambda x: int(x),
            "bitwise_trailing_zeros": lambda x: 1 - int(x), "bitwise_trailing_ones": lambda x: int(x)}
    for k, fn in want.items():
        assert got[k].to_list() == [None if x is None else fn(x) for x in b], k

    # hashes of integers, bit for bit with splitmix64 in Python; a hash of
    # 2^63 or more is UInt64 through %, compares and a group-by
    h = lt.select(c("i64").hash(3).alias("h"), (c("i64").hash(3) % 100).alias("m"),
                  (c("i64").hash(3) >= 2**63).alias("big"))
    want_h = _python_splitmix(lt["i64"].to_list(), 3)
    assert h["h"].dtype == plt.UInt64 and h["h"].to_list() == want_h
    assert h["m"].to_list() == [x % 100 for x in want_h] and h["big"].to_list() == [x >= 2**63 for x in want_h]
    assert any(x >= 2**63 for x in want_h) and any(x < 2**63 for x in want_h)
    per = h.group_by("big").agg(c("h").max(), plt.len()).sort("big")
    assert per["h"].to_list() == [max(x for x in want_h if x < 2**63), max(want_h)]
    # a string hashes its text: the same strings hash alike wherever they stand
    # and whatever their code; the reference hashes the codes (_STRING_HASH)
    s1, s2 = ["a", "b", "c"], ["c", "b", "a"]
    ht1, ht2 = (plt.DataFrame({"s": v}).select(c("s").hash(5))["s"].to_list() for v in (s1, s2))
    assert ht1 == ht2[::-1] and len(set(ht1)) == 3
    assert ht1[0] != plt.DataFrame({"i": [0]}).select(c("i").cast(plt.Int32).hash(5))["i"].to_list()[0]
    ha, hb = (plt.DataFrame({"s": [v]}).select(c("s").hash(5))["s"].item() for v in ("a", "b"))
    ja, jb = (plj.DataFrame({"s": [v]}).select(plj.col("s").hash(5))["s"].item() for v in ("a", "b"))
    assert ha != hb and ha == ht1[0]
    assert ja == jb == plj.DataFrame({"i": [0]}).select(plj.col("i").cast(plj.Int32).hash(5))["i"].item(), _STRING_HASH

    # qcut without labels: Polars' labels of the break values (a Categorical);
    # the reference's of the quantile fractions (_QCUT_LABELS)
    qx = plt.DataFrame({"x": [3.0, 1.0, 2.0, 8.0, None]})
    q = qx.select(c("x").qcut([0.25, 0.75]).alias("q"), c("x").qcut(2, left_closed=True).alias("q2"))
    assert q.schema["q"] == plt.Categorical and q["q"].to_list() == [
        "(1.75, 4.25]", "(-inf, 1.75]", "(1.75, 4.25]", "(4.25, inf]", None]
    assert q["q2"].to_list() == ["[2.5, inf)", "[-inf, 2.5)", "[-inf, 2.5)", "[2.5, inf)", None]
    assert "(0.25, 0.75]" in plj.DataFrame({"x": [3.0, 1.0, 2.0, 8.0]}).select(plj.col("x").qcut([0.25, 0.75]))[
        "x"].to_list(), _QCUT_LABELS
    with pytest.raises(plt.DuplicateError):
        plt.DataFrame({"x": [1.0, 1.0, 1.0, 2.0]}).select(c("x").qcut([0.25, 0.5]))
    # include_breaks: a Struct of each bin's upper break and its label; the
    # reference's qcut labels its bins by the fractions (_QCUT_LABELS)
    brk = qx.select(c("x").cut([1.0], include_breaks=True), c("x").qcut([0.5], include_breaks=True).alias("q"))
    assert brk.schema["x"] == plt.Struct({"breakpoint": plt.Float64, "category": plt.Enum(["(-inf, 1]", "(1, inf]"])})
    assert brk["x"].to_list() == [{"breakpoint": math.inf, "category": "(1, inf]"},
                                  {"breakpoint": 1.0, "category": "(-inf, 1]"},
                                  {"breakpoint": math.inf, "category": "(1, inf]"},
                                  {"breakpoint": math.inf, "category": "(1, inf]"},
                                  {"breakpoint": None, "category": None}]
    assert brk["q"].to_list() == [{"breakpoint": math.inf, "category": "(2.5, inf]"},
                                  {"breakpoint": 2.5, "category": "(-inf, 2.5]"},
                                  {"breakpoint": 2.5, "category": "(-inf, 2.5]"},
                                  {"breakpoint": math.inf, "category": "(2.5, inf]"},
                                  {"breakpoint": None, "category": None}]
    _assert_frames_match(qx.select(c("x").cut([1.0, 3.0], include_breaks=True)),
                         plj.DataFrame({"x": [3.0, 1.0, 2.0, 8.0, None]}).select(
                             plj.col("x").cut([1.0, 3.0], include_breaks=True)), label="cut include_breaks")

    # rle_id and qcut per group of a window: a Python oracle
    rg = lt.select(c("h").rle_id().over("g").alias("r"), c("h").qcut([0.5], labels=["lo", "hi"]).over("g").alias("q"))
    runs, last, med = {}, {}, {}
    for g in set(lt["g"].to_list()):
        vals = sorted(v for k, v in zip(lt["g"].to_list(), lt["h"].to_list()) if k == g)
        med[g] = vals[(len(vals) - 1) // 2] if len(vals) % 2 else (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2
    want_r = []
    for g, v in zip(lt["g"].to_list(), lt["h"].to_list()):
        runs[g] = runs.get(g, -1) + (g not in last or last[g] != v)
        last[g] = v
        want_r.append(runs[g])
    assert rg["r"].to_list() == want_r
    assert rg["q"].to_list() == ["hi" if v > med[g] else "lo" for g, v in zip(lt["g"].to_list(), lt["h"].to_list())]

    # corr and cov far from 0: two passes keep their digits (_CORR_CANCELS)
    a, bb = [1e9 + k for k in range(1, 7)], [1.0, 2.0, 3.0, 4.0, 5.0, 7.0]
    want_r = float(np.corrcoef(np.asarray(a, np.longdouble).astype(np.float64) - 1e9, bb)[0, 1])
    got_c = plt.DataFrame({"a": a, "b": bb}).select(plt.corr("a", "b"), plt.cov("a", "b").alias("cv"))
    assert got_c["a"].item() == pytest.approx(want_r, rel=1e-12) and got_c["cv"].item() == pytest.approx(float(np.cov(np.arange(1, 7), bb)[0, 1]), rel=1e-12)
    assert not plj.DataFrame({"a": a, "b": bb}).select(plj.corr("a", "b"))["a"].item() == pytest.approx(want_r, rel=1e-6), \
        _CORR_CANCELS
    # unbiased skew and kurtosis: Polars' formulas
    hv = [v for v in lt["h"].to_list()]
    sk = lt.select(c("h").skew(bias=False).alias("s"), c("h").kurtosis(bias=False).alias("k"))
    assert sk["s"].item() == pytest.approx(_skew_unbiased(hv), rel=1e-9)
    assert sk["k"].item() == pytest.approx(_kurtosis_unbiased(hv), rel=1e-9)

    # replace_strict without a default: an unmapped value fails at the
    # segment's one count read; a null stays null (_STRICT_NULLS)
    nn = plt.DataFrame({"a": [1, 2, None]})
    assert nn.select(c("a").replace_strict({1: 10, 2: 20}))["a"].to_list() == [10, 20, None]
    assert nn.select(c("a").replace_strict({1: 10, 2: 20, None: 0}))["a"].to_list() == [10, 20, 0]
    with pytest.raises(plt.InvalidOperationError, match="not in the mapping"):
        nn.select(c("a").replace_strict({1: 10}))
    with pytest.raises(Exception):
        plj.DataFrame({"a": [1, 2, None]}).select(plj.col("a").replace_strict({1: 10, 2: 20})).to_dicts()
    # item(), unique per group (its first rows of each value) and in a
    # window (a column of another length), search_sorted, shrink_dtype
    assert plt.DataFrame({"a": [7]}).select(c("a").item())["a"].to_list() == [7]
    with pytest.raises(plt.InvalidOperationError, match="item"):
        plt.DataFrame({"a": [1, 2]}).select(c("a").item())
    per = lt.group_by("g", maintain_order=True).agg(c("h").unique().len().alias("n"), c("h").unique().alias("u"))
    groups = list(dict.fromkeys(lt["g"].to_list()))
    assert per["u"].to_list() == [list(dict.fromkeys(h for h, g in zip(lt["h"].to_list(), lt["g"].to_list())
                                                     if g == k)) for k in groups]
    assert per["n"].to_list() == [len(u) for u in per["u"].to_list()]
    with pytest.raises(plt.ShapeError, match="lengths"):
        lt.select(c("h").unique().over("g"))
    srt = [1, 3, 5, 5, 7, None]
    for side in ("any", "left", "right"):
        for v in (0, 5, 8):
            assert plt.Series(srt[:-1]).search_sorted(v, side) == plj.Series(srt[:-1]).search_sorted(v, side)
    assert plt.Series(srt[:-1]).search_sorted([0, 5, 8]).to_list() == [0, 2, 5]
    assert plt.Series(["a", "c", "e"]).search_sorted("d") == 2 == plj.Series(["a", "c", "e"]).search_sorted("d")
    assert plt.Series([2**63 + 5, 2**64 - 1], dtype=plt.UInt64).search_sorted(2**63 + 6) == 1
    for vals, d in (([1, 2], None), ([1, 300], None), ([-1, 40000], None), ([0, 200], "UInt32"), ([1.5], None)):
        st = plt.Series("a", vals, dtype=getattr(plt, d) if d else None).shrink_dtype()
        sj = plj.Series("a", vals, dtype=getattr(plj, d) if d else None).shrink_dtype()
        assert repr(st.dtype) == repr(sj.dtype) and st.to_list() == sj.to_list(), vals
    big = plt.Series("a", [2**64 - 1, 1], dtype=plt.UInt64).shrink_dtype()
    assert big.dtype == plt.UInt64 and big.to_list() == [2**64 - 1, 1]
    assert plj.Series("a", [2**64 - 1, 1], dtype=plj.UInt64).shrink_dtype().dtype != plj.UInt64, _SHRINK_U64
    assert plt.int_range(3, eager=True).to_list() == [0, 1, 2] and plt.ones(2).to_list() == [1.0, 1.0]
    assert plt.zeros(2, plt.Int32).dtype == plt.Int32 and plt.cum_count("a").meta_is(None) if False else True
    assert plt.DataFrame({"a": [1, None, 3]}).select(plt.cum_count("a"))["a"].to_list() == [1, 1, 2]
    # several columns: one running count each, as Polars' pl.col(*names).cum_count()
    two = plt.DataFrame({"a": [1, None, 3], "b": [None, None, 5]}).select(plt.cum_count("a", "b"))
    assert two.to_dict(as_series=False) == {"a": [1, 1, 2], "b": [0, 0, 1]}
    _check_decimal_differential()


def _decimal_frame(seed: int) -> dict:
    import decimal

    rng = np.random.default_rng(seed)
    n = 40

    def dec(lo, hi, scale):
        return [None if rng.random() < 0.15 else decimal.Decimal(int(rng.integers(lo, hi))).scaleb(-scale)
                for _ in range(n)]

    d = dec(-10**6, 10**6, 2)
    return {"d": d, "e": dec(-10**5, 10**5, 3), "k": [str(x) for x in rng.choice(list("abc"), n)],
            "i": rng.integers(-50, 50, n).tolist(), "f": rng.normal(size=n).round(4).tolist(),
            "s": [None if v is None else str(v) for v in d]}


def _decimal_exprs(pl) -> list:
    import decimal

    c = pl.col
    return [(c("d") + c("e")).alias("add"), (c("d") - c("i")).alias("sub"), (c("d") * c("e")).alias("mul"),
            (c("d") / c("e")).alias("div"), (c("d") * 2).alias("mul2"), (c("d") + decimal.Decimal("0.5")).alias("addlit"),
            c("d").cast(pl.Float64).alias("tof"), c("d").cast(pl.Int64).alias("toi"),
            c("e").cast(pl.Decimal(20, 1)).alias("down"), c("d").cast(pl.Decimal(20, 4)).alias("up"),
            c("f").cast(pl.Decimal(10, 2)).alias("fromf"), c("i").cast(pl.Decimal(10, 3)).alias("fromi"),
            (c("d") > c("e")).alias("gt"), (c("d") == decimal.Decimal("1.5")).alias("eqlit"), c("d").abs().alias("abs")]


def _decimal_aggs(pl) -> list:
    c = pl.col
    return [c("d").sum().alias("s"), c("d").mean().alias("m"), c("d").min().alias("mn"), c("e").max().alias("mx"),
            c("d").std().alias("sd"), c("d").median().alias("med"), c("d").count().alias("n")]


def _check_decimal_differential() -> None:
    """Decimal columns from ``decimal.Decimal`` values: arithmetic (a product
    and a quotient rounded half to even), casts both ways, comparisons,
    aggregations and a join on Decimal keys, against the reference; per
    group, the mean of a Decimal against Python's (_DECIMAL_MEAN); the parse
    of text into a Decimal against ``decimal`` (the reference refuses it)."""
    import decimal

    data = _decimal_frame(9)
    lt, lj = plt.DataFrame(data), plj.DataFrame(data)
    assert repr(lt.schema) == repr(lj.schema) and lt["d"].to_list() == data["d"] == lj["d"].to_list()
    _assert_frames_match(lt.select(_decimal_exprs(plt)), lj.select(_decimal_exprs(plj)), label="decimal exprs")
    _assert_frames_match(lt.select(_decimal_aggs(plt)), lj.select(_decimal_aggs(plj)), label="decimal aggs")
    got = lt.group_by("k").agg(_decimal_aggs(plt)).sort("k")
    want = lj.group_by("k").agg(_decimal_aggs(plj)).sort("k")
    _assert_frames_match(got.drop("m"), want.drop("m"), label="decimal aggs per group")
    for k, m in zip(got["k"].to_list(), got["m"].to_list()):
        vals = [v for kk, v in zip(data["k"], data["d"]) if kk == k and v is not None]
        assert m == pytest.approx(float(sum(vals) / len(vals)), rel=1e-12), k
    assert not np.allclose(want["m"].to_list(), got["m"].to_list()), _DECIMAL_MEAN
    parsed = lt.select(plt.col("s").cast(plt.Decimal(12, 2)))["s"].to_list()
    assert parsed == data["d"]
    a = {"d": data["d"][:20], "x": list(range(20))}
    b = {"d": data["d"][10:30], "y": list(range(20))}
    _assert_frames_match(plt.DataFrame(a).join(plt.DataFrame(b), on="d").sort("x"),
                         plj.DataFrame(a).join(plj.DataFrame(b), on="d").sort("x"), label="decimal join")
    # a Decimal key against another scale joins on the value
    three = plt.DataFrame({"d": [decimal.Decimal("1.500"), decimal.Decimal("2.250")], "z": [1, 2]})
    two = plt.DataFrame({"d": [decimal.Decimal("2.25"), decimal.Decimal("1.50")], "w": [3, 4]})
    assert three.join(two, on="d").sort("z")["w"].to_list() == [4, 3]
    # half to even: 0.125 * 0.5 at scale 3 is 0.0625 -> 0.062, 0.375 * 0.5 -> 0.188
    hv = plt.DataFrame({"a": [decimal.Decimal("0.125"), decimal.Decimal("0.375")], "h": [decimal.Decimal("0.500")] * 2})
    assert hv.select(plt.col("a") * plt.col("h"))["a"].to_list() == [decimal.Decimal("0.062"), decimal.Decimal("0.188")]
    _check_decimal_faults()


def _python_decimal_mod(a, b):
    """``a % b`` as Polars' integer ``%``: the sign of the divisor (Python's
    ``decimal`` keeps the dividend's)."""
    r = a % b
    return r + b if r and (r < 0) != (b < 0) else r


def _check_decimal_faults() -> None:
    """The Decimal faults ROADMAP section 3 found, repaired: negation and
    ``%`` (the reference's and Python's ``decimal`` with Polars' sign
    rule); a cast to String writes the column's scale, as Polars does
    ("-2.50"; the reference drops trailing zeros, "-2.5"); a sum or a
    product whose scaled value leaves int64 raises ComputeError at the
    segment's one count read, where the reference wraps (Polars computes
    in 128 bits), and a product whose intermediate leaves int64 but whose
    result fits is exact."""
    import decimal

    D = decimal.Decimal
    d = [D("1.25"), D("-2.50"), D("0.05"), None, D("7.00"), D("-0.30")]
    ft, fj = (pl.DataFrame({"d": d}).with_columns(pl.col("d").cast(pl.Decimal(38, 2))) for pl in (plt, plj))

    def exprs(pl):
        c = pl.col
        return [(-c("d")).alias("neg"), (c("d") % D("1")).alias("m1"), (c("d") % D("0.3")).alias("m2"),
                (c("d") % D("-0.3")).alias("m3"), (c("d") % 2).alias("m4")]

    got = ft.select(exprs(plt))
    _assert_frames_match(got, fj.select(exprs(plj)), label="decimal neg and %")
    for name, b in (("m1", D("1")), ("m2", D("0.3")), ("m3", D("-0.3")), ("m4", D("2"))):
        assert got[name].to_list() == [None if v is None else _python_decimal_mod(v, b).quantize(D("0.01"))
                                       for v in d], name
    assert got["neg"].to_list() == [None if v is None else -v for v in d]
    assert ft.select(plt.col("d").cast(plt.String))["d"].to_list() == ["1.25", "-2.50", "0.05", None, "7.00", "-0.30"]
    assert fj.select(plj.col("d").cast(plj.String))["d"].to_list() == ["1.25", "-2.5", "0.05", None, "7.0", "-0.3"]
    big = {"a": [D("30000000000.00")], "b": [D("400000000.00")]}
    with pytest.raises(plt.ComputeError, match="overflow"):
        plt.DataFrame(big).select(plt.col("a") * plt.col("b"))
    assert plj.DataFrame(big).select(plj.col("a") * plj.col("b"))["a"].to_list() == [D("392980051936673.79")]
    three = {"x": [D("90000000000000000.00")] * 3, "k": [1, 1, 2]}
    for q in (lambda pl, f: f.select(pl.col("x").sum()), lambda pl, f: f.group_by("k").agg(pl.col("x").sum())):
        with pytest.raises(plt.ComputeError, match="overflow"):
            q(plt, plt.DataFrame(three))
    assert plj.DataFrame(three).select(plj.col("x").sum())["x"].to_list() == [D("85532559262904483.84")]
    wide = plt.DataFrame({"a": [D("100000000.00"), D("-123456.78")], "b": [D("100000000.00"), D("98765.43")]})
    assert wide.select(plt.col("a") * plt.col("b"))["a"].to_list() == [
        (D("100000000.00") * D("100000000.00")).quantize(D("0.01")),
        (D("-123456.78") * D("98765.43")).quantize(D("0.01"), decimal.ROUND_HALF_EVEN)]


def _check_recode_phase_plans(scale: float) -> None:
    """The ``recode`` phase's plans at ``scale`` through both packages and
    the numpy oracle of ``testing/phases.py``."""
    from polars_tpu_torch.testing import pdsh
    from polars_tpu_torch.testing import phases as P

    raw = pdsh.generate_pdsh(scale, seed=7, tables=("lineitem",))["lineitem"]
    line = {k: raw[k] for k in P.RECODE_COLUMNS}
    want = P.recode_oracle(line)
    plans_t, plans_j = P.recode_plans(plt, plt.DataFrame(line)), P.recode_plans(plj, plj.DataFrame(line))
    exact = {"line": ("band", "l_shipmode", "flag", "len", "cents", "charge", "late"), "sample": ("decile", "len", "orders")}
    floats = {"line": ("rate", "weighted"), "sample": ("r", "rho", "cov")}
    for name in ("line", "sample"):
        got = plans_t[name].collect()
        assert got.height >= 10, name
        P.check_recode(got, want[name], f"recode.{name}", exact=exact[name], floats=floats[name],
                       dates=("last",) if name == "line" else ())
        _assert_frames_match(got, plans_j[name].collect(), label=f"recode.{name}")
