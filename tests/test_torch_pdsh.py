"""PDS-H Q5, Q6, Q10, Q12, Q14, Q18 and Q19 through both packages.

One dataset, made from a numpy seed by ``generate_pdsh``, goes through
``polars_tpu`` (JAX on the CPU) and ``polars_tpu_torch`` (``device="cpu"``).
Keys, dates, strings and counts must be equal; floats agree to rtol 1e-9
(the two engines sum in different orders). Each query reads only its own
columns (``pdsh.QUERY_COLUMNS``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import polars_tpu as plj
import polars_tpu_torch as plt
from polars_tpu.testing import pdsh as pdsh_jax
from polars_tpu_torch.testing import pdsh as pdsh_torch

QUERIES = ["q5", "q6", "q10", "q12", "q14", "q18", "q19"]


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


@pytest.fixture(scope="module")
def frames():
    """Every table at SF 0.003 (seed 7, the data of tests/test_pdsh.py), in
    both packages; the port's frames on the CPU."""
    raw = pdsh_jax.generate_pdsh(0.003, seed=7)
    want = {t: plj.DataFrame(cols) for t, cols in raw.items()}
    got = {t: plt.DataFrame(cols, device="cpu") for t, cols in raw.items()}
    return want, got


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_polars_tpu(frames, q):
    fj, ft = frames
    args_j = [fj[t] for t in pdsh_torch.QUERY_COLUMNS[q]]
    want = getattr(pdsh_jax, q)(*args_j).collect()
    got = pdsh_torch.query(q, ft).collect()
    _assert_frames_match(got, want)
    # the result is not trivial at this size: groups present, sums non-zero
    assert want.height >= {"q5": 2, "q10": 20, "q12": 2, "q18": 5}.get(q, 1)
    for name, d in want.schema.items():
        if isinstance(d, plj.datatypes.FloatType) or name.endswith("_count"):
            assert all(v for v in want[name].to_list()), name


@pytest.mark.parametrize("q", QUERIES)
def test_query_on_its_own_columns(frames, q):
    """The query over frames of only the columns ``QUERY_COLUMNS`` lists
    (``frames_for``, as the card's runs cut them) gives the same frame as over
    whole tables."""
    _, ft = frames
    cut = pdsh_torch.frames_for(q, ft)
    assert {t: f.columns for t, f in cut.items()} == pdsh_torch.QUERY_COLUMNS[q]
    _assert_frames_match(pdsh_torch.query(q, cut).collect(), pdsh_torch.query(q, ft).collect(), rtol=0)


# what each query hands K1 (capacity, column dtypes; None = a count) and K2
# (rows, columns), in call order, at this size: dense group-bys count their
# key slots and then sum, sorted group-bys (capacity = the rows) and
# one-row selects (capacity 1) only sum
def _expected_calls(q: str, ft: dict) -> list:
    n_line = ft["lineitem"].height
    f64, i64 = torch.float64, torch.int64
    return {
        "q5": [("K1", 26, [None]), ("K1", 26, [f64]), ("K2", 26, 2)],
        "q6": [("K1", 1, [f64]), ("K2", 1, 1)],
        "q10": [("K1", n_line, [f64]), ("K2", n_line, 8)],
        "q12": [("K1", 8, [None]), ("K1", 8, [i64, i64]), ("K2", 8, 3)],
        "q14": [("K1", 1, [f64, f64]), ("K2", 1, 1)],
        "q18": [("K1", n_line, [f64]), ("K1", n_line, [f64]), ("K2", ft["orders"].height, 6)],
        "q19": [("K1", 1, [f64]), ("K2", 1, 1)],
    }[q]


@pytest.mark.parametrize("q", QUERIES)
def test_query_kernel_calls(frames, monkeypatch, q):
    """Each query's sums and counts go through K1 (a one-row select's too,
    as one group of capacity 1) and its result through one K2 compaction."""
    from polars_tpu_torch.engine import executors as X
    from polars_tpu_torch.engine import groupby as G
    from polars_tpu_torch.kernels.compact import compact_scatter
    from polars_tpu_torch.kernels.groupagg import groupagg_sums

    calls = []

    def k1(gids, cols, mask, cap):
        calls.append(("K1", cap, [None if c is None else c.dtype for c in cols]))
        return groupagg_sums(gids, cols, mask, cap)

    def k2(cols, mask, offs, count):
        calls.append(("K2", mask.shape[0], len(cols)))
        return compact_scatter(cols, mask, offs, count)

    monkeypatch.setattr(X, "groupagg_sums", k1)
    monkeypatch.setattr(G, "groupagg_sums", k1)
    monkeypatch.setattr(X, "compact_scatter", k2)
    _, ft = frames
    pdsh_torch.query(q, ft).collect()
    assert calls == _expected_calls(q, ft)
