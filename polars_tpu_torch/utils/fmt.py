"""Console table formatting (the port of ``polars_tpu/utils/fmt.py``: the
box-drawing table of ``DataFrame.__repr__`` and the listing of
``Series.__repr__``, cut to ``Config``'s rows, columns and string length)."""

from __future__ import annotations

from typing import TYPE_CHECKING

from polars_tpu_torch.config import fmt_config as config

if TYPE_CHECKING:
    from polars_tpu_torch.core.frame import DataFrame


def _fmt_value(v, max_len: int) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if v != v:
            return "NaN"
        s = f"{v:.6f}".rstrip("0")
        if s.endswith("."):
            s += "0"
        if len(s) > 14:
            s = f"{v:.4e}"
        return s
    if isinstance(v, str):
        s = f'"{v}"'
    elif isinstance(v, list):  # a List or Array value, as Polars prints it
        s = "[" + ", ".join(_fmt_value(x, max_len) for x in v) + "]"
    elif isinstance(v, dict):  # a Struct value: its fields' values
        s = "{" + ",".join(_fmt_value(x, max_len) for x in v.values()) + "}"
    else:
        s = str(v)
    if len(s) > max_len:
        s = s[: max_len - 1] + "…"
    return s


def format_table(df: DataFrame) -> str:
    cfg = config()
    max_rows = cfg.fmt_max_rows
    max_cols = cfg.fmt_max_cols
    str_len = max(cfg.fmt_str_len, 6)

    ncols = df.width
    col_idx = list(range(ncols))
    elided_cols = False
    if ncols > max_cols:
        half = max_cols // 2
        col_idx = list(range(half)) + list(range(ncols - (max_cols - half), ncols))
        elided_cols = True

    n = df.height
    if n > max_rows:
        head = df.head(max_rows // 2 + max_rows % 2)
        tail = df.tail(max_rows // 2)
        blocks = [head.rows(), None, tail.rows()]
    else:
        blocks = [df.rows()]

    names = df.columns
    dtypes = [repr(d) for d in df.dtypes]

    def cells_for(rows):
        return [[_fmt_value(row[i], str_len) for i in col_idx] for row in rows]

    body: list[list[str] | None] = []
    for b in blocks:
        if b is None:
            body.append(None)
        else:
            body.extend(cells_for(b))

    headers = [names[i] for i in col_idx]
    dstrs = [dtypes[i] for i in col_idx]
    if elided_cols:
        insert_at = max_cols // 2
        headers.insert(insert_at, "…")
        dstrs.insert(insert_at, "")
        body = [
            None if r is None else r[:insert_at] + ["…"] + r[insert_at:] for r in body
        ]

    widths = [
        max(len(h), len(d), *(len(r[i]) for r in body if r is not None)) if body else max(len(h), len(d))
        for i, (h, d) in enumerate(zip(headers, dstrs))
    ]

    def line(cells, sep="│"):
        return sep + sep.join(f" {c:<{w}} " for c, w in zip(cells, widths)) + sep

    top = "┌" + "┬".join("─" * (w + 2) for w in widths) + "┐"
    mid = "╞" + "╪".join("═" * (w + 2) for w in widths) + "╡"
    bot = "└" + "┴".join("─" * (w + 2) for w in widths) + "┘"

    out = [f"shape: ({df.height}, {df.width})", top, line(headers), line(["---"] * len(headers)), line(dstrs), mid]
    for r in body:
        if r is None:
            out.append(line(["…"] * len(headers)))
        else:
            out.append(line(r))
    out.append(bot)
    return "\n".join(out)


def format_series(s) -> str:
    cfg = config()
    max_rows = cfg.fmt_max_rows
    n = len(s)
    vals = s.to_list() if n <= max_rows + 1 else (s.head(max_rows // 2 + 1).to_list() + ["…"] + s.tail(max_rows // 2).to_list())
    lines = [f"shape: ({n},)", f"Series: '{s.name}' [{_short_dtype(s.dtype)}]", "["]
    for v in vals:
        lines.append(f"\t{v if v == '…' else _fmt_value(v, cfg.fmt_str_len)}")
    lines.append("]")
    return "\n".join(lines)


_SHORT = {
    "Int8": "i8", "Int16": "i16", "Int32": "i32", "Int64": "i64",
    "UInt8": "u8", "UInt16": "u16", "UInt32": "u32", "UInt64": "u64",
    "Float32": "f32", "Float64": "f64", "Boolean": "bool", "String": "str",
    "Date": "date", "Time": "time", "Binary": "binary", "Null": "null",
    "Categorical": "cat", "Object": "object",
}


def _short_dtype(d) -> str:
    return _SHORT.get(type(d).__name__, repr(d))
