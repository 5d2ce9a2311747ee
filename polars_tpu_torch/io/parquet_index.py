"""Parquet page-index + bloom-filter pruning (copied whole from
``polars_tpu/io/parquet_index.py``, but that page statistics of an unsigned
column decode as unsigned: ``_unsigned``).

pyarrow (25.x) can WRITE page indexes and bloom filters but exposes no Python
reader for either, so this module parses the structures directly from the
file: a Thrift compact-protocol reader for FileMetaData/ColumnIndex/
OffsetIndex/BloomFilterHeader, xxhash64, and the parquet split-block bloom
probe. Mirrors the reference's predicate readers
(crates/polars-parquet/src/arrow/read/expr.rs, bloom + page index pruning
throughout polars-parquet/src/).

Used by io/scan_exec.py to (a) skip row groups whose bloom filter proves an
equality literal absent, and (b) narrow decoded row groups to the row ranges
of pages whose min/max can satisfy the pushed conjuncts.
"""

from __future__ import annotations

import os
import struct
from typing import Any

# ---------------------------------------------------------------------------
# thrift compact protocol (read-only, generic: structs -> {field_id: value})
# ---------------------------------------------------------------------------

_CT_STOP = 0
_CT_TRUE = 1
_CT_FALSE = 2
_CT_BYTE = 3
_CT_I16 = 4
_CT_I32 = 5
_CT_I64 = 6
_CT_DOUBLE = 7
_CT_BINARY = 8
_CT_LIST = 9
_CT_SET = 10
_CT_MAP = 11
_CT_STRUCT = 12


def _uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    r = 0
    s = 0
    while True:
        b = buf[pos]
        pos += 1
        r |= (b & 0x7F) << s
        if not (b & 0x80):
            return r, pos
        s += 7


def _zigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _read_value(buf: bytes, pos: int, ctype: int):
    if ctype == _CT_TRUE:
        return True, pos
    if ctype == _CT_FALSE:
        return False, pos
    if ctype == _CT_BYTE:
        return buf[pos], pos + 1
    if ctype in (_CT_I16, _CT_I32, _CT_I64):
        u, pos = _uvarint(buf, pos)
        return _zigzag(u), pos
    if ctype == _CT_DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ctype == _CT_BINARY:
        n, pos = _uvarint(buf, pos)
        return bytes(buf[pos : pos + n]), pos + n
    if ctype in (_CT_LIST, _CT_SET):
        h = buf[pos]
        pos += 1
        size = h >> 4
        et = h & 0xF
        if size == 15:
            size, pos = _uvarint(buf, pos)
        out = []
        if et in (_CT_TRUE, _CT_FALSE):
            # list elements of bool type are one byte each (1=true, 2=false)
            for _ in range(size):
                out.append(buf[pos] == 1)
                pos += 1
            return out, pos
        for _ in range(size):
            v, pos = _read_value(buf, pos, et)
            out.append(v)
        return out, pos
    if ctype == _CT_MAP:
        size, pos = _uvarint(buf, pos)
        if size == 0:
            return {}, pos
        kv = buf[pos]
        pos += 1
        kt, vt = kv >> 4, kv & 0xF
        out = {}
        for _ in range(size):
            k, pos = _read_value(buf, pos, kt)
            v, pos = _read_value(buf, pos, vt)
            out[k] = v
        return out, pos
    if ctype == _CT_STRUCT:
        return _read_struct(buf, pos)
    raise ValueError(f"unknown thrift compact type {ctype}")


def _read_struct(buf: bytes, pos: int) -> tuple[dict, int]:
    fields: dict[int, Any] = {}
    last_id = 0
    while True:
        b = buf[pos]
        pos += 1
        if b == _CT_STOP:
            return fields, pos
        delta = b >> 4
        t = b & 0xF
        if delta == 0:
            u, pos = _uvarint(buf, pos)
            fid = _zigzag(u)
        else:
            fid = last_id + delta
        last_id = fid
        v, pos = _read_value(buf, pos, t)
        fields[fid] = v


# ---------------------------------------------------------------------------
# xxhash64 (parquet bloom hash; seed 0)
# ---------------------------------------------------------------------------

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxhash64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        while i <= n - 32:
            for _ in (0,):
                v1 = (_rotl((v1 + int.from_bytes(data[i : i + 8], "little") * _P2) & _M64, 31) * _P1) & _M64
                v2 = (_rotl((v2 + int.from_bytes(data[i + 8 : i + 16], "little") * _P2) & _M64, 31) * _P1) & _M64
                v3 = (_rotl((v3 + int.from_bytes(data[i + 16 : i + 24], "little") * _P2) & _M64, 31) * _P1) & _M64
                v4 = (_rotl((v4 + int.from_bytes(data[i + 24 : i + 32], "little") * _P2) & _M64, 31) * _P1) & _M64
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ ((_rotl((v * _P2) & _M64, 31) * _P1) & _M64)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i <= n - 8:
        k = int.from_bytes(data[i : i + 8], "little")
        h ^= (_rotl((k * _P2) & _M64, 31) * _P1) & _M64
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i <= n - 4:
        h ^= (int.from_bytes(data[i : i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


# ---------------------------------------------------------------------------
# split-block bloom filter (parquet spec §Bloom filter)
# ---------------------------------------------------------------------------

_SALT = (
    0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
    0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31,
)


def bloom_might_contain(bitset: bytes, h: int) -> bool:
    nblocks = len(bitset) // 32
    if nblocks == 0:
        return True
    block = ((h >> 32) * nblocks) >> 32
    x = h & 0xFFFFFFFF
    base = block * 32
    for i in range(8):
        bit = ((x * _SALT[i]) & 0xFFFFFFFF) >> 27
        word = int.from_bytes(bitset[base + 4 * i : base + 4 * i + 4], "little")
        if not (word >> bit) & 1:
            return False
    return True


def _plain_bytes(v: Any, physical_type: str) -> bytes | None:
    """PLAIN encoding of one value for bloom hashing; None = unencodable."""
    try:
        if physical_type == "INT32":
            return struct.pack("<i", int(v))
        if physical_type == "INT64":
            return struct.pack("<q", int(v))
        if physical_type == "FLOAT":
            return struct.pack("<f", float(v))
        if physical_type == "DOUBLE":
            return struct.pack("<d", float(v))
        if physical_type == "BYTE_ARRAY":
            if isinstance(v, bytes):
                return v
            if isinstance(v, str):
                return v.encode("utf-8")
    except (ValueError, OverflowError, struct.error):
        return None
    return None


def _decode_stat(raw: bytes, physical_type: str):
    if physical_type == "INT32":
        return struct.unpack("<i", raw)[0]
    if physical_type == "INT64":
        return struct.unpack("<q", raw)[0]
    if physical_type == "UINT32":  # an unsigned logical type over INT32/INT64
        return struct.unpack("<I", raw)[0]
    if physical_type == "UINT64":
        return struct.unpack("<Q", raw)[0]
    if physical_type == "FLOAT":
        return struct.unpack("<f", raw)[0]
    if physical_type == "DOUBLE":
        return struct.unpack("<d", raw)[0]
    if physical_type == "BYTE_ARRAY":
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if physical_type == "BOOLEAN":
        return bool(raw[0]) if raw else None
    return None


# ---------------------------------------------------------------------------
# file structure access
# ---------------------------------------------------------------------------


class ParquetIndexReader:
    """Reads the footer's per-chunk index offsets plus the ColumnIndex /
    OffsetIndex / bloom structures pyarrow doesn't expose."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._f.seek(-8, os.SEEK_END)
        tail = self._f.read(8)
        if tail[4:] != b"PAR1":
            raise ValueError("not a parquet file")
        mlen = struct.unpack("<I", tail[:4])[0]
        self._f.seek(-(8 + mlen), os.SEEK_END)
        meta, _ = _read_struct(self._f.read(mlen), 0)
        # FileMetaData: 4 = row_groups; RowGroup: 1 = columns (ColumnChunk)
        self._row_groups = meta.get(4, [])

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> ParquetIndexReader:
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _chunk(self, rg: int, col: int) -> dict:
        return self._row_groups[rg].get(1, [])[col]

    def column_index(self, rg: int, col: int) -> dict | None:
        """ColumnIndex: {1: null_pages, 2: min_values, 3: max_values,
        4: boundary_order, 5: null_counts} (parquet.thrift)."""
        ch = self._chunk(rg, col)
        off, ln = ch.get(6), ch.get(7)
        if off is None or ln is None:
            return None
        self._f.seek(off)
        idx, _ = _read_struct(self._f.read(ln), 0)
        return idx

    def offset_index(self, rg: int, col: int) -> list[dict] | None:
        """OffsetIndex page_locations: each {1: offset, 2: compressed_size,
        3: first_row_index (within the row group)}."""
        ch = self._chunk(rg, col)
        off, ln = ch.get(4), ch.get(5)
        if off is None or ln is None:
            return None
        self._f.seek(off)
        idx, _ = _read_struct(self._f.read(ln), 0)
        return idx.get(1)

    def bloom_bitset(self, offset: int, length: int | None) -> bytes | None:
        """BloomFilterHeader at ``offset``; the bitset follows immediately."""
        self._f.seek(offset)
        head_buf = self._f.read(64 if length is None else min(length, 64))
        header, consumed = _read_struct(head_buf, 0)
        num_bytes = header.get(1)
        if not num_bytes:
            return None
        self._f.seek(offset + consumed)
        return self._f.read(num_bytes)


# ---------------------------------------------------------------------------
# pruning entry points (called from io/scan_exec.py)
# ---------------------------------------------------------------------------


def _page_matches(op: str, lo: Any, hi: Any, v: Any) -> bool:
    try:
        if op == "<":
            return lo < v
        if op == "<=":
            return lo <= v
        if op == ">":
            return hi > v
        if op == ">=":
            return hi >= v
        if op == "==":
            return lo <= v <= hi
    except TypeError:
        return True
    return True


def _unsigned(column) -> bool:
    """Whether a Parquet schema column holds an unsigned integer type."""
    return str(getattr(column, "converted_type", "")).startswith("UINT")


def refine_pruning(path: str, pf, row_groups: list[int], conjuncts, metrics: dict | None = None):
    """(kept_row_groups, {rg: [(start, stop), ...] row ranges} | None).

    Bloom filters veto row groups for `==` conjuncts; page-level min/max
    narrow the surviving groups to candidate row ranges (the exact filter
    still runs on device, so this only needs soundness)."""
    from polars_tpu_torch.io.scan_exec import _literal_plain

    if not conjuncts or not row_groups:
        return row_groups, None
    if os.environ.get("POLARS_TPU_PARQUET_INDEX", "1") == "0":
        return row_groups, None
    md = pf.metadata
    name_to_idx = {md.schema.column(i).name: i for i in range(md.num_columns)}
    try:
        rd = ParquetIndexReader(path)
    except Exception:  # noqa: BLE001 — unreadable footer: no refinement
        return row_groups, None
    kept: list[int] = []
    ranges: dict[int, list[tuple[int, int]]] = {}
    any_ranges = False
    try:
        for rg in row_groups:
            rgm = md.row_group(rg)
            n_rows = rgm.num_rows
            alive = True
            row_mask_ranges: list[tuple[int, int]] | None = None  # None = all rows
            for col, op, lit in conjuncts:
                ci = name_to_idx.get(col)
                if ci is None:
                    continue
                cm = rgm.column(ci)
                ptype = cm.physical_type
                # the column index orders an unsigned column's pages by its
                # unsigned values (polars_tpu decodes them signed, and drops
                # pages above 2**31 or 2**63 that match)
                stat_type = "U" + ptype if ptype in ("INT32", "INT64") and _unsigned(md.schema.column(ci)) else ptype
                v = _literal_plain(lit)
                # ---- bloom veto on equality ------------------------------
                if op == "==" and cm.bloom_filter_offset is not None:
                    enc = _plain_bytes(v, ptype)
                    if enc is not None:
                        try:
                            bitset = rd.bloom_bitset(cm.bloom_filter_offset, cm.bloom_filter_length)
                        except Exception:  # noqa: BLE001
                            bitset = None
                        if bitset is not None and not bloom_might_contain(bitset, xxhash64(enc)):
                            alive = False
                            if metrics is not None:
                                metrics["bloom_skipped_row_groups"] = metrics.get("bloom_skipped_row_groups", 0) + 1
                            break
                # ---- page-level min/max ----------------------------------
                try:
                    cidx = rd.column_index(rg, ci)
                    pages = rd.offset_index(rg, ci)
                except Exception:  # noqa: BLE001
                    cidx = pages = None
                if not cidx or not pages or len(pages) <= 1:
                    continue
                null_pages = cidx.get(1, [])
                mins = cidx.get(2, [])
                maxs = cidx.get(3, [])
                if len(mins) != len(pages):
                    continue
                keep_pages: list[tuple[int, int]] = []
                for p, loc in enumerate(pages):
                    start = loc.get(3, 0)
                    stop = pages[p + 1].get(3, n_rows) if p + 1 < len(pages) else n_rows
                    if p < len(null_pages) and null_pages[p]:
                        continue  # all-null page cannot satisfy a comparison
                    lo = _decode_stat(mins[p], stat_type)
                    hi = _decode_stat(maxs[p], stat_type)
                    if lo is None or hi is None or _page_matches(op, lo, hi, v):
                        keep_pages.append((start, stop))
                if row_mask_ranges is None:
                    row_mask_ranges = keep_pages
                else:
                    row_mask_ranges = _intersect_ranges(row_mask_ranges, keep_pages)
                if not row_mask_ranges:
                    alive = False
                    break
            if not alive:
                continue
            kept.append(rg)
            if row_mask_ranges is not None and _range_rows(row_mask_ranges) < n_rows:
                ranges[rg] = _merge_ranges(row_mask_ranges)
                any_ranges = True
    finally:
        rd.close()
    return kept, (ranges if any_ranges else None)


def _merge_ranges(rs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for s, e in sorted(rs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersect_ranges(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out = []
    for s1, e1 in a:
        for s2, e2 in b:
            s, e = max(s1, s2), min(e1, e2)
            if s < e:
                out.append((s, e))
    return _merge_ranges(out)


def _range_rows(rs: list[tuple[int, int]]) -> int:
    return sum(e - s for s, e in _merge_ranges(rs))
