"""String grid / cluster dedupe utilities (JAX counterpart
deeplearning4j_tpu/util/string_grid.py, the port's own copy; reference
util/StringGrid.java, util/StringCluster.java).

A StringGrid is a list of string rows (split from CSV-ish lines) with
column-wise cleanup operations; StringCluster groups strings by an
order/case/punctuation-insensitive fingerprint so near-duplicate values
("Two words", "TWO words", "words two") land in one cluster. Host-side
tooling — no device arrays involved.
"""

from __future__ import annotations

import difflib
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

_PUNCT = re.compile(r"[^\w\s]", re.UNICODE)


def fingerprint(s: str) -> str:
    """Case/punctuation/order-insensitive key (reference FingerPrintKeyer:
    trim, lowercase, strip punctuation, unique-sort the tokens, rejoin)."""
    toks = _PUNCT.sub("", s.strip().lower()).split()
    return " ".join(sorted(set(toks)))


class StringCluster:
    """fingerprint -> {original string -> count} (reference
    StringCluster.java:36-61); clusters sort largest-first."""

    def __init__(self, strings: Iterable[str]):
        self.clusters: Dict[str, Dict[str, int]] = defaultdict(dict)
        for s in strings:
            m = self.clusters[fingerprint(s)]
            m[s] = m.get(s, 0) + 1

    def get_clusters(self) -> List[Dict[str, int]]:
        return sorted(
            self.clusters.values(),
            key=lambda m: (-len(m), -sum(m.values())))

    def __getitem__(self, key: str) -> Dict[str, int]:
        return self.clusters[key]

    def __len__(self) -> int:
        return len(self.clusters)


class StringGrid:
    """Rows of string columns with cleanup/dedupe ops (reference
    StringGrid.java). Construct via from_lines/from_file or with explicit
    rows; `sep` is a literal separator, not a regex."""

    NONE = "NONE"

    def __init__(self, sep: str, num_columns: Optional[int] = None,
                 rows: Optional[List[List[str]]] = None):
        self.sep = sep
        self.rows: List[List[str]] = [list(r) for r in (rows or [])]
        if num_columns is None:
            num_columns = len(self.rows[0]) if self.rows else 0
        self.num_columns = num_columns
        for i, row in enumerate(self.rows):
            if len(row) != self.num_columns:
                raise ValueError(
                    f"row {i} has {len(row)} columns, expected "
                    f"{self.num_columns}")

    @classmethod
    def from_lines(cls, lines: Iterable[str], sep: str) -> "StringGrid":
        rows = [line.rstrip("\n").split(sep) for line in lines
                if line.strip()]
        return cls(sep, rows=rows)

    @classmethod
    def from_file(cls, path: str, sep: str) -> "StringGrid":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_lines(f, sep)

    # ----------------------------------------------------------- accessors
    def get_column(self, column: int) -> List[str]:
        return [row[column] for row in self.rows]

    def get_row(self, i: int) -> List[str]:
        return self.rows[i]

    def to_lines(self) -> List[str]:
        return [self.sep.join(row) for row in self.rows]

    def write_lines_to(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.to_lines()) + "\n")

    def __len__(self) -> int:
        return len(self.rows)

    # ------------------------------------------------------------- cleanup
    def head(self, num: int) -> "StringGrid":
        return StringGrid(self.sep, self.num_columns, self.rows[:num])

    def remove_rows_with_empty_column(self, column: int,
                                      missing_value: str = "") -> None:
        self.rows = [r for r in self.rows if r[column] != missing_value]

    def remove_columns(self, *columns: int) -> None:
        drop = set(columns)
        bad = [c for c in drop if not 0 <= c < self.num_columns]
        if bad:
            raise IndexError(f"column(s) {bad} out of range "
                             f"(grid has {self.num_columns})")
        self.rows = [[c for j, c in enumerate(r) if j not in drop]
                     for r in self.rows]
        self.num_columns -= len(drop)

    def filter_rows_by_column(self, column: int,
                              values: Iterable[str]) -> None:
        keep = set(values)
        self.rows = [r for r in self.rows if r[column] in keep]

    def select(self, column: int, value: str) -> "StringGrid":
        return StringGrid(self.sep, self.num_columns,
                          [r for r in self.rows if r[column] == value])

    def sort_by(self, column: int) -> None:
        self.rows.sort(key=lambda r: r[column])

    def swap(self, column1: int, column2: int) -> None:
        for r in self.rows:
            r[column1], r[column2] = r[column2], r[column1]

    def merge(self, column1: int, column2: int,
              join_with: str = " ") -> None:
        """Join two columns, dropping the second. Joins with a space by
        default — joining with the grid separator (as the reference does)
        would make write/read round-trips silently re-split the column."""
        bad = [c for c in (column1, column2)
               if not 0 <= c < self.num_columns]
        if bad:  # validate before mutating any row
            raise IndexError(f"column(s) {bad} out of range "
                             f"(grid has {self.num_columns})")
        for r in self.rows:
            r[column1] = r[column1] + join_with + r[column2]
        self.remove_columns(column2)

    def split(self, column: int, sep_by: str) -> None:
        """Split a column in place, widening the grid."""
        new_rows = []
        width = None
        for r in self.rows:
            parts = r[column].split(sep_by)
            row = r[:column] + parts + r[column + 1:]
            if width is None:
                width = len(row)
            elif len(row) != width:
                raise ValueError("split produced ragged rows")
            new_rows.append(row)
        self.rows = new_rows
        self.num_columns = width or self.num_columns

    def fill_down(self, value: str, column: int) -> None:
        for r in self.rows:
            r[column] = value

    def prepend_to_each(self, prepend: str, column: int) -> None:
        for r in self.rows:
            r[column] = prepend + r[column]

    def append_to_each(self, append: str, column: int) -> None:
        for r in self.rows:
            r[column] = r[column] + append

    def add_row(self, row: List[str]) -> None:
        if len(row) != self.num_columns:
            raise ValueError("row width mismatch")
        self.rows.append(list(row))

    def add_column(self, column: List[str]) -> None:
        if len(column) != len(self.rows):
            raise ValueError("column length mismatch")
        for r, v in zip(self.rows, column):
            r.append(v)
        self.num_columns += 1

    def map_by_primary_key(self, column: int) -> Dict[str, List[List[str]]]:
        out: Dict[str, List[List[str]]] = defaultdict(list)
        for r in self.rows:
            out[r[column]].append(r)
        return dict(out)

    # -------------------------------------------------------------- dedupe
    def cluster_column(self, column: int) -> StringCluster:
        return StringCluster(self.get_column(column))

    def get_rows_with_duplicate_values_in_column(
            self, column: int) -> "StringGrid":
        counts: Dict[str, int] = defaultdict(int)
        for r in self.rows:
            counts[r[column]] += 1
        return StringGrid(self.sep, self.num_columns,
                          [r for r in self.rows if counts[r[column]] > 1])

    def dedupe_by_cluster(self, column: int) -> None:
        """Keep one row per fingerprint cluster of the column (the most
        frequent spelling wins — reference dedupeByCluster keeps the
        cluster representative)."""
        cluster = self.cluster_column(column)
        chosen = {}
        for key, spellings in cluster.clusters.items():
            chosen[key] = max(spellings.items(), key=lambda kv: kv[1])[0]
        seen = set()
        kept = []
        for r in self.rows:
            key = fingerprint(r[column])
            if key in seen:
                continue
            seen.add(key)
            r = list(r)
            r[column] = chosen[key]
            kept.append(r)
        self.rows = kept

    def dedupe_by_cluster_all(self) -> None:
        for c in range(self.num_columns):
            self.dedupe_by_cluster(c)

    # ---------------------------------------------------------- similarity
    def get_all_with_similarity(self, threshold: float, first_column: int,
                                second_column: int) -> "StringGrid":
        """Rows whose two columns are at least `threshold` similar
        (difflib ratio in [0,1] replaces the reference's JaroWinkler)."""
        rows = [r for r in self.rows
                if difflib.SequenceMatcher(
                    None, r[first_column], r[second_column]).ratio()
                >= threshold]
        return StringGrid(self.sep, self.num_columns, rows)

    def filter_by_similarity(self, threshold: float, first_column: int,
                             second_column: int) -> None:
        self.rows = self.get_all_with_similarity(
            threshold, first_column, second_column).rows
