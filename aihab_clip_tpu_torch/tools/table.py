"""A small column table for the offline tools: a dict of numpy columns with
the few pandas operations ``aihab_clip_tpu``'s tools use, in pandas'
semantics (the card's machine has no pandas):

  * ``group_rank_first`` — ``groupby(key)[col].rank(method="first",
    ascending=False)``: ties ranked in order of appearance;
  * ``group_quantile`` — ``groupby(key)[col].transform(lambda c:
    c.quantile(q))``: numpy's linear interpolation on the values as fp64;
  * ``map`` — ``Series.map(dict)``;
  * ``sort_values`` — the stable multi-key sort of ``DataFrame.sort_values``
    with several keys (missing values last);
  * ``to_csv`` — ``DataFrame.to_csv(index=False)``: a header, minimal
    quoting, ``\\n`` line ends, numpy floats by ``str`` (the shortest repr
    of their own width), missing values empty.

Reading goes through ``data.index.read_csv_columns``, which types columns
as ``pd.read_csv`` does.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np

from ..data.index import read_csv_columns


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def column_from_values(values: Sequence) -> np.ndarray:
    """Python values -> the numpy column pandas would build: bool, int64
    (float64 once a value is missing), float64, else object."""
    present = [v for v in values if not _is_missing(v)]
    missing = len(present) < len(values)
    if present and all(isinstance(v, (bool, np.bool_)) for v in present):
        return np.asarray(values, dtype=object if missing else bool)
    if present and all(isinstance(v, (int, np.integer))
                       and not isinstance(v, (bool, np.bool_))
                       for v in present) and not missing:
        return np.asarray(values, dtype=np.int64)
    if present and all(isinstance(v, (int, float, np.integer, np.floating))
                       and not isinstance(v, (bool, np.bool_))
                       for v in present):
        return np.asarray([math.nan if _is_missing(v) else v for v in values],
                          dtype=np.float64)
    return np.asarray(values, dtype=object)


def _cell(v):
    if _is_missing(v):
        return ""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, np.floating):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, np.integer):
        return str(int(v))
    return v


def _sort_codes(col: np.ndarray, ascending: bool) -> np.ndarray:
    """Integer codes whose ascending order is the key's order, missing
    values last either way."""
    vals = col.tolist()
    present = sorted({v for v in vals if not _is_missing(v)})
    rank = {v: i for i, v in enumerate(present)}
    n = len(present)
    return np.asarray([n if _is_missing(v)
                       else (rank[v] if ascending else n - 1 - rank[v])
                       for v in vals], dtype=np.int64)


class Table:
    """Named numpy columns of one length, in insertion order."""

    def __init__(self, columns: Mapping[str, Sequence] = ()):
        self._cols: Dict[str, np.ndarray] = {}
        for name, values in dict(columns).items():
            self[name] = values

    @classmethod
    def from_rows(cls, rows: Sequence[Mapping]) -> "Table":
        """``pd.DataFrame(rows)``: columns in order of first appearance, a
        missing cell missing."""
        names: List[str] = []
        for row in rows:
            names += [k for k in row if k not in names]
        return cls({n: column_from_values([row.get(n) for row in rows])
                    for n in names})

    @classmethod
    def read_csv(cls, path) -> "Table":
        return cls({name: column_from_values(values)
                    for name, values in read_csv_columns(path).items()})

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name: str, values) -> None:
        arr = (values if isinstance(values, np.ndarray)
               else column_from_values(list(values)))
        if arr.ndim == 0:
            arr = np.full(len(self), arr.item(),
                          dtype=object if isinstance(arr.item(), str)
                          else arr.dtype)
        if self._cols and len(arr) != len(self):
            raise ValueError(f"column {name!r} has {len(arr)} rows, the "
                             f"table {len(self)}")
        self._cols[name] = arr

    def copy(self) -> "Table":
        return Table({n: c.copy() for n, c in self._cols.items()})

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self._cols[n] for n in names})

    def take(self, indices) -> "Table":
        idx = np.asarray(indices, dtype=np.int64)
        return Table({n: c[idx] for n, c in self._cols.items()})

    def filter(self, mask) -> "Table":
        return self.take(np.flatnonzero(np.asarray(mask, dtype=bool)))

    def map(self, name: str, mapping: Mapping) -> np.ndarray:
        return column_from_values([mapping[v] for v in self._cols[name]
                                   .tolist()])

    def sort_values(self, by: Sequence[str],
                    ascending: Sequence[bool]) -> "Table":
        """The stable multi-key sort (ties keep their order)."""
        keys = [_sort_codes(self._cols[n], a) for n, a in zip(by, ascending)]
        return self.take(np.lexsort(keys[::-1]))

    def groups(self, key: str) -> Iterator[Tuple[object, np.ndarray]]:
        """(key value, row indices) per group, in sorted key order."""
        col = self._cols[key]
        for value in sorted(set(col.tolist())):
            yield value, np.flatnonzero(col == value)

    def group_rank_first(self, key: str, name: str,
                         ascending: bool = False) -> np.ndarray:
        """Rank within each group, ties in order of appearance."""
        vals = self._cols[name]
        ranks = np.zeros(len(self), dtype=np.int64)
        for _, idx in self.groups(key):
            v = vals[idx]
            order = np.argsort(v if ascending else -v, kind="stable")
            ranks[idx[order]] = np.arange(1, len(idx) + 1)
        return ranks

    def group_quantile(self, key: str, name: str, q: float) -> np.ndarray:
        """Each row's group quantile of ``name`` (linear, on fp64)."""
        vals = self._cols[name].astype(np.float64)
        out = np.empty(len(self), dtype=np.float64)
        for _, idx in self.groups(key):
            out[idx] = np.quantile(vals[idx], q)
        return out

    def to_csv(self, path) -> None:
        with open(Path(path), "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            cols = list(self._cols.values())
            for i in range(len(self)):
                w.writerow([_cell(c[i]) for c in cols])
