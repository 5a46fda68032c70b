"""CSV index ingestion: file name -> habitat labels (counterpart of
``aihab_clip_tpu/data/index.py``), read with the ``csv`` module.

The CSV is parsed once into a hash index keyed by lowercased file name.
Label semantics are the JAX package's:
  * rows without a valid BH_PLOT_DESC are dropped (empty or one of
    pandas' default missing-value spellings, as ``pd.read_csv`` reads them);
  * the plot description maps to the reassigned L3 id (unknown -> None);
  * "Boundary and Linear Features" plots fall back to the polygon label;
  * the plot ID (survey square/plot identifier) is the grouping key for
    stratified-group splits.  Its values take pandas' column typing (all
    integers -> int, numbers with gaps -> float, else str with NaN gaps),
    so a group key's ``str`` equals the JAX package's.
"""

from __future__ import annotations

import csv
import dataclasses
import io
import math
import re
from pathlib import Path
from typing import Dict, List, Optional

from ..taxonomy import BOUNDARY_PLOT_LABEL, REASSIGN_NAME_LABEL_L3L2

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT_RE = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT_RE = re.compile(
    r"^\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*$",
    re.IGNORECASE)
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}


def _typed_column(values: List[str]) -> List[object]:
    """One CSV column with ``pd.read_csv``'s default typing."""
    missing = [v in NA_VALUES for v in values]
    present = [v for v, m in zip(values, missing) if not m]
    if not present:
        return [math.nan] * len(values)
    if not any(missing) and all(_INT_RE.match(v) for v in present):
        return [int(v) for v in values]
    if all(_FLOAT_RE.match(v) for v in present):
        return [math.nan if m else float(v) for v, m in zip(values, missing)]
    if not any(missing) and all(v.strip() in _TRUE | _FALSE for v in present):
        return [v.strip() in _TRUE for v in values]
    return [math.nan if m else v for v, m in zip(values, missing)]


def read_csv_columns(path: str | Path) -> Dict[str, List[object]]:
    """A CSV with a header row -> {column: typed values}."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        return parse_csv_columns(f.read())


def parse_csv_columns(text: str) -> Dict[str, List[object]]:
    """``read_csv_columns`` of a CSV's text."""
    rows = list(csv.reader(io.StringIO(text.lstrip("\ufeff"), newline="")))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    cols = {}
    for j, name in enumerate(header):
        cols[name] = _typed_column([r[j] if j < len(r) else "" for r in body])
    return cols


def _isna(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


@dataclasses.dataclass
class ImageRecord:
    plot_label: Optional[int]      # reassigned L3 id (None if unlabeled)
    plot_word_label: str
    poly_label: Optional[int]
    poly_word_label: str
    plot_id: object                # grouping key (survey plot)


class LabelIndex:
    """Hash index over an index CSV (columns: file, BH_PLOT_DESC,
    optionally BH_POLYDESC, ID)."""

    def __init__(self, csv_path: str | Path, verbose: bool = False):
        self.csv_path = Path(csv_path)
        cols = read_csv_columns(self.csv_path)
        self._records: Dict[str, ImageRecord] = {}
        self._verbose = verbose
        n = len(cols["file"])
        files = [str(f).lower() for f in cols["file"]]
        plot_desc = cols["BH_PLOT_DESC"]
        ids = cols.get("ID", [""] * n)
        poly_desc = cols.get("BH_POLYDESC", [""] * n)

        for fname, pdesc, pid, odesc in zip(files, plot_desc, ids, poly_desc):
            if _isna(pdesc) or pdesc == "":
                continue  # invalid row: no plot description
            if fname in self._records:
                if verbose:
                    print(f"Warning: Multiple entries found for {fname}")
                continue  # keep the first valid row

            odesc = "" if _isna(odesc) else str(odesc)
            poly_pair = REASSIGN_NAME_LABEL_L3L2.get(odesc)
            poly_label = poly_pair[0] if poly_pair else None

            pdesc = str(pdesc)
            plot_pair = REASSIGN_NAME_LABEL_L3L2.get(pdesc)
            plot_label = plot_pair[0] if plot_pair else None
            if plot_label is None and verbose:
                print(f"Unrecognized label {pdesc} found in the dataset")

            # boundary plots have no habitat class: the polygon label
            if pdesc == BOUNDARY_PLOT_LABEL:
                plot_label = poly_label
                pdesc = odesc

            self._records[fname] = ImageRecord(
                plot_label=plot_label, plot_word_label=pdesc,
                poly_label=poly_label, poly_word_label=odesc, plot_id=pid)

    def lookup(self, image_name: str) -> Optional[ImageRecord]:
        return self._records.get(image_name.lower())

    def __len__(self) -> int:
        return len(self._records)
