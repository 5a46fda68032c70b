"""Two-level UK Countryside Survey habitat taxonomy (a copy of
``aihab_clip_tpu/taxonomy.py``; the port imports nothing of that package).

The reference scatters the L3/L2 label spaces across several dict constants
(aihab-clip `data/__init__.py:28-133`).  Here the taxonomy is a single
source-of-truth table of (L3 id, L3 name, L2 id) records from which every
map/list is derived, so the two levels can never drift apart.

Label-space facts (dataset constants, identical to the reference):
  * 20 L3 classes with *reassigned* contiguous ids 0..19.
  * 11 L2 (EUNIS-level) classes with ids 0..10.
  * The original CS survey ids (0..22 with gaps) are kept for CSV ingestion.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

# L2 label space (id -> name), ordered by id.
L2_NAMES: List[str] = [
    "Urban",                                    # 0
    "Woodland and Forest",                      # 1
    "Cropland",                                 # 2
    "Grassland",                                # 3
    "Heathland and Shrub",                      # 4
    "Wetland",                                  # 5
    "Marine Inlets and Transitional Waters",    # 6
    "Sparsely Vegetated Land",                  # 7
    "Rivers and Lakes",                         # 8
    "Sea",                                      # 9
    "Montane",                                  # 10
]

NAME_LABEL_L2: Dict[str, int] = {n: i for i, n in enumerate(L2_NAMES)}

# Single source of truth: (reassigned L3 id, L3 name, L2 id, original CS id).
# The "original" column is the raw CS survey numbering (with gaps / unused
# ids); the reassigned ids are the contiguous training label space.
_TAXONOMY: List[Tuple[int, str, int, int]] = [
    (0,  "Urban",                               0,  17),
    (1,  "Broadleaved Mixed and Yew Woodland",  1,  1),
    (2,  "Coniferous Woodland",                 1,  2),
    (3,  "Sea",                                 9,  22),
    (4,  "Arable and Horticulture",             2,  4),
    (5,  "Improved Grassland",                  3,  5),
    (6,  "Neutral Grassland",                   3,  6),
    (7,  "Calcareous Grassland",                3,  7),
    (8,  "Acid Grassland",                      3,  8),
    (9,  "Bracken",                             3,  9),
    (10, "Dwarf Shrub Heath",                   4,  10),
    (11, "Fen, Marsh, Swamp",                   5,  11),
    (12, "Bog",                                 5,  12),
    (13, "Littoral Rock",                       6,  20),
    (14, "Littoral Sediment",                   6,  21),
    (15, "Montane",                             10, 15),
    (16, "Standing Open Waters and Canals",     8,  13),
    (17, "Inland Rock",                         7,  16),
    (18, "Supra-littoral Rock",                 7,  18),
    (19, "Supra-littoral Sediment",             7,  19),
]

NUM_L3 = len(_TAXONOMY)
NUM_L2 = len(L2_NAMES)

# Derived maps (parity with the reference's dict constants).
REASSIGN_LABEL_NAME_L3: Dict[int, str] = {i: n for i, n, _, _ in _TAXONOMY}
REASSIGN_NAME_LABEL_L3: Dict[str, int] = {n: i for i, n, _, _ in _TAXONOMY}
REASSIGN_NAME_LABEL_L3L2: Dict[str, Tuple[int, int]] = {
    n: (i, l2) for i, n, l2, _ in _TAXONOMY
}
ORIGINAL_NAME_LABEL_L3: Dict[str, int] = {n: o for _, n, _, o in _TAXONOMY}
ORIGINAL_LABEL_NAME_L3: Dict[int, str] = {o: n for _, n, _, o in _TAXONOMY}

# Ordered L3 classnames (0..N-1) — the classifier head ordering.
CS_CLASSNAMES: List[str] = [n for _, n, _, _ in sorted(_TAXONOMY)]

# "Boundary and Linear Features" is a CS plot label with no L3 class of its
# own; samples fall back to their polygon label during ingestion.
BOUNDARY_PLOT_LABEL = "Boundary and Linear Features"

# Images known to be corrupt in the CS release; skipped during bulk load.
CORRUPT_IMAGES = [
    "ATT3735_594XX3_2023_photo2-20230928-121257.jpg",
]

NAME_ABB_L2: Dict[str, str] = {
    "Urban": "U",
    "Woodland and forest": "WLF",
    "Cropland": "CL",
    "Grassland": "GL",
    "Heathland and shrub": "HS",
    "Wetland": "WL",
    "Marine inlets and transitional waters": "MITW",
    "Sparsely vegetated land": "SVL",
    "Rivers and lakes": "RL",
    "Sea": "S",
    "Montane": "M",
}


def build_l3_to_l2_map() -> Tuple[List[int], List[str]]:
    """Return (l3_to_l2 lookup indexed by L3 id, L2 names indexed by L2 id)."""
    l3_to_l2 = [l2 for _, _, l2, _ in sorted(_TAXONOMY)]
    return l3_to_l2, list(L2_NAMES)


def l3_to_l2_array() -> np.ndarray:
    """The L3 -> L2 lookup as an int32 array (device-friendly gather table)."""
    l3_to_l2, _ = build_l3_to_l2_map()
    return np.asarray(l3_to_l2, dtype=np.int32)


def l2_names_to_l3(l2_names: Sequence[str]) -> Tuple[List[str], List[int]]:
    """Expand L2 names into the ordered L3 (names, ids) they contain."""
    if not l2_names:
        return [], []
    norm = {k.lower(): v for k, v in NAME_LABEL_L2.items()}
    missing = [n for n in l2_names if n.lower() not in norm]
    if missing:
        raise ValueError(
            f"Unknown L2 names: {missing}. Expected one of: {L2_NAMES}")
    wanted = {norm[n.lower()] for n in l2_names}
    pairs = sorted((i, n) for i, n, l2, _ in _TAXONOMY if l2 in wanted)
    return [n for _, n in pairs], [i for i, _ in pairs]


def l3_values_to_ids(
    values: Union[str, int, Sequence[Union[str, int]], None],
) -> Tuple[List[str], List[int]]:
    """Normalize a subset spec (names and/or ids) into sorted (names, ids)."""
    if not values:
        return [], []
    if isinstance(values, (str, int)):
        values = [values]

    name_to_id = {k.lower(): v for k, v in REASSIGN_NAME_LABEL_L3.items()}
    ids: List[int] = []
    missing: List[str] = []
    for v in values:
        if isinstance(v, (int, np.integer)):
            ids.append(int(v))
        elif isinstance(v, str):
            s = v.strip()
            if s.isdigit():
                ids.append(int(s))
            elif s.lower() in name_to_id:
                ids.append(name_to_id[s.lower()])
            else:
                missing.append(v)
        else:
            raise ValueError(f"Unsupported L3 subset value type: {type(v)} ({v})")

    if missing:
        raise ValueError(
            f"Unknown L3 names: {missing}. Expected one of: {CS_CLASSNAMES}")
    bad = [i for i in ids if not 0 <= i < NUM_L3]
    if bad:
        raise ValueError(f"Unknown L3 ids: {bad}. Expected 0..{NUM_L3 - 1}")

    ids = sorted(set(ids))
    return [REASSIGN_LABEL_NAME_L3[i] for i in ids], ids


def convert_to_coarse_label(word_label: str) -> int:
    """Map an L3 word label to its L2 id (-1 when unknown)."""
    pair = REASSIGN_NAME_LABEL_L3L2.get(word_label)
    return pair[1] if pair is not None else -1
