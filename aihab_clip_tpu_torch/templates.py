"""Prompt templates and prompt-ensemble generation for the CS habitat classes.

A copy of ``aihab_clip_tpu/templates.py`` (the port imports nothing of
that package).  Capability parity with aihab-clip `data/templates.py`: the *prompt
strings* (templates + per-class descriptive attributes) are dataset-tuned
text and must match the reference exactly for zero-shot accuracy parity;
the generation logic is re-implemented around a single attribute table.

Prompt modes (selected via ``gen_prompts``):
  * flat:            "a habitat photo of {l3}."
  * hierarchical:    "a habitat photo of {l2}, specifically {l3}"
  * descriptive:     the above plus ", attr, attr, attr, attr" when the class
                     has a descriptive attribute entry.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .taxonomy import (
    CS_CLASSNAMES,
    L2_NAMES,
    REASSIGN_NAME_LABEL_L3L2,
)

# Flat prompt ensemble (one active template; the commented alternatives in the
# reference are intentionally not carried over — they were disabled there too).
CS_TEMPLATES: List[str] = [
    "a habitat photo of {}.",
]

# Hierarchical (L2 + L3) base templates.
CS_HIER_TEMPLATES: List[str] = [
    "a habitat photo of {l2}, specifically {l3}",
]

# Descriptive template variants (attrs appended).
DESC_TEMPLATES: List[str] = [
    "a habitat photo of {habitat}, {attrs}",
]

HIER_DESC_TEMPLATES: List[str] = [
    "a habitat photo of {l2}, specifically {l3}, {attrs}",
]

# Per-class descriptive phrases (joined in order into the prompt tail).
# The exact phrases are the reference prompt set - accuracy-parity data.
DESCRIPTIVE_L3_ATTRS: Dict[str, Tuple[str, ...]] = {
    "Improved Grassland": (
        "short to medium vegetation height",
        "very even close-cropped sward",
        "grass-dominated",
        "few forbs",
    ),
    "Neutral Grassland": (
        "medium to tall vegetation height",
        "mixed uneven meadow sward",
        "herbs-dominated",
        "moderate to high forbs",
    ),
    "Calcareous Grassland": (
        "short vegetation height",
        "close-cropped open turf",
        "fine grasses and herbs dominated",
        "high forb richness",
    ),
    "Acid Grassland": (
        "short to medium vegetation height",
        "patchy or tussocky sward",
        "fine grasses dominated",
        "low to moderate forbs",
    ),
    "Bracken": (
        "tall vegetation height",
        "dense canopy of fronds",
        "bracken fronds",
        "low forb richness",
    ),
    "Fen, Marsh, Swamp": (
        "tall emergent wetland herbs and sedges",
        "sedges, rushes, reeds and wetland herbs",
        "dense emergent cover with wet channels or patches",
        "waterlogged to shallowly inundated",
    ),
    "Bog": (
        "low open mossy vegetation with scattered dwarf shrubs",
        "bog-moss and cotton-grass",
        "hummocky surface with small wet hollows",
        "persistently waterlogged",
    ),
    "Dwarf Shrub Heath": (
        "low dwarf shrubs (<1.5 m)",
        "dwarf-shrub dominated, low woody canopy",
        "heather/ericoids and dwarf gorse",
        "patchy heather with moss/lichen and bare ground",
    ),
    "Arable and Horticulture": (
        "regular planted rows or plots with uniform spacing",
        "arable crops or horticultural plantings",
        "tilled or ploughed soil with furrows and stubble",
        "actively cultivated or rotational fallow",
    ),
    "Broadleaved Mixed and Yew Woodland": (
        "tall broadleaved canopy, irregular and layered",
        "broad leaves with some evergreen yew",
        "dappled light through mixed canopy",
        "leaf-littered forest floor",
    ),
    "Coniferous Woodland": (
        "tall conifer canopy, often uniform or plantation-like",
        "needle-leaved evergreen conifers",
        "darker, more shaded understory",
        "needle litter with sparse ground vegetation or moss",
    ),
    "Littoral Rock": (
        "exposed rock platforms or boulder shores",
        "hard, uneven rock with crevices and pools",
        "bare rock with algal and barnacle encrustation",
        "intertidal, regularly wetted and exposed",
    ),
    "Littoral Sediment": (
        "sand, mud or gravel flats",
        "flat, soft sediment with ripples",
        "mostly bare sediment with sparse algal film",
        "intertidal flats, regularly inundated and exposed",
    ),
    "Montane": (
        "low wind-clipped vegetation above treeline",
        "dwarf shrubs with moss, lichen and short grasses",
        "rocky ground with thin soils and bare patches",
        "open, treeless, exposed upland ridges",
    ),
    "Standing Open Waters and Canals": (
        "open water body or straight canal",
        "still or slow-moving open water",
        "defined banks or engineered canal edges",
        "floating or submerged plants with narrow fringe",
    ),
    "Inland Rock": (
        "exposed inland rock, cliffs or scree",
        "hard rock faces with fissures and ledges",
        "mostly bare rock with sparse crevice plants",
        "dry, wind-exposed inland slopes",
    ),
    "Supra-littoral Rock": (
        "coastal rock above the high-tide line",
        "rugged rock with spray-wet surfaces",
        "salt-tolerant lichens or algae, sparse vegetation",
        "wave-splash zone with salt spray",
    ),
    "Supra-littoral Sediment": (
        "coastal sand, shingle or pebbles",
        "loose granular sediment with ridges",
        "sparse salt-tolerant pioneer plants",
        "above high tide, exposed to spray and wind",
    ),
    "Urban": (
        "dense built structures, walls and roofs",
        "sealed hard surfaces like concrete or asphalt",
        "little vegetation or small landscaped patches",
        "roads, kerbs, fences or utilities",
    ),
    "Sea": (
        "open marine water to the horizon",
        "rolling waves or choppy surface",
        "open water with minimal vegetation",
        "distant coastline or open sea view",
    ),
}

_ID_NAME_L2 = {i: n for i, n in enumerate(L2_NAMES)}


def _format_attrs(attrs: Tuple[str, ...]) -> str:
    return ", ".join(attrs)


def gen_prompts(
    use_hierarchy: bool = True,
    use_descriptive: bool = True,
    verbose: bool = False,
) -> Tuple[List[str], int]:
    """Build the flattened [class x template] prompt list.

    Returns (prompts, templates_per_class) where ``prompts`` is ordered by
    L3 class id (outer) then template (inner).
    """
    if use_hierarchy:
        base_templates = CS_HIER_TEMPLATES
        desc_templates = HIER_DESC_TEMPLATES
    else:
        base_templates = CS_TEMPLATES
        desc_templates = DESC_TEMPLATES

    if use_descriptive and len(base_templates) != len(desc_templates):
        raise ValueError(
            "Descriptive templates enabled but template counts differ: "
            f"{len(desc_templates)} (descriptive) vs {len(base_templates)} "
            "(base); every base template needs a descriptive counterpart."
        )

    templates_per_class = len(desc_templates) if use_descriptive else len(base_templates)

    prompts: List[str] = []
    for l3 in CS_CLASSNAMES:
        l3_clean = l3.replace("_", " ")
        l2 = None
        if use_hierarchy:
            _, l2_id = REASSIGN_NAME_LABEL_L3L2[l3]
            l2 = _ID_NAME_L2[l2_id]
        attrs = DESCRIPTIVE_L3_ATTRS.get(l3_clean) if use_descriptive else None

        class_prompts: List[str] = []
        if attrs is not None:
            attrs_text = _format_attrs(attrs)
            for tmpl in desc_templates:
                if use_hierarchy:
                    class_prompts.append(tmpl.format(l2=l2, l3=l3_clean, attrs=attrs_text))
                else:
                    class_prompts.append(tmpl.format(habitat=l3_clean, attrs=attrs_text))
        else:
            for tmpl in base_templates:
                if use_hierarchy:
                    class_prompts.append(tmpl.format(l3=l3_clean, l2=l2))
                else:
                    class_prompts.append(tmpl.format(l3_clean))

        if verbose and use_descriptive:
            preview = class_prompts[: min(2, len(class_prompts))]
            print(f"[gen_prompts] {l3_clean}: {preview}")

        prompts.extend(class_prompts)

    return prompts, templates_per_class
