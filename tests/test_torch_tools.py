"""The port's tools (``aihab_clip_tpu_torch/tools``, ``examples``) against
the JAX package's (``aihab_clip_tpu/tools``, the root ``examples/``): the
sweep launcher's override parsing, config and run name; the grid runner's
expansion, dry run and an end-to-end run on ``random:Tiny``; the column
table against pandas; both outlier scorers, their selection and the
cleaned split, read back through ``pd.read_csv``; the cleaning and
visualisation CLIs; the examples; the modules without the host libraries
the card's machine lacks; every CLI's default device."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from threadpoolctl import threadpool_limits
import yaml
from sklearn.cluster import KMeans

from aihab_clip_tpu.tools import cs_clean_testset as jax_cs
from aihab_clip_tpu.tools import outlier_cleaning as jax_oc
from aihab_clip_tpu.tools import run_ft_sweep as jax_sweep
from aihab_clip_tpu.tools import run_grid as jax_grid

from aihab_clip_tpu_torch.config import load_configs, safe_load
from aihab_clip_tpu_torch.tools import cs_clean_testset as cs
from aihab_clip_tpu_torch.tools import feat_vis
from aihab_clip_tpu_torch.tools import outlier_cleaning as oc
from aihab_clip_tpu_torch.tools import run_ft_sweep as sweep
from aihab_clip_tpu_torch.tools import run_grid as grid
from aihab_clip_tpu_torch.tools.table import Table

ROOT = Path(__file__).resolve().parents[1]
SWEEPS = ["sweeps/openclip_ft.yaml", "sweeps/lora_ft.yaml"]
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread and one OpenMP/BLAS thread (scikit-learn's t-SNE and
    k-means): the suite runs several workers at once, and the many small
    steps of t-SNE and k-means spin when their thread pools oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------- sweeps

OVERRIDE_CASES = [
    ["--lr_v=1e-4", "--finetune.unlocked_groups", "5", "--seed=3"],
    ["--a=b=c", "--empty="], [], ["--x", "--y"],
    ["positional"], ["--dangling"], ["--k", "v", "stray"],
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("argv", OVERRIDE_CASES, ids=str)
def test_parse_overrides_matches_jax(argv):
    assert _outcome(sweep.parse_overrides, argv) == \
        _outcome(jax_sweep.parse_overrides, argv)


def _typed(obj):
    """A config tree as plain dicts with each leaf's type, so 1, 1.0 and
    True differ."""
    if isinstance(obj, dict):
        return {k: _typed(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [type(obj).__name__] + [_typed(v) for v in obj]
    return (type(obj).__name__, obj)


OVERRIDES = [("lr_v", "1e-4"), ("finetune.unlocked_groups", "5"),
             ("finetune.tune_text", "false"), ("seed", "3"),
             ("new.nested.key", "7"), ("train_epoch", "abc"),
             ("backbone", "random:Tiny"), ("data.batch_size", "8"),
             ("finetune.lora_rank", "16"), ("data.dataset_paths", "['x']"),
             ("wandb_project", "None"), ("finetune.new_leaf", "0.5")]


@pytest.mark.parametrize("dataset", ["configs/cs.yaml",
                                     "configs/synthetic_smoke.yaml"])
def test_load_cfg_with_overrides_matches_jax(dataset):
    args = argparse.Namespace(base_config="configs/base.yaml",
                              dataset_config=dataset)
    got = sweep.load_cfg_with_overrides(args, OVERRIDES)
    want = jax_sweep.load_cfg_with_overrides(args, OVERRIDES)
    assert _typed(got) == _typed(want)
    assert sweep.sweep_run_name(got) == jax_sweep.sweep_run_name(want)
    for cfg in ({}, {"finetune": {"unlocked_groups": 3}, "dataset": "cs",
                     "backbone": "ViT-B/16", "shots": 4},
                {"open_clip_model": "hf-hub:timm/x/ViT-L-14", "seed": 9}):
        assert sweep.sweep_run_name(cfg) == jax_sweep.sweep_run_name(cfg)


def test_parse_known_takes_the_device():
    args, unknown = sweep.parse_known(["--device", "cpu", "--seed=2",
                                       "--inspect_only"])
    assert args.device == "cpu" and args.inspect_only
    assert sweep.parse_overrides(unknown) == [("seed", "2")]


@pytest.mark.parametrize("path", SWEEPS)
def test_expand_grid_matches_jax_on_the_repo_sweeps(path):
    text = (ROOT / path).read_text()
    assert _typed(safe_load(text)) == _typed(yaml.safe_load(text))
    got = grid.expand_grid(safe_load(text))
    assert _typed(got) == _typed(jax_grid.expand_grid(yaml.safe_load(text)))
    assert len(got) == {"sweeps/openclip_ft.yaml": 25,
                        "sweeps/lora_ft.yaml": 108}[path]
    single = {"parameters": {"a": {"value": 1}, "b": {"values": [1, 2]}}}
    assert grid.expand_grid(single) == jax_grid.expand_grid(single)
    bad = {"parameters": {"a": {"min": 1}}}
    for fn in (grid.expand_grid, jax_grid.expand_grid):
        with pytest.raises(ValueError, match="has no 'values'/'value'"):
            fn(bad)


def test_run_grid_dry_run_matches_jax(tmp_path):
    kw = dict(limit=7, dry_run=True, out_csv=str(tmp_path / "r.csv"))
    got = grid.run_grid(SWEEPS[1], "configs/base.yaml",
                        "configs/synthetic_smoke.yaml", device="cpu", **kw)
    want = jax_grid.run_grid(SWEEPS[1], "configs/base.yaml",
                             "configs/synthetic_smoke.yaml", **kw)
    assert _typed(got) == _typed(want) and len(got) == 7
    assert not (tmp_path / "r.csv").exists()


def _grid_base(tmp_path):
    """JAX's test_run_grid base config over a synthetic tree."""
    from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset

    synth = make_synthetic_cs_dataset(tmp_path, n_train_per_class=4,
                                      n_test_per_class=2, image_size=40)
    base = tmp_path / "base.yaml"
    base.write_text(
        (ROOT / "tests/test_run_grid.py").read_text()
        .split('base.write_text(f"""')[1].split('""")')[0]
        .replace("{tmp_path}", str(tmp_path))
        .replace('{synth["train_dir"]}', synth["train_dir"])
        .replace("{{", "{").replace("}}", "}"))
    sweep_path = tmp_path / "sweep.yaml"
    sweep_path.write_text("metric: {name: top1_acc, goal: maximize}\n"
                          "parameters:\n  lr_v: {value: 0.001}\n"
                          "  seed: {values: [1, 2]}\n")
    return str(base), str(sweep_path)


def test_run_grid_end_to_end_against_jax(tmp_path):
    base, sweep_path = _grid_base(tmp_path)
    out, jax_out = tmp_path / "port.csv", tmp_path / "jax.csv"
    rows = grid.run_grid(sweep_path, base, base, out_csv=str(out),
                         device="cpu")
    jax_grid.run_grid(sweep_path, base, base, out_csv=str(jax_out))
    got, want = pd.read_csv(out), pd.read_csv(jax_out)
    assert list(got.columns) == list(want.columns) == [
        "run", "lr_v", "seed", "top1_acc", "top3_acc", "f1", "mcc", "loss"]
    assert len(got) == len(want) == 2
    assert np.isfinite(got[["top1_acc", "loss"]].to_numpy()).all()
    # sorted by the metric, maximizing; ties compared as sets
    top1 = got["top1_acc"].to_numpy()
    assert (np.diff(top1) <= 0).all()
    for value in np.unique(top1):
        assert set(got["run"][top1 == value]) == set(
            r["run"] for r in rows if r["top1_acc"] == value)
    assert sorted(got["run"]) == sorted(want["run"])
    # the bytes pandas writes for the same rows, stably sorted
    text = pd.DataFrame(rows).sort_values(
        "top1_acc", ascending=False, kind="stable").to_csv(index=False)
    assert out.read_text() == text


# ----------------------------------------------------------- column table

def test_table_matches_pandas(tmp_path):
    rng = np.random.default_rng(5)
    n = 300
    key = rng.integers(0, 7, n)
    vals = np.round(rng.standard_normal(n), 1).astype(np.float32)  # ties
    words = np.asarray([f"f{i % 37:03d}" for i in rng.permutation(n)],
                       dtype=object)
    t = Table({"k": key, "v": vals, "w": words})
    df = pd.DataFrame({"k": key, "v": vals, "w": words})
    np.testing.assert_array_equal(
        t.group_rank_first("k", "v"),
        df.groupby("k")["v"].rank(method="first", ascending=False)
        .astype(int).to_numpy())
    np.testing.assert_array_equal(
        t.group_quantile("k", "v", 0.05),
        df.groupby("k")["v"].transform(lambda c: c.quantile(0.05))
        .to_numpy())
    order = t.sort_values(["v", "k", "w"], [False, True, True])
    ref = df.sort_values(by=["v", "k", "w"], ascending=[False, True, True])
    np.testing.assert_array_equal(order["w"], ref["w"].to_numpy())
    np.testing.assert_array_equal(t.map("k", {i: 10 * i for i in range(7)}),
                                  df["k"].map({i: 10 * i for i in range(7)}))
    # the bytes of to_csv(index=False), missing cells and dtypes included
    rows = [{"run": "a,b", "x": 1, "f": np.float32(0.1), "b": True},
            {"run": 'q"q', "y": 2.5, "x": 3, "b": False},
            {"run": "", "f": np.float32(1e-7), "z": None, "b": None},
            {"run": "ü", "x": 4, "y": np.nan, "f": np.float32(3)}]
    Table.from_rows(rows).to_csv(tmp_path / "t.csv")
    assert (tmp_path / "t.csv").read_text() == \
        pd.DataFrame(rows).to_csv(index=False)
    # read back (pandas parses exactly with float_precision="round_trip")
    back = Table.read_csv(tmp_path / "t.csv")
    back.to_csv(tmp_path / "u.csv")
    assert (tmp_path / "u.csv").read_text() == pd.read_csv(
        tmp_path / "t.csv", float_precision="round_trip").to_csv(index=False)


# ---------------------------------------------------------------- scorers

def _toy_embeddings(rng, n_per_class=40, c=3, dim=16, outliers_per_class=2):
    """JAX's draw (tests/test_tools.py:19)."""
    protos = rng.standard_normal((c, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
    embs, labels, files = [], [], []
    outlier_names = []
    for ci in range(c):
        x = protos[ci] + 0.05 * rng.standard_normal((n_per_class, dim))
        for j in range(outliers_per_class):
            x[j] = protos[(ci + 1) % c] + 0.05 * rng.standard_normal(dim)
            outlier_names.append(f"c{ci}_{j:03d}.jpg")
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        embs.append(x)
        labels.extend([ci] * n_per_class)
        files.extend(f"c{ci}_{j:03d}.jpg" for j in range(n_per_class))
    meta = {"file_name": files, "ground_truth_num_label": labels,
            "ground_truth_word_label": [f"class{l}" for l in labels],
            "ground_truth_L2_num_label": labels}
    return (np.concatenate(embs, 0).astype(np.float32), np.asarray(labels),
            meta, set(outlier_names))


BAND_SIZES = [12, 45, 150, 250, 330]   # one class in every heuristic_k band


def _band_embeddings(rng, dim=24, spread=0.25):
    """Classes of several modes each, one per ``heuristic_k`` band, 3% of
    each class planted from another class; unnormalised (the scorer
    normalises and warns)."""
    c = len(BAND_SIZES)
    modes = rng.standard_normal((c, 3, dim))
    embs, labels, files, planted = [], [], [], set()
    for ci, n in enumerate(BAND_SIZES):
        x = modes[ci, rng.integers(0, 3, n)] + spread * rng.standard_normal(
            (n, dim))
        for j in range(max(1, n * 3 // 100)):
            x[j] = modes[(ci + 2) % c, 0] + spread * rng.standard_normal(dim)
            planted.add(f"b{ci}_{j:04d}.jpg")
        embs.append(x * rng.uniform(0.5, 2.0, (n, 1)))
        labels += [ci] * n
        files += [f"b{ci}_{j:04d}.jpg" for j in range(n)]
    order = rng.permutation(len(labels))
    labels = np.asarray(labels)[order]
    meta = {"file_name": [files[i] for i in order],
            "ground_truth_num_label": labels.tolist(),
            "ground_truth_word_label": [f"w{l}" for l in labels],
            "ground_truth_L2_num_label": (labels % 2).tolist()}
    return (np.concatenate(embs, 0)[order].astype(np.float32), labels, meta,
            planted)


DRAWS = {"toy": lambda: _toy_embeddings(np.random.default_rng(0)),
         "bands": lambda: _band_embeddings(np.random.default_rng(1))}


def _read_back(scores, path):
    if isinstance(scores, pd.DataFrame):
        scores.to_csv(path, index=False)
    else:
        scores.to_csv(path)
    return pd.read_csv(path)


def _compare_scores(got, want, sim_col):
    """Port and JAX score tables (read back): equal columns; per file the
    strings, ints and bools equal and floats within TOL, except ranks, and
    the order, between rows whose scores lie within TOL, and flags of rows
    within TOL of their class quantile.  Returns the near-tie rows."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    assert set(got["file_name"]) == set(want["file_name"])
    g = got.set_index("file_name")
    w = want.set_index("file_name").loc[g.index]
    score = w["outlier_score"].to_numpy()
    cls = w["ground_truth_num_label"].to_numpy()

    def near(i):
        same = (cls == cls[i]) & (np.arange(len(cls)) != i)
        return bool((np.abs(score[same] - score[i]) <= TOL).any())

    ties = 0
    rank_off = g["rank_in_class"].to_numpy() != w["rank_in_class"].to_numpy()
    for i in np.flatnonzero(rank_off):
        assert near(i), g.index[i]
        ties += 1
    q05 = w.groupby("ground_truth_num_label")[sim_col].transform(
        lambda c: c.quantile(0.05)).to_numpy()
    flag_off = g["is_bottom_5pct"].to_numpy() != w["is_bottom_5pct"].to_numpy()
    for i in np.flatnonzero(flag_off):
        assert abs(w[sim_col].to_numpy()[i] - q05[i]) <= TOL
        ties += 1
    for col in g.columns:
        a, b = g[col].to_numpy(), w[col].to_numpy()
        if col in ("rank_in_class", "pct_rank_in_class", "is_bottom_5pct"):
            keep = ~(rank_off | flag_off)
            a, b = a[keep], b[keep]
        assert a.dtype.kind == b.dtype.kind, col
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=col)
        else:
            np.testing.assert_array_equal(a, b, err_msg=col)
    # the row order: positions that differ hold near-tied scores
    pos = got["file_name"].to_numpy() != want["file_name"].to_numpy()
    js = want.set_index("file_name")["outlier_score"]
    assert np.abs(js.loc[got["file_name"][pos]].to_numpy()
                  - want["outlier_score"][pos].to_numpy()).max(
        initial=0.0) <= TOL
    print(f"[scores] {int(rank_off.sum())} rank and {int(flag_off.sum())} "
          f"flag differences, all between scores within {TOL:g}")
    return ties


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_single_centroid_scorer_matches_jax(draw, tmp_path, capsys):
    emb, labels, meta, planted = DRAWS[draw]()
    port = oc.SingleCentroidScorer(emb, labels, meta, device="cpu")
    scores = port.score_centroid_distance()
    out = capsys.readouterr().out
    ref = jax_oc.SingleCentroidScorer(emb, labels, pd.DataFrame(meta))
    want = ref.score_centroid_distance()
    assert out == capsys.readouterr().out   # the same warning, or none
    assert list(scores.columns) == oc.CENTROID_COLUMNS
    _compare_scores(_read_back(scores, tmp_path / "p.csv"),
                    _read_back(want, tmp_path / "j.csv"), "sim_to_centroid")
    flagged = set(scores["file_name"][scores["is_bottom_5pct"]])
    jax_flagged = set(want["file_name"][want["is_bottom_5pct"]])
    assert flagged & planted == jax_flagged & planted
    if draw == "toy":
        assert set(scores["file_name"][:len(planted)]) == planted
    cres = port.compute_centroids()
    jres = ref.compute_centroids()
    assert cres.class_counts == jres.class_counts
    for label, c in jres.centroids.items():
        np.testing.assert_allclose(cres.centroids[label], c, atol=TOL)


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_prototype_scoring_of_jax_prototypes_matches_jax(draw, tmp_path):
    emb, labels, meta, _ = DRAWS[draw]()
    ref = jax_oc.MultiPrototypeScorer(emb, labels, pd.DataFrame(meta))
    jres = ref.compute_prototypes()
    want = ref.score_prototype_distance()
    port = oc.MultiPrototypeScorer(emb, labels, meta, device="cpu")
    given = oc.MultiPrototypeResult(**{
        f.name: getattr(jres, f.name)
        for f in oc.dataclasses.fields(oc.MultiPrototypeResult)})
    scores = port.score_prototype_distance(given)
    assert list(scores.columns) == oc.PROTO_COLUMNS
    _compare_scores(_read_back(scores, tmp_path / "p.csv"),
                    _read_back(want, tmp_path / "j.csv"), "sim_to_prototype")


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_multi_prototype_scorer_against_jax(draw):
    emb, labels, meta, planted = DRAWS[draw]()
    port = oc.MultiPrototypeScorer(emb, labels, meta, device="cpu")
    pres = port.compute_prototypes()
    ref = jax_oc.MultiPrototypeScorer(emb, labels, pd.DataFrame(meta))
    jres = ref.compute_prototypes()
    assert pres.k_per_class == jres.k_per_class
    assert pres.class_counts == jres.class_counts
    if draw == "bands":
        assert sorted(pres.k_per_class.values()) == [1, 3, 4, 4, 4]
        assert [oc.heuristic_k(n) for n in BAND_SIZES] == [1, 3, 4, 5, 6]
    got, want = port.score_prototype_distance(), ref.score_prototype_distance()
    np.testing.assert_array_equal(got["class_size"], want["class_size"]
                                  .to_numpy()[np.argsort(want["file_name"])]
                                  [np.argsort(np.argsort(got["file_name"]))])
    flagged = set(got["file_name"][got["is_bottom_5pct"]])
    jax_flagged = set(want["file_name"][want["is_bottom_5pct"]])
    assert flagged & planted == jax_flagged & planted
    # each class's k-means from its own first initial centres against
    # scikit-learn's from the same centres
    x = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    for label, run in port.kmeans_runs.items():
        xc = x[labels == label]
        km = KMeans(n_clusters=run.init.shape[1], init=run.init[0].numpy(),
                    n_init=1, max_iter=100).fit(xc)
        one = oc.kmeans(torch.from_numpy(xc), run.init.shape[1],
                        init=run.init[0])
        np.testing.assert_allclose(one.centers.numpy(), km.cluster_centers_,
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(one.labels.numpy(), km.labels_)
    assert port.kmeans_runs
    # with one prototype a class, the planted rows point at another class
    one = oc.MultiPrototypeScorer(emb, labels, meta, device="cpu")
    one.compute_prototypes(k_mode="fixed", k_fixed=1)
    s1 = one.score_prototype_distance()
    neg = set(s1["file_name"][s1["margin_to_other_class"] < 0])
    ref1 = jax_oc.MultiPrototypeScorer(emb, labels, pd.DataFrame(meta))
    ref1.compute_prototypes(k_mode="fixed", k_fixed=1)
    j1 = ref1.score_prototype_distance()
    assert neg == set(j1["file_name"][j1["margin_to_other_class"] < 0])
    assert planted <= neg or draw == "bands"
    with pytest.raises(ValueError, match="Unsupported k_mode"):
        port.compute_prototypes(k_mode="bogus")


def test_select_outliers_modes_match_jax(tmp_path):
    emb, labels, meta, _ = DRAWS["bands"]()
    ref = jax_oc.MultiPrototypeScorer(emb, labels, pd.DataFrame(meta))
    ref.compute_prototypes()
    want = ref.score_prototype_distance()
    want.to_csv(tmp_path / "s.csv", index=False)
    scores = Table.read_csv(tmp_path / "s.csv")
    for kw in ({"mode": "bottom_pct", "pct": 0.05},
               {"mode": "threshold", "threshold": 0.3},
               {"mode": "margin", "margin_threshold": 0.05}):
        got = oc.select_outliers(scores, **kw)
        sel = jax_oc.select_outliers(pd.read_csv(tmp_path / "s.csv"), **kw)
        assert list(got["file_name"]) == list(sel["file_name"]), kw
        assert len(sel) > 0
    single = Table.read_csv(tmp_path / "s.csv").select(
        [c for c in oc.CENTROID_COLUMNS if c != "sim_to_centroid"])
    for fn, s in ((oc.select_outliers, single),
                  (jax_oc.select_outliers,
                   pd.read_csv(tmp_path / "s.csv")[single.columns])):
        with pytest.raises(ValueError, match="multi-prototype"):
            fn(s, mode="margin", margin_threshold=0.0)
        with pytest.raises(ValueError, match="requires threshold"):
            fn(s, mode="threshold")
        with pytest.raises(ValueError, match="Unsupported selection"):
            fn(s, mode="bogus")


def _image_folder(root):
    root.mkdir()
    for i in range(8):
        (root / f"IMG_{i}.jpg").write_bytes(b"\xff\xd8jpeg" + bytes([i]))
    (root / "notes.txt").write_text("not an image")
    (root / "index.csv").write_text(
        "file,BH_PLOT_DESC,ID,score,flag\n"
        + "".join(f"IMG_{i}.jpg,\"Urban, dense\",P{i % 3},"
                  f"{'' if i == 2 else i / 4},{i % 2 == 0}\n"
                  for i in range(8)))


@pytest.mark.parametrize("copy", [True, False])
def test_materialize_clean_split_matches_jax(tmp_path, copy):
    src = tmp_path / "src"
    _image_folder(src)
    drop = ["img_1.jpg", "IMG_4.JPG", "missing.jpg"]
    got = oc.materialize_clean_split(Table({"file_name": drop}), src,
                                     tmp_path / "port", "index.csv", copy)
    want = jax_oc.materialize_clean_split(
        pd.DataFrame({"file_name": drop}), src, tmp_path / "jax",
        "index.csv", copy)
    assert got == want == {"kept": 6, "dropped": 2}
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert (tmp_path / "port/index.csv").read_text() == \
        (tmp_path / "jax/index.csv").read_text()


def _write_cache(root, emb, labels, meta):
    root.mkdir(parents=True)
    np.save(root / "embeddings.npy", emb)
    np.save(root / "labels.npy", labels.astype(np.int32))
    pd.DataFrame(meta).to_csv(root / "metadata.csv", index=False)
    (root / "meta.json").write_text(json.dumps({"split": "test"}))


def test_cs_clean_testset_cli_matches_jax(tmp_path, capsys):
    emb, labels, meta, _ = DRAWS["toy"]()
    cache = tmp_path / "cache"
    _write_cache(cache, emb, labels, meta)
    cs.main(["score", "--device", "cpu", "--cache_dir", str(cache),
             "--out", str(tmp_path / "p.csv")])
    out = capsys.readouterr().out
    jax_cs.main(["score", "--cache_dir", str(cache),
                 "--out", str(tmp_path / "j.csv")])
    assert out.replace("p.csv", "j.csv") == capsys.readouterr().out
    _compare_scores(pd.read_csv(tmp_path / "p.csv"),
                    pd.read_csv(tmp_path / "j.csv"), "sim_to_centroid")
    got = cs.main(["score", "--device", "cpu", "--cache_dir", str(cache),
                   "--scorer", "multi", "--k_mode", "fixed", "--k_fixed",
                   "2"])
    assert list(got.columns) == oc.PROTO_COLUMNS and len(got) == len(labels)
    for pkg, prefix in ((cs, "p"), (jax_cs, "j")):
        argv = ["select", "--scores", str(tmp_path / "j.csv"), "--mode",
                "bottom_pct", "--out", str(tmp_path / f"{prefix}_sel.csv")]
        pkg.main(argv[:1] + (["--device", "cpu"] if pkg is cs else [])
                 + argv[1:])
    assert (tmp_path / "p_sel.csv").read_text() == \
        (tmp_path / "j_sel.csv").read_text()
    src = tmp_path / "src"
    _image_folder(src)
    for pkg, prefix in ((cs, "p"), (jax_cs, "j")):
        argv = ["materialize", "--selected", str(tmp_path / "p_sel.csv"),
                "--src_dir", str(src), "--dst_dir", str(tmp_path / prefix),
                "--index_file", "index.csv", "--link"]
        pkg.main(argv[:1] + (["--device", "cpu"] if pkg is cs else [])
                 + argv[1:])
    capsys.readouterr()
    assert (tmp_path / "p/index.csv").read_text() == \
        (tmp_path / "j/index.csv").read_text()


# ------------------------------------------------------------- feat_vis

def test_feat_vis_cli_falls_back_from_umap(tmp_path, capsys):
    emb, labels, meta, _ = _toy_embeddings(np.random.default_rng(0),
                                           n_per_class=20)
    cache = tmp_path / "cache"
    _write_cache(cache, emb, labels, meta)
    info = feat_vis.main(["--cache_dir", str(cache), "--method", "umap",
                          "--pca_dim", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[warn] umap-learn not installed; falling back to t-SNE" in out
    assert info["method"] == "tsne"
    assert sorted(p.name for p in cache.glob("vis_*")) == [
        "vis_tsne.html", "vis_tsne_coords.npy"]
    coords = np.load(cache / "vis_tsne_coords.npy")
    assert coords.shape == (len(labels), 2) and np.isfinite(coords).all()
    page = (cache / "vis_tsne.html").read_text()
    assert page.count("<circle") == len(labels)
    assert "<script" not in page and "http://" not in page.replace(
        'xmlns="http://www.w3.org/2000/svg"', "")
    legend = [s.split(">")[-1] for s in page.split("</text></g>")[:-1]]
    assert legend == sorted(set(meta["ground_truth_word_label"]))
    assert page.count("<title>class0</title>") == 20
    assert "TSNE of cache (60 pts)" in page
    # JAX's tool names its files the same way on the same fallback
    from aihab_clip_tpu.tools.feat_vis import reduce_to_2d

    _, method = reduce_to_2d(emb, "umap", pca_dim=8)
    assert method == "tsne"
    coords2, method2 = feat_vis.reduce_to_2d(emb, "tsne", pca_dim=8,
                                             device="cpu")
    np.testing.assert_array_equal(coords2, coords)


# ------------------------------------------------------------- examples

def _run_jax_example(name, argv=()):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def test_examples_run_on_the_cpu(tmp_path, capsys, monkeypatch):
    from aihab_clip_tpu_torch.examples import prolip_cached_features
    from aihab_clip_tpu_torch.examples import split_data
    from aihab_clip_tpu_torch.runner import run

    monkeypatch.chdir(tmp_path)
    (tmp_path / "configs").symlink_to(ROOT / "configs")
    _run_jax_example("split_data")
    want = capsys.readouterr().out
    split_data.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert "per-class counts (train / val):" in got
    assert got == want.split("generating synthetic dataset ...\n")[1]

    cfg = load_configs("configs/base.yaml", "configs/synthetic_smoke.yaml",
                       ["clip_backend", "openai", "backbone", "random:Tiny",
                        "search_lr", "False", "save_features", "True",
                        "aug_views", "3", "train_epoch", "1",
                        "wandb_project", "None"])
    run(cfg, device="cpu")
    capsys.readouterr()
    accs = prolip_cached_features.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "cache: 3 views of" in out and "test accuracy:" in out
    assert all(np.isfinite(v) for v in accs.values())


# ------------------------------------------- imports and default devices

def test_tools_run_without_the_host_libraries(tmp_path):
    code = f"""
import sys
for m in ("pandas", "sklearn", "cv2", "yaml", "matplotlib", "plotly",
          "umap", "jax"):
    sys.modules[m] = None
import numpy as np, torch
from aihab_clip_tpu_torch.examples import prolip_cached_features, split_data
from aihab_clip_tpu_torch.ops import edges, kmeans, tsne
from aihab_clip_tpu_torch.tools import (cs_clean_testset, feat_vis,
                                        outlier_cleaning, run_ft_sweep,
                                        run_grid, table)
rows = run_grid.run_grid("sweeps/openclip_ft.yaml", "configs/base.yaml",
                         "configs/cs.yaml", dry_run=True, device="cpu")
assert len(rows) == 25
rng = np.random.default_rng(0)
x = rng.standard_normal((90, 12)).astype(np.float32)
lab = np.repeat(np.arange(3), 30)
meta = {{"file_name": [f"f{{i}}.jpg" for i in range(90)]}}
s = outlier_cleaning.MultiPrototypeScorer(x, lab, meta, device="cpu")
s.compute_prototypes()
s.score_prototype_distance().to_csv({str(tmp_path / "s.csv")!r})
y = tsne.tsne(torch.from_numpy(x), perplexity=10.0)
feat_vis.plot_scatter(y.embedding.numpy(), lab, {str(tmp_path / "v.html")!r},
                      "t")
img = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8))
edges.edge_blend(img)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


CLIS = [
    ("run_ft_sweep", lambda: sweep.main(["--seed=2"])),
    ("run_grid", lambda: grid.main(["--sweep", SWEEPS[0], "--dry_run"])),
    ("cs_clean_testset select", lambda: cs.main(
        ["select", "--scores", "x.csv", "--out", "y.csv"])),
    ("cs_clean_testset score", lambda: cs.main(["score", "--cache_dir", "x"])),
    ("feat_vis", lambda: feat_vis.main(["--cache_dir", "x"])),
    ("scorer", lambda: oc.SingleCentroidScorer(
        np.eye(2, dtype=np.float32), [0, 1], {"file_name": ["a", "b"]})),
    ("split_data", lambda: __import__(
        "aihab_clip_tpu_torch.examples.split_data",
        fromlist=["main"]).main([])),
    ("prolip_cached_features", lambda: __import__(
        "aihab_clip_tpu_torch.examples.prolip_cached_features",
        fromlist=["main"]).main([])),
]


@pytest.mark.parametrize("name,call", CLIS, ids=[c[0] for c in CLIS])
def test_clis_default_to_the_card(name, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
