"""The slice as a whole: a model written to the converted cache by the JAX
package classifies the same uint8 batch in both ``ClassifierEngine``s,
and the port's ``DynamicBatcher`` answers single-image requests; the wire,
the engines' decodes, the HTTP servers and the serve and predict CLIs of
both packages answer alike on the same weights."""

import base64
import csv
import http.client
import io
import json

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import aihab_clip_tpu.models.zoo as jax_zoo
from aihab_clip_tpu.data import make_synthetic_cs_dataset as jax_synthetic
from aihab_clip_tpu.models import CLIPConfig as JaxConfig
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine
from aihab_clip_tpu.serving import PredictServer as JaxServer
from aihab_clip_tpu.serving import _parse_binary_batch as jax_parse_batch
from aihab_clip_tpu.serving import encode_binary_batch as jax_encode_batch
from aihab_clip_tpu.tools.predict import main as jax_predict

import aihab_clip_tpu_torch.models.zoo as zoo
from aihab_clip_tpu_torch.serving import (ClassifierEngine, DynamicBatcher,
                                          PredictServer, ServerStats,
                                          _parse_binary_batch,
                                          encode_binary_batch)
from aihab_clip_tpu_torch.tools.predict import main as predict
from aihab_clip_tpu_torch.tools.serve import build_server

NAME = "torch-serving-vit"
CFG = dict(embed_dim=32, image_resolution=32, vision_layers=2,
           vision_width=128, vision_patch_size=8, context_length=77,
           vocab_size=49408, transformer_width=64, transformer_heads=1,
           transformer_layers=2)


@pytest.fixture(scope="module")
def model_root(tmp_path_factory):
    """A converted-model cache holding NAME, written by the JAX package."""
    root = tmp_path_factory.mktemp("cache")
    bundle = jax_zoo.load("random:" + NAME, random_cfg=JaxConfig(**CFG),
                          seed=5)
    npz = jax_zoo._npz_cache_path(NAME, root)
    npz.parent.mkdir(parents=True)
    save_params_npz(npz, bundle.params)
    jax_zoo._save_config(jax_zoo._config_cache_path(NAME, root), bundle.config)
    return root


@pytest.fixture(scope="module")
def engines(model_root):
    root = model_root
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_zoo, "default_cache_root", lambda: root)
    mp.setattr(zoo, "default_cache_root", lambda: root)
    try:
        ref = JaxEngine(model=NAME, batch_size=4, flat=True, verbose=False)
        port = ClassifierEngine(model=NAME, batch_size=4, flat=True,
                                verbose=False, device="cpu")
    finally:
        mp.undo()
    return ref, port


def test_engine_matches_jax(engines):
    ref, port = engines
    assert port.bundle.source == "npz-cache"
    assert (port.decode_dim, port.bucket_sizes) == (ref.decode_dim,
                                                    ref.bucket_sizes)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3),
                                             dtype=np.uint8)
    want = ref.classify_batch(imgs)
    got = port.classify_batch(imgs)
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert port.topk(got, 2)[0][0]["name"] == ref.topk(want, 2)[0][0]["name"]


def test_text_head_matches_jax(engines):
    ref, port = engines
    np.testing.assert_allclose(port._text_weights.numpy(),
                               np.asarray(ref._text_weights), atol=1e-5)


def test_dynamic_batcher_answers(engines):
    _, port = engines
    port.warmup()
    assert port.warm
    imgs = np.random.default_rng(1).integers(0, 256, (6, 224, 224, 3),
                                             dtype=np.uint8)
    stats = ServerStats()
    batcher = DynamicBatcher(port, max_wait_ms=20.0, stats=stats)
    batcher.start()
    try:
        futures = [batcher.submit(img) for img in imgs]
        probs = np.stack([f.result(timeout=60) for f in futures])
    finally:
        batcher.stop()
    assert all(not t.is_alive() for t in batcher._threads)
    direct = np.concatenate([port.classify_batch(imgs[:4]),
                             port.classify_batch(imgs[4:])])
    np.testing.assert_allclose(probs, direct, atol=1e-6)
    snap = stats.snapshot(port.batch_size)
    assert stats.batch_fill == 6 and snap["batches"] >= 2
    assert 0 < snap["mean_batch_fill"] <= 1


def test_dispatch_rejects_bad_shapes(engines):
    _, port = engines
    with pytest.raises(ValueError, match="expected"):
        port.classify_dispatch(np.zeros((3, 224, 224, 3), np.uint8))
    assert port.bucket_for(3) == 4 and port.bucket_for(99) == 4


# ---------------------------------------------------------------------------
# the wire, the decodes, the servers and the CLIs against JAX's


def _photo(h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(128, 60, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(x + rng.normal(0, 10, x.shape), 0, 255).astype(np.uint8)


def _encode(img, ext=".jpg") -> bytes:
    return cv2.imencode(ext, img)[1].tobytes()


@settings(max_examples=60, deadline=None)
@given(blobs=st.lists(st.binary(max_size=40), max_size=6),
       cut=st.integers(0, 9))
def test_binary_wire_matches_jax(blobs, cut):
    """The same framing bytes, and the same blobs or the same error for
    whole, cut and overlong bodies."""
    body = encode_binary_batch(blobs)
    assert body == jax_encode_batch(blobs)
    for b in (body, body[:max(0, len(body) - cut)], body + b"x" * (cut % 3)):
        outcomes = []
        for parse in (_parse_binary_batch, jax_parse_batch):
            try:
                outcomes.append(("blobs", parse(b)))
            except ValueError as e:
                outcomes.append(("error", str(e)))
        assert outcomes[0] == outcomes[1]


def test_decode_matches_jax_engine(engines, tmp_path, monkeypatch):
    """decode_bytes, decode_blobs and decode_file against the JAX engine's
    on a mixed request: JPEGs bit for bit (libjpeg with the prescale, m =
    8, 4, 2 and 1 here), PNGs within one level (cv2.resize against the
    fixed-point resize); full scale under AIHAB_SERVE_DECODE=cv2 and in
    decode_file, within one level; garbage is None in both."""
    ref, port = engines
    assert 2 * port.decode_dim == 448
    jpegs = [_encode(_photo(h, w, i)) for i, (h, w) in enumerate(
        [(480, 640), (1000, 1400), (1800, 1900), (3700, 3900)])]
    pngs = [_encode(_photo(50, 70, 5), ".png"),
            _encode(_photo(300, 200, 6), ".png")]
    blobs = [jpegs[0], pngs[0], jpegs[1], jpegs[2], pngs[1], jpegs[3],
             b"garbage"]
    mine, theirs = port.decode_blobs(blobs), ref.decode_blobs(blobs)
    assert mine[-1] is None and theirs[-1] is None
    for b, a, r in zip(blobs[:-1], mine, theirs):
        assert a.shape == r.shape == (224, 224, 3) and a.dtype == np.uint8
        d = np.abs(a.astype(int) - r.astype(int)).max()
        assert d == 0 if b in jpegs else d <= 1
    for b, a in zip(blobs, mine):
        one = port.decode_bytes(b)
        assert (one is None) if a is None else np.array_equal(one, a)
    for i, b in enumerate(jpegs[:2] + pngs):
        path = tmp_path / f"{i}.{'jpg' if b in jpegs else 'png'}"
        path.write_bytes(b)
        d = np.abs(port.decode_file(str(path)).astype(int)
                   - ref.decode_file(str(path)).astype(int))
        assert d.max() <= 1
    assert port.decode_file(str(tmp_path / "missing.jpg")) is None
    monkeypatch.setenv("AIHAB_SERVE_DECODE", "cv2")
    for b in jpegs[:2]:
        d = np.abs(port.decode_bytes(b).astype(int)
                   - ref.decode_bytes(b).astype(int))
        assert d.max() <= 1


@pytest.fixture(scope="module")
def servers(engines):
    """JAX's server and the port's, each over its engine on the same
    weights."""
    ref, port = engines
    pair = (JaxServer(ref, port=0, max_wait_ms=20.0, verbose=False),
            PredictServer(port, port=0, max_wait_ms=20.0, verbose=False))
    for srv in pair:
        srv.serve_background()
    yield pair
    for srv in pair:
        srv.stop()


def _request(port, method, path, body=None, ctype=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body,
                 headers={"Content-Type": ctype} if ctype else {})
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def _same_predictions(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        if "error" in pb:
            assert pa == pb
            continue
        assert [r["label"] for r in pa["topk"]] == \
            [r["label"] for r in pb["topk"]]
        assert [r["name"] for r in pa["topk"]] == \
            [r["name"] for r in pb["topk"]]
        np.testing.assert_allclose([r["prob"] for r in pa["topk"]],
                                   [r["prob"] for r in pb["topk"]], atol=1e-4)


def test_server_answers_as_jax(servers):
    """The three wires, the routes and the errors: the same answers from
    both servers (top-k labels equal, probabilities within 1e-4)."""
    js, ps = servers
    big = _encode(_photo(1000, 1400, 1))
    square = _encode(_photo(224, 224, 2))
    png = _encode(_photo(224, 224, 3), ".png")
    b64 = [base64.b64encode(b).decode() for b in (square, b"junk", png)]
    requests = [
        ("POST", "/predict", big, "image/jpeg"),
        ("POST", "/predict", png, "image/png"),
        ("POST", "/predict", b"not an image", "image/jpeg"),
        ("POST", "/predict", json.dumps({"images_b64": b64}),
         "application/json"),
        ("POST", "/predict", encode_binary_batch([big, square, b"x", png]),
         "application/x-aihab-batch"),
        ("POST", "/predict", b"{broken", "application/json"),
        ("POST", "/predict", json.dumps({"images_b64": ["!!!"]}),
         "application/json"),
        ("POST", "/predict", json.dumps({"images": []}), "application/json"),
        ("POST", "/predict", b"\x01", "application/x-aihab-batch"),
        ("POST", "/predict", encode_binary_batch([big])[:-3],
         "application/x-aihab-batch"),
        ("POST", "/nope", big, "image/jpeg"),
        ("GET", "/nope", None, None),
        ("GET", "/healthz", None, None)]
    for req in requests:
        (ca, pa), (cb, pb) = (_request(ps.server_port, *req),
                              _request(js.server_port, *req))
        assert ca == cb, req[:2]
        if "predictions" in pb:
            _same_predictions(pa["predictions"], pb["predictions"])
        else:
            assert pa == pb
    for srv in servers:
        srv.max_request_images = 2
    try:
        req = ("POST", "/predict", encode_binary_batch([square] * 3),
               "application/x-aihab-batch")
        assert _request(ps.server_port, *req) == \
            _request(js.server_port, *req)
        assert _request(ps.server_port, *req)[0] == 413
    finally:
        for srv in servers:
            srv.max_request_images = 256
    sa = _request(ps.server_port, "GET", "/stats")[1]
    sb = _request(js.server_port, "GET", "/stats")[1]
    assert set(sa) == set(sb)
    for key in ("requests", "images", "decode_failures"):
        assert sa[key] == sb[key], key
    assert sa["decode_failures"] == 3


def test_served_probs_equal_engine(servers):
    """An answer equals the engine's classify_batch on the engine's decode
    of the same blob."""
    _, ps = servers
    blob = _encode(_photo(700, 900, 4))
    code, payload = _request(ps.server_port, "POST", "/predict", blob,
                             "image/jpeg")
    direct = ps.engine.classify_batch(ps.engine.decode_bytes(blob)[None])[0]
    assert code == 200
    for rec in payload["predictions"][0]["topk"]:
        assert direct[rec["label"]] == pytest.approx(rec["prob"], abs=1e-5)


def test_bad_blobs_fail_alone_in_a_request(servers):
    """A header-cut JPEG, a progressive JPEG, a PNG whose IHDR no longer
    matches its CRC and an arithmetic-coded JPEG in one request with good
    blobs: the good ones, the progressive one and the arithmetic-coded one
    (which JAX's native path decodes) are answered as by JAX's server,
    the cut one and the PNG are "undecodable image" in both; the two count
    as decode failures."""
    js, ps = servers
    good = [_encode(_photo(300, 400, 7)), _encode(_photo(224, 224, 8), ".png")]
    cut = good[0][:good[0].index(b"\xff\xc0") + 8]
    prog = cv2.imencode(".jpg", _photo(64, 64, 9),
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    adam7 = bytearray(good[1])
    adam7[28] = 1                       # IHDR's interlace method
    arith = bytearray(good[0])
    arith[arith.index(b"\xff\xc0") + 1] = 0xC9    # SOF9
    blobs = [good[0], cut, prog, good[1], bytes(adam7), bytes(arith)]
    before = _request(ps.server_port, "GET", "/stats")[1]["decode_failures"]
    req = ("POST", "/predict", encode_binary_batch(blobs),
           "application/x-aihab-batch")
    (ca, pa), (cb, pb) = (_request(ps.server_port, *req),
                          _request(js.server_port, *req))
    assert ca == cb == 200
    mine, theirs = pa["predictions"], pb["predictions"]
    _same_predictions([mine[i] for i in (0, 2, 3, 5)],
                      [theirs[i] for i in (0, 2, 3, 5)])
    assert "topk" in mine[5]
    for i in (1, 4):
        assert mine[i] == theirs[i] == {"error": "undecodable image"}
    after = _request(ps.server_port, "GET", "/stats")[1]["decode_failures"]
    assert after - before == 2


def test_serve_cli_builds_server(tmp_path):
    """The CLI wires its flags through to a working server; without
    --device cpu and without a card it raises."""
    srv = build_server(["--model", "random:Tiny", "--port", "0",
                        "--batch_size", "2", "--flat", "--topk", "2",
                        "--device", "cpu"])
    try:
        srv.serve_background()
        code, payload = _request(srv.server_port, "POST", "/predict",
                                 _encode(_photo(64, 80)), "image/jpeg")
        assert code == 200 and len(payload["predictions"][0]["topk"]) == 2
        assert srv.engine.device == torch.device("cpu")
    finally:
        srv.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_server(["--model", "random:Tiny", "--port", "0"])
    # --lora: the adapters merged into the served weights
    from aihab_clip_tpu_torch.models.convert import port_adapters_to_flax
    from aihab_clip_tpu_torch.train.lora import lora_init, lora_merge

    base = build_server(["--model", "random:Tiny", "--port", "0",
                         "--device", "cpu"]).engine.bundle.model
    adapters = lora_init(base, 2, torch.Generator().manual_seed(1))
    for ab in adapters.values():
        ab["b"].data.normal_(generator=torch.Generator().manual_seed(2))
    path = tmp_path / "lora_adapters.npz"
    np.savez(path, **port_adapters_to_flax(adapters))
    srv = build_server(["--model", "random:Tiny", "--port", "0", "--device",
                        "cpu", "--lora", str(path), "--lora_alpha", "4"])
    want = lora_merge(dict(base.named_parameters()), adapters, 4.0)
    for name, p in srv.engine.bundle.model.named_parameters():
        assert torch.equal(p, want[name]), name
    assert any(not torch.equal(want[n], p) for n, p in base.named_parameters())


def test_predict_cli_matches_jax(model_root, tmp_path, monkeypatch):
    """Both CLIs over one folder (224 px photos: the resize is the
    identity in both, so the pixels agree): the same CSV but for the
    probability digits, within 1e-4; the port's file has the bytes of
    pandas' to_csv on its rows."""
    monkeypatch.setattr(jax_zoo, "default_cache_root", lambda: model_root)
    monkeypatch.setattr(zoo, "default_cache_root", lambda: model_root)
    synth = jax_synthetic(tmp_path, n_train_per_class=1, n_test_per_class=1,
                          image_size=224)
    args = ["--images", synth["test_dir"], "--model", NAME, "--batch_size",
            "4", "--topk", "3", "--flat"]
    jax_predict(args + ["--out", str(tmp_path / "jax.csv")])
    rows = predict(args + ["--out", str(tmp_path / "port.csv"), "--device",
                           "cpu"])
    mine = (tmp_path / "port.csv").read_text()
    assert mine == pd.DataFrame(rows).to_csv(index=False)
    a = list(csv.reader(io.StringIO(mine)))
    b = list(csv.reader(io.StringIO((tmp_path / "jax.csv").read_text())))
    assert a[0] == b[0] and len(a) == len(b) > 2
    probs = [i for i, col in enumerate(a[0]) if col.endswith("_prob")]
    for ra, rb in zip(a[1:], b[1:]):
        assert [v for i, v in enumerate(ra) if i not in probs] == \
            [v for i, v in enumerate(rb) if i not in probs]
        np.testing.assert_allclose([float(ra[i]) for i in probs],
                                   [float(rb[i]) for i in probs], atol=1e-4)
