"""Plain float32 reference of the CLIP-family classifier: the towers, the
eval transform, the prompt-ensemble text head and the softmax.

It follows the published architectures, written from their equations:

* ``siglip``: SigLIP / SigLIP2 (Zhai et al. 2023, Tschannen et al. 2025;
  HF ``SiglipModel``): a stride-p patch convolution with bias, learned
  positions, pre-LN blocks (separate q/k/v/out projections, tanh GELU MLP,
  LayerNorm eps 1e-6), ``ln_post``, the MAP head (one learned probe attends
  over the tokens, then ``x + mlp(ln(x))``); the text tower is
  bidirectional, pools the last position and ends in a dense ``head``.
* ``clip_vit``: OpenAI CLIP ViT (Radford et al. 2021): a patch convolution
  without bias, a class token, ``ln_pre``, pre-LN blocks (packed qkv,
  QuickGELU, eps 1e-5), ``ln_post`` on the class token and ``proj``; the
  text tower is causal and pools at the end-of-text token (the largest id).

Everything runs in float32 with TF32 off.  The module imports only torch and
numpy; the parameter names are the state-dict keys of the towers, so one
seeded dictionary of tensors serves the program and this reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
HALF = (0.5, 0.5, 0.5)


def full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# parameters: (name, shape, mean, std) of every leaf, from the widths alone


def _linear(name: str, n_out: int, n_in: int) -> List[Tuple]:
    return [(f"{name}.weight", (n_out, n_in), 0.0, n_in ** -0.5),
            (f"{name}.bias", (n_out,), 0.0, 0.02)]


def _ln(name: str, width: int) -> List[Tuple]:
    return [(f"{name}.weight", (width,), 1.0, 0.1),
            (f"{name}.bias", (width,), 0.0, 0.02)]


def _siglip_attn(name: str, w: int) -> List[Tuple]:
    out = []
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out += _linear(f"{name}.{proj}", w, w)
    return out


def _block(prefix: str, w: int, hidden: int, family: str) -> List[Tuple]:
    out = _ln(f"{prefix}.ln_1", w)
    if family == "siglip":
        out += _siglip_attn(f"{prefix}.attn", w)
    else:
        out += [(f"{prefix}.attn.in_proj_weight", (3 * w, w), 0.0, w ** -0.5),
                (f"{prefix}.attn.in_proj_bias", (3 * w,), 0.0, 0.02)]
        out += _linear(f"{prefix}.attn.out_proj", w, w)
    out += _ln(f"{prefix}.ln_2", w)
    out += _linear(f"{prefix}.mlp.c_fc", hidden, w)
    out += _linear(f"{prefix}.mlp.c_proj", w, hidden)
    return out


def weight_spec(cfg: dict) -> List[Tuple]:
    """Every parameter of the model as (name, shape, mean, std): weights
    normal at 1/sqrt(fan_in), biases N(0, 0.02), LayerNorm scales
    N(1, 0.1) and shifts N(0, 0.02), embeddings as the families
    initialise them."""
    fam, v, t = cfg["family"], cfg["vision"], cfg["text"]
    w, p, res = v["hidden_size"], v["patch_size"], v["image_size"]
    n_tok = (res // p) ** 2
    wt, e = t["hidden_size"], cfg["embed_dim"]
    spec: List[Tuple] = [("visual.conv1.weight", (w, 3, p, p), 0.0,
                          (3 * p * p) ** -0.5)]
    if fam == "siglip":
        spec += [("visual.conv1.bias", (w,), 0.0, 0.02),
                 ("visual.positional_embedding", (n_tok, w), 0.0, w ** -0.5)]
    else:
        spec += [("visual.class_embedding", (w,), 0.0, w ** -0.5),
                 ("visual.positional_embedding", (n_tok + 1, w), 0.0,
                  w ** -0.5)]
        spec += _ln("visual.ln_pre", w)
    for i in range(v["num_hidden_layers"]):
        spec += _block(f"visual.transformer.resblocks.{i}", w,
                       v["intermediate_size"], fam)
    spec += _ln("visual.ln_post", w)
    if fam == "siglip":
        spec += [("visual.attnpool.probe", (1, 1, w), 0.0, w ** -0.5)]
        spec += _siglip_attn("visual.attnpool.attn", w)
        spec += _ln("visual.attnpool.ln", w)
        spec += _linear("visual.attnpool.mlp.c_fc", v["intermediate_size"], w)
        spec += _linear("visual.attnpool.mlp.c_proj", w, v["intermediate_size"])
    else:
        spec += [("visual.proj", (w, e), 0.0, w ** -0.5)]
    spec += [("text.token_embedding.weight", (t["vocab_size"], wt), 0.0, 0.02),
             ("text.positional_embedding", (t["max_position_embeddings"], wt),
              0.0, 0.01)]
    for i in range(t["num_hidden_layers"]):
        spec += _block(f"text.transformer.resblocks.{i}", wt,
                       t["intermediate_size"], fam)
    spec += _ln("text.ln_final", wt)
    if fam == "siglip":
        spec += _linear("text.head", e, wt)
        spec += [("logit_scale", (), 1.0, 0.0), ("logit_bias", (), 0.0, 0.0)]
    else:
        spec += [("text.text_projection", (wt, e), 0.0, wt ** -0.5),
                 ("logit_scale", (), math.log(1 / 0.07), 0.0)]
    return spec


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter drawn from ``seed`` in one call: a flat standard
    normal buffer in ``dtype`` (the type the model is served in) on
    ``device``, cut into the leaves and scaled in place.  The same seed on
    the same device gives the same tensors."""
    spec = weight_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, mean, std in spec:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(std).add_(mean)
        out[name] = leaf
        off += n
    return out


# ---------------------------------------------------------------------------
# the forward pass


class Lowered(dict):
    """The parameters of the control: the reference computed in float8
    (e4m3), the precision below the bfloat16 the configurations serve in.
    Every product's operands (activations, weights, attention
    probabilities) are rounded to e4m3 with one scale a tensor (its
    largest magnitude at 448); the arithmetic is float32 and the gradient
    passes the rounding straight through."""

    def round(self, t: torch.Tensor) -> torch.Tensor:
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (q - t.detach()) if t.requires_grad else q

    def like(self, items):
        """The same kind of parameters over ``items``."""
        return type(self)(items)


class Bf16(Lowered):
    """The reference computed in bfloat16, the precision the
    configurations train in (the fine-tune's later steps are held to it).  Every product's operands
    are rounded to bfloat16 (float32 arithmetic, the gradient straight
    through); with ``reads`` every parameter is also read rounded to
    bfloat16 wherever it is used (LayerNorms and biases too), as a model
    computing in bfloat16 from float32 master weights reads them."""

    def __init__(self, *args, reads: bool = False, **kw):
        super().__init__(*args, **kw)
        self.reads = reads

    def round(self, t: torch.Tensor) -> torch.Tensor:
        q = t.detach().to(torch.bfloat16).to(t.dtype)
        return t + (q - t.detach()) if t.requires_grad else q

    def __getitem__(self, name):
        t = dict.__getitem__(self, name)
        return self.round(t) if self.reads else t

    def get(self, name, default=None):
        return self[name] if name in self else default

    def like(self, items):
        return Bf16(items, reads=self.reads)


def _r(params, t):
    return params.round(t) if isinstance(params, Lowered) else t


def _lin(x, params, name):
    return F.linear(_r(params, x), _r(params, params[f"{name}.weight"]),
                    params[f"{name}.bias"])


def _layer_norm(x, params, name, eps):
    return F.layer_norm(x, x.shape[-1:], params[f"{name}.weight"],
                        params[f"{name}.bias"], eps)


def _attend(q, k, v, heads: int, params, causal: bool = False):
    q, k, v = (_r(params, t) for t in (q, k, v))
    b, sq, w = q.shape
    sk = k.shape[1]
    d = w // heads
    q = q.reshape(b, sq, heads, d).transpose(1, 2)
    k = k.reshape(b, sk, heads, d).transpose(1, 2)
    v = v.reshape(b, sk, heads, d).transpose(1, 2)
    s = q @ k.transpose(-1, -2) / math.sqrt(d)
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    p = _r(params, torch.softmax(s, -1))
    return (p @ v).transpose(1, 2).reshape(b, sq, w)


def _gelu(x, act: str):
    if act == "gelu_pytorch_tanh":
        return F.gelu(x, approximate="tanh")
    if act == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def block(x, params, prefix: str, tower: dict, family: str,
          causal: bool = False):
    """One pre-LN transformer block."""
    eps, heads = tower["layer_norm_eps"], tower["num_attention_heads"]
    h = _layer_norm(x, params, f"{prefix}.ln_1", eps)
    if family == "siglip":
        a = _attend(_lin(h, params, f"{prefix}.attn.q_proj"),
                    _lin(h, params, f"{prefix}.attn.k_proj"),
                    _lin(h, params, f"{prefix}.attn.v_proj"), heads, params,
                    causal)
    else:
        qkv = F.linear(_r(params, h),
                       _r(params, params[f"{prefix}.attn.in_proj_weight"]),
                       params[f"{prefix}.attn.in_proj_bias"])
        a = _attend(*qkv.chunk(3, dim=-1), heads, params, causal)
    x = x + _lin(a, params, f"{prefix}.attn.out_proj")
    h = _layer_norm(x, params, f"{prefix}.ln_2", eps)
    h = _gelu(_lin(h, params, f"{prefix}.mlp.c_fc"), tower["hidden_act"])
    return x + _lin(h, params, f"{prefix}.mlp.c_proj")


def patch_embed(x, params, cfg: dict):
    """Normalised NHWC images -> the token sequence before the blocks."""
    p = cfg["vision"]["patch_size"]
    w = _r(params, params["visual.conv1.weight"])
    tokens = F.conv2d(_r(params, x).permute(0, 3, 1, 2), w,
                      params.get("visual.conv1.bias"), stride=p)
    tokens = tokens.flatten(2).transpose(1, 2)              # [B, N, W]
    if cfg["family"] == "siglip":
        return tokens + params["visual.positional_embedding"]
    cls = params["visual.class_embedding"].expand(tokens.shape[0], 1, -1)
    tokens = torch.cat([cls, tokens], 1) + params["visual.positional_embedding"]
    return _layer_norm(tokens, params, "visual.ln_pre",
                       cfg["vision"]["layer_norm_eps"])


def image_head(x, params, cfg: dict):
    """The tokens after the last block -> the image embedding."""
    v = cfg["vision"]
    eps = v["layer_norm_eps"]
    if cfg["family"] == "siglip":
        x = _layer_norm(x, params, "visual.ln_post", eps)
        probe = params["visual.attnpool.probe"].expand(x.shape[0], 1, -1)
        pre = "visual.attnpool.attn"
        y = _attend(_lin(probe, params, f"{pre}.q_proj"),
                    _lin(x, params, f"{pre}.k_proj"),
                    _lin(x, params, f"{pre}.v_proj"), v["num_attention_heads"],
                    params)
        y = _lin(y, params, f"{pre}.out_proj")
        h = _layer_norm(y, params, "visual.attnpool.ln", eps)
        h = _gelu(_lin(h, params, "visual.attnpool.mlp.c_fc"), v["hidden_act"])
        return (y + _lin(h, params, "visual.attnpool.mlp.c_proj"))[:, 0]
    pre = _layer_norm(x[:, 0], params, "visual.ln_post", eps)
    return _r(params, pre) @ _r(params, params["visual.proj"])


def image_features(x, params, cfg: dict, start: int = 0, stop=None,
                   tokens=None):
    """Normalised NHWC images -> image embeddings (not normalised).  With
    ``start``/``stop`` only blocks [start, stop) run, from ``tokens``; the
    head runs when ``stop`` is the last block."""
    v = cfg["vision"]
    depth = v["num_hidden_layers"]
    stop = depth if stop is None else stop
    h = patch_embed(x, params, cfg) if tokens is None else tokens
    for i in range(start, stop):
        h = block(h, params, f"visual.transformer.resblocks.{i}", v,
                  cfg["family"])
    return image_head(h, params, cfg) if stop == depth else h


def text_features(tokens: torch.Tensor, params, cfg: dict):
    """[N, ctx] token ids -> text embeddings (not normalised)."""
    t = cfg["text"]
    siglip = cfg["family"] == "siglip"
    x = params["text.token_embedding.weight"][tokens.long()]
    x = x + params["text.positional_embedding"]
    for i in range(t["num_hidden_layers"]):
        x = block(x, params, f"text.transformer.resblocks.{i}", t,
                  cfg["family"], causal=not siglip)
    x = _layer_norm(x, params, "text.ln_final", t["layer_norm_eps"])
    if siglip:
        return _lin(x[:, -1], params, "text.head")
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
    return _r(params, pooled) @ _r(params, params["text.text_projection"])


def l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def text_head(tokens, params, cfg: dict, n_classes: int, per_class: int):
    """The prompt ensemble: normalise each prompt's embedding, average a
    class's templates, normalise again -> [E, C]."""
    feats = l2n(text_features(tokens, params, cfg))
    return l2n(feats.reshape(n_classes, per_class, -1).mean(1)).T


def classify_logits(image_emb, head):
    return 100.0 * l2n(image_emb) @ head


# ---------------------------------------------------------------------------
# the eval transform: antialiased bicubic resize of the shorter side, centre
# crop, normalise (torchvision's CLIP transform, as two 1-D weight matrices)


def _keys_cubic(x, a: float = -0.5):
    x = np.abs(x)
    return np.where(x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                    np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x
                             - 4 * a, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] antialiased bicubic weights (Keys a = -0.5, support
    widened by the downscale factor, rows normalised)."""
    inv = n_in / n_out
    widen = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    wts = _keys_cubic((centre[:, None] - np.arange(n_in)[None]) / widen)
    total = wts.sum(1, keepdims=True)
    wts = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                   wts / np.where(total != 0, total, 1), 0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[:, None], wts, 0).astype(np.float32)


def eval_transform(images_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float32 [B, res, res, 3]."""
    res = cfg["vision"]["image_size"]
    h, w = images_u8.shape[1:3]
    nh, nw = (res, int(res * w / h)) if h <= w else (int(res * h / w), res)
    top, left = int(round((nh - res) / 2.0)), int(round((nw - res) / 2.0))
    rh = torch.from_numpy(resize_matrix(h, nh)[top:top + res])
    rw = torch.from_numpy(resize_matrix(w, nw)[left:left + res])
    dev = images_u8.device
    x = images_u8.float().permute(0, 3, 1, 2)
    x = rh.to(dev) @ x @ rw.to(dev).T
    mean, std = pixel_stats(cfg)
    m = torch.tensor(mean, device=dev)[:, None, None]
    s = torch.tensor(std, device=dev)[:, None, None]
    return ((x / 255.0 - m) / s).permute(0, 2, 3, 1)


def pixel_stats(cfg: dict):
    return (HALF, HALF) if cfg["family"] == "siglip" else (CLIP_MEAN, CLIP_STD)
