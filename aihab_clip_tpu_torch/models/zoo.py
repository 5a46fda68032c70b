"""Model zoo (counterpart of ``aihab_clip_tpu/models/zoo.py``).

``load(name)`` first maps open_clip's dashed ViT names onto the table's
keys (``_normalize_openclip_name``, JAX ``zoo.py:369-382``: ``ViT-B-16`` ->
``ViT-B/16``, ``ViT-L-14-336`` -> ``ViT-L/14@336px``, ``ViT-bigG-14`` ->
``ViT-bigG/14``), then resolves in JAX's order (``zoo.py:385-467``):
  1. SigLIP names (``random:``, ``hf-hub:`` and registry forms, any
     ``ViT-{B,L,SO400M}-<p>-SigLIP[2][-<res>]`` tag): a local HF snapshot
     (``$HF_HOME/hub``, the name or its ``_SIGLIP_HF_ALIASES`` repo) read by
     ``convert_hf`` and ``safetensors`` with its ``tokenizer.json``
     (``tokenizer/hf_json.py``); no snapshot raises
     ``SigLIPAssetsMissingError`` unless ``allow_random_fallback``;
     ``random:`` draws a ``SigLIPModel`` from a seeded ``torch.Generator``;
  2. LAION ConvNeXt names: the converted cache, then the file, then a
     snapshot's ``open_clip_pytorch_model.bin`` / ``*.bin`` / ``*.pt``;
  3. ``random:<ARCH>`` -> CLIP parameters drawn from a seeded
     ``torch.Generator`` (development / benchmarks without weights);
  4. the converted cache ``<cache_root>/converted/<safe>.npz`` plus
     ``.config.json``, in the JAX package's naming and layout;
  5. a torch checkpoint path (an OpenAI JIT archive or a state dict), or an
     OpenAI zoo name downloaded with its sha256 checked.
A conversion writes the cache (``convert.state_dict_to_flax_params``), so
the second load of that name is ``npz-cache`` in either package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import urllib.request
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..backend import resolve_device
from .clip import CLIP_ARCHS, CLIPConfig, CLIPModel
from .convert import (clean_state_dict, flax_params_to_state_dict,
                      load_params_npz, save_params_npz,
                      state_dict_to_flax_params, torch_state_dict_to_port)
from .convert_hf import find_local_hf_snapshot, load_local_hf_siglip
from .convnext import (convnext_config_for_name,
                       openclip_convnext_state_dict_to_port,
                       register_convnext_archs)
from .layers import LayerNorm, set_remat
from .resnet import FrozenBatchNorm
from .siglip import (SIGLIP_ARCHS, SigLIPConfig, SigLIPModel,
                     init_siglip_random_, siglip_config_for_name)

register_convnext_archs()  # 'random:convnext_*' resolves via CLIP_ARCHS

# the std of a random ConvNeXt layer scale gamma: JAX initialises it to 1e-6,
# which makes every random block an identity to bf16 precision; at 0.1 each
# block's MLP branch moves the residual stream
CONVNEXT_GAMMA_STD = 0.1


def default_cache_root() -> Path:
    """The JAX package's cache root, so its converted caches are shared."""
    return Path(os.path.expanduser("~/.cache/aihab_clip_tpu"))


@dataclasses.dataclass
class CLIPBundle:
    name: str
    config: Any                  # CLIPConfig | SigLIPConfig
    model: Any                   # CLIPModel | SigLIPModel
    source: str  # 'npz-cache' | 'torch' | 'download' | 'hf-local' | 'random'
    tokenize_fn: Optional[Callable] = None  # None: the CLIP BPE


# the OpenAI CLIP release artifacts; the URL's path holds the file's sha256
_ZOO_URLS: Dict[str, str] = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}


def available_models():
    return list(_ZOO_URLS)


# open_clip/timm hub names -> the HF transformers repos holding the same
# weights in SiglipModel format
_SIGLIP_HF_ALIASES = {
    "timm/ViT-SO400M-16-SigLIP2-384": "google/siglip2-so400m-patch16-384",
    "timm/ViT-B-16-SigLIP": "google/siglip-base-patch16-224",
}


class SigLIPAssetsMissingError(FileNotFoundError):
    """A SigLIP model was asked for by name, but its local snapshot
    (weights and/or tokenizer) cannot be read.  The CLIP BPE gives wrong
    token ids for these checkpoints, so there is no silent fallback."""


def _snapshot_recipe(repo: str) -> str:
    return (
        f"Fetch a snapshot once (network required):\n"
        f"    hf download {repo}\n"
        f"(or `huggingface-cli download {repo}`); it lands under "
        f"~/.cache/huggingface/hub and every later run is offline.  "
        f"Set HF_HOME to relocate the cache.  To develop without weights "
        f"use 'random:<arch>' or pass allow_random_fallback=True / set "
        f"`allow_random_weights: true` in the config.")


def is_siglip_name(name: str) -> bool:
    plain = name.replace("random:", "").replace("hf-hub:", "")
    return ("siglip" in name.lower() or plain in SIGLIP_ARCHS
            or plain.split("/")[-1] in SIGLIP_ARCHS)


def _siglip_arch_for(name: str) -> Tuple[Optional[str],
                                         Optional[SigLIPConfig]]:
    """A SigLIP name -> (arch name, config), without building anything:
    the registry, then the open_clip tag grid, then SO400M-16-384 for any
    other name that says SigLIP; (None, None) otherwise."""
    stripped = name.replace("hf-hub:", "").replace("random:", "")
    tail = stripped.split("/")[-1]
    for cand in (stripped, tail):
        if cand in SIGLIP_ARCHS:
            return cand, SIGLIP_ARCHS[cand]
    for cand in (stripped, tail):
        cfg = siglip_config_for_name(cand)
        if cfg is not None:
            return cand, cfg
    if "siglip" in stripped.lower():
        return ("ViT-SO400M-16-SigLIP2-384",
                SIGLIP_ARCHS["ViT-SO400M-16-SigLIP2-384"])
    return None, None


def _from_state_dict(cls, cfg, sd: Dict[str, torch.Tensor], dtype,
                     dev: torch.device):
    """A model whose parameters are ``sd``'s tensors (no second host copy),
    on ``dev``."""
    with torch.device("meta"):
        model = cls(cfg, dtype=dtype)
    model.load_state_dict(sd, assign=True)
    return model.to(dev).eval()


def _hf_tokenizer_fn(repo: str) -> Tuple[Optional[Callable], str]:
    """The snapshot's own tokenizer (``tokenizer/hf_json.py``), or None and
    why it could not be read."""
    from ..tokenizer.hf_json import load_hf_tokenizer

    snap = find_local_hf_snapshot(repo)
    if snap is None:
        return None, "no snapshot"
    try:
        return load_hf_tokenizer(snap), ""
    except (OSError, ValueError, KeyError) as exc:
        return None, f"{type(exc).__name__}: {exc}"


def _load_siglip(name: str, dtype, dev: torch.device, seed: int,
                 random_cfg: Optional[SigLIPConfig],
                 allow_random_fallback: bool,
                 require_tokenizer: bool) -> CLIPBundle:
    """A local HF snapshot when there is one; otherwise an error with the
    snapshot recipe (random weights only for ``random:`` names or with
    ``allow_random_fallback``), as JAX's ``_load_siglip``."""
    arch_name, arch_cfg = _siglip_arch_for(name)
    if not name.startswith("random:"):
        stripped = name.replace("hf-hub:", "")
        repos = [stripped] + ([_SIGLIP_HF_ALIASES[stripped]]
                              if stripped in _SIGLIP_HF_ALIASES else [])
        for repo in repos:
            try:
                cfg, sd = load_local_hf_siglip(repo)
            except FileNotFoundError:
                continue
            tokenize_fn, why = _hf_tokenizer_fn(repo)
            if tokenize_fn is None and require_tokenizer:
                raise SigLIPAssetsMissingError(
                    f"Local snapshot for '{repo}' has weights but no "
                    f"loadable tokenizer assets ({why}) — SigLIP text "
                    f"encoding would use wrong token ids.  Re-fetch the full "
                    f"snapshot.  " + _snapshot_recipe(repo))
            model = _from_state_dict(SigLIPModel, cfg, sd, dtype, dev)
            return CLIPBundle(name, cfg, model, "hf-local", tokenize_fn)
        if not allow_random_fallback:
            raise SigLIPAssetsMissingError(
                f"No local HF snapshot for SigLIP '{name}' (searched "
                f"{repos}).  " + _snapshot_recipe(repos[-1]))
        warnings.warn(f"No local weights for SigLIP '{name}'; using random "
                      f"init ({arch_name})")
    return _random(name, SigLIPModel, random_cfg or arch_cfg,
                   init_siglip_random_, dtype, dev, seed)


def _random(name: str, cls, cfg, init, dtype, dev: torch.device,
            seed: int) -> CLIPBundle:
    """A ``random:`` bundle: ``init`` draws every parameter on the CPU from
    a generator seeded ``seed``."""
    with torch.device("meta"):
        model = cls(cfg, dtype=dtype)
    model = model.to_empty(device="cpu")
    init(model, torch.Generator().manual_seed(seed))
    return CLIPBundle(name, cfg, model.to(dev).eval(), "random")


def _npz_cache_path(key: str, cache_root: Path) -> Path:
    safe = key.replace("/", "-").replace(":", "_").replace("@", "_")
    return cache_root / "converted" / f"{safe}.npz"


def _config_cache_path(key: str, cache_root: Path) -> Path:
    return _npz_cache_path(key, cache_root).with_suffix(".config.json")


def _load_config(path: Path) -> CLIPConfig:
    d = json.loads(path.read_text())
    if isinstance(d["vision_layers"], list):
        d["vision_layers"] = tuple(d["vision_layers"])
    return CLIPConfig(**d)


def _cached(name: str, cache_root: Path, dtype, dev: torch.device
            ) -> Optional[CLIPBundle]:
    """The converted cache of ``name`` (either package's), or None."""
    npz = _npz_cache_path(name, cache_root)
    cfg_path = _config_cache_path(name, cache_root)
    if not (npz.is_file() and cfg_path.is_file()):
        return None
    cfg = _load_config(cfg_path)
    model = _from_state_dict(CLIPModel, cfg, flax_params_to_state_dict(
        load_params_npz(npz)), dtype, dev)
    return CLIPBundle(name, cfg, model, "npz-cache")


def _converted(name: str, cache_root: Path, cfg: CLIPConfig,
               sd: Dict[str, torch.Tensor], dtype, dev: torch.device,
               source: str) -> CLIPBundle:
    """Build the model of a converted checkpoint (a tower the port lacks
    raises here, before anything is written), then write the cache in
    JAX's layout (``_save_config``, JAX ``zoo.py:353-358``)."""
    model = _from_state_dict(CLIPModel, cfg, sd, dtype, dev)
    npz = _npz_cache_path(name, cache_root)
    npz.parent.mkdir(parents=True, exist_ok=True)
    tmp = npz.with_name(npz.name + ".tmp")
    with open(tmp, "wb") as f:
        save_params_npz(f, state_dict_to_flax_params(sd))
    os.replace(tmp, npz)
    _config_cache_path(name, cache_root).write_text(
        json.dumps(dataclasses.asdict(cfg)))
    return CLIPBundle(name, cfg, model, source)


def _torch_load(path: Path) -> Dict[str, Any]:
    """A torch checkpoint's state dict: an OpenAI JIT archive, else a
    ``torch.save`` file holding a state dict or ``{"state_dict": ...}``
    (read with ``weights_only``, memory-mapped: a pickled module object is
    refused, where JAX unpickles it)."""
    try:
        return torch.jit.load(str(path), map_location="cpu").state_dict()
    except RuntimeError:
        obj = torch.load(str(path), map_location="cpu", weights_only=True,
                         mmap=True)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return sd.get("state_dict", sd)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_checkpoint(name: str, root: Path) -> Path:
    """The zoo checkpoint ``name`` under ``root``, downloaded unless a file
    with the sha256 its URL names is there; a mismatch raises."""
    url = _ZOO_URLS[name]
    expected_sha = url.split("/")[-2]
    root.mkdir(parents=True, exist_ok=True)
    target = root / os.path.basename(url)
    if target.is_file():
        if _sha256(target) == expected_sha:
            return target
        warnings.warn(f"{target} exists with bad sha256; re-downloading")
    urllib.request.urlretrieve(url, target)
    if _sha256(target) != expected_sha:
        raise RuntimeError(
            f"Downloaded {name} checkpoint has mismatched sha256")
    return target


def _load_convnext(name: str, dtype, dev: torch.device, seed: int,
                   cache_root: Path,
                   allow_random_fallback: bool) -> CLIPBundle:
    """ConvNeXt-CLIP (JAX ``_load_convnext``): the converted cache, then the
    file, then a local snapshot's open_clip checkpoint, else an error with
    the snapshot recipe (random weights with ``allow_random_fallback``).
    A file path need not name a known tag: its config then comes from the
    shapes alone, at 256 px with a warning."""
    stripped = name.replace("hf-hub:", "")
    if os.path.isfile(stripped):
        try:
            cfg = convnext_config_for_name(name)
        except ValueError:
            cfg = None
    else:
        cfg = convnext_config_for_name(name)  # ValueError on unknown tags
    cached = _cached(name, cache_root, dtype, dev)
    if cached is not None:
        return cached
    ckpt, source = None, "torch"
    if os.path.isfile(stripped):
        ckpt = Path(stripped)
    elif "/" in stripped:
        snap = find_local_hf_snapshot(stripped)
        if snap is not None:
            for pattern in ("open_clip_pytorch_model.bin", "*.bin", "*.pt"):
                hits = sorted(snap.glob(pattern))
                if hits:
                    ckpt, source = hits[0], "hf-local"
                    break
    if ckpt is not None:
        ccfg, psd = openclip_convnext_state_dict_to_port(
            clean_state_dict(_torch_load(ckpt)),
            resolution=cfg.image_resolution if cfg is not None else 0)
        return _converted(name, cache_root, ccfg, psd, dtype, dev, source)
    if not allow_random_fallback:
        raise FileNotFoundError(
            f"No local weights for ConvNeXt-CLIP '{name}'.  "
            + _snapshot_recipe(
                stripped if "/" in stripped
                else f"laion/CLIP-{stripped}-laion2B (or another LAION "
                     f"'{stripped}' repo)"))
    warnings.warn(f"No local weights for ConvNeXt '{name}'; "
                  "using random init")
    return _random(name, CLIPModel, cfg, init_random_, dtype, dev, seed)


def _normalize_openclip_name(name: str) -> str:
    """An open_clip dashed ViT name (``ViT-B-16``, ``ViT-L-14-336``, with or
    without a ``random:`` prefix) -> the table's OpenAI-style key
    (``ViT-B/16``, ``ViT-L/14@336px``), only where that key exists; any
    other name unchanged (JAX ``zoo.py:369-382``)."""
    prefix, _, arch = name.rpartition(":")
    m = re.fullmatch(r"(ViT-[A-Za-z]+)-(\d+)(?:-(\d+))?(?:px)?", arch)
    if m:
        mapped = f"{m.group(1)}/{m.group(2)}"
        if m.group(3):
            mapped += f"@{m.group(3)}px"
        if mapped in CLIP_ARCHS:
            return f"{prefix}:{mapped}" if prefix else mapped
    return name


@torch.no_grad()
def init_random_(model: CLIPModel, generator: torch.Generator) -> None:
    """Draw every parameter from ``generator``: normal weights at
    1/sqrt(fan_in), zero biases, unit LayerNorm scales, the frozen
    BatchNorms at JAX's init (scale 1, bias 0, mean 0, var 1), the CLIP
    embedding scales (class/positional/projection 1/sqrt(width), the RN
    attention pool's positional 1/sqrt(its width), token 0.02, text
    positional 0.01) and ConvNeXt's layer scales ``gamma`` normal at
    ``CONVNEXT_GAMMA_STD`` (0.1, not JAX's constant 1e-6)."""
    vis_scale = model.config.vision_width ** -0.5
    norm_params = {f"{mn}.{pn}" for mn, m in model.named_modules()
                   if isinstance(m, (LayerNorm, FrozenBatchNorm))
                   for pn, _ in m.named_parameters(recurse=False)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "logit_scale":
            p.fill_(torch.log(torch.tensor(1 / 0.07)).item())
        elif name in norm_params:
            p.fill_(1.0 if leaf in ("weight", "var") else 0.0)
        elif leaf == "gamma":
            p.normal_(0.0, CONVNEXT_GAMMA_STD, generator=generator)
        elif leaf in ("bias", "in_proj_bias"):
            p.zero_()
        elif name == "text.token_embedding.weight":
            p.normal_(0.0, 0.02, generator=generator)
        elif name == "text.positional_embedding":
            p.normal_(0.0, 0.01, generator=generator)
        elif name == "text.text_projection":
            p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
        elif name in ("visual.class_embedding", "visual.positional_embedding",
                      "visual.proj"):
            p.normal_(0.0, vis_scale, generator=generator)
        elif name == "visual.attnpool.positional_embedding":
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        else:  # [out, in(, kh, kw)] weights
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)


def load(name: str, dtype=torch.float32, device="cuda", seed: int = 0,
         cache_dir: Optional[str] = None, download: bool = True,
         random_cfg: Optional[Any] = None, remat: bool = False,
         allow_random_fallback: bool = False,
         require_tokenizer: bool = True) -> CLIPBundle:
    """Load a CLIP (ViT, ModifiedResNet or ConvNeXt) or a SigLIP model as a
    ``CLIPBundle`` on ``device`` (default the card; raises without one
    unless ``device="cpu"``).  Parameters are fp32, whatever the checkpoint's
    dtype; the towers compute in ``dtype``.  ``random_cfg`` (a
    ``CLIPConfig`` or ``SigLIPConfig``) shapes a ``random:`` model.
    ``download=False`` refuses to fetch a zoo name that has no cache.
    ``allow_random_fallback`` gives a SigLIP or ConvNeXt name without local
    weights random ones; ``require_tokenizer=False`` accepts a SigLIP
    snapshot without a readable tokenizer (``tokenize_fn`` None), as in
    JAX.  ``remat`` checkpoints every transformer block in training
    (``layers.set_remat``), as JAX's ``load(remat=)``."""
    bundle = _load(name, dtype, device, seed, cache_dir, download,
                   random_cfg, allow_random_fallback, require_tokenizer)
    if remat:
        set_remat(bundle.model)
    return bundle


def _load(name: str, dtype, device, seed: int, cache_dir: Optional[str],
          download: bool, random_cfg: Optional[Any],
          allow_random_fallback: bool,
          require_tokenizer: bool) -> CLIPBundle:
    dev = resolve_device(device)
    name = _normalize_openclip_name(name)
    cache_root = Path(cache_dir) if cache_dir else default_cache_root()

    if isinstance(random_cfg, SigLIPConfig) or (random_cfg is None
                                                and is_siglip_name(name)):
        return _load_siglip(name, dtype, dev, seed, random_cfg,
                            allow_random_fallback, require_tokenizer)
    plain = name.replace("random:", "").replace("hf-hub:", "")
    if ("convnext" in plain.lower() and random_cfg is None
            and not name.startswith("random:")):
        return _load_convnext(name, dtype, dev, seed, cache_root,
                              allow_random_fallback)
    if name.startswith("random:"):
        return _random(name, CLIPModel, random_cfg or CLIP_ARCHS[
            name.split(":", 1)[1]], init_random_, dtype, dev, seed)
    cached = _cached(name, cache_root, dtype, dev)
    if cached is not None:
        return cached
    source = "torch"
    if os.path.isfile(name):
        ckpt = Path(name)
    elif name in _ZOO_URLS:
        if not download:
            raise FileNotFoundError(
                f"No cached conversion for '{name}' and download=False")
        ckpt = download_checkpoint(name, cache_root / "checkpoints")
        source = "download"
    else:
        raise FileNotFoundError(
            f"Model '{name}' is neither a file, a zoo name "
            f"({available_models()}), nor 'random:<ARCH>'")
    cfg, sd = torch_state_dict_to_port(_torch_load(ckpt))
    return _converted(name, cache_root, cfg, sd, dtype, dev, source)
