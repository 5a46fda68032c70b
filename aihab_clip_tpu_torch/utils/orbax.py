"""orbax's ``StandardCheckpointer`` layout, read and written without orbax:
the ``state/`` directory of the JAX package's checkpoints
(``aihab_clip_tpu/utils/checkpointing.py``).

A payload is a tree of dicts, tuples and lists with numpy arrays (or torch
tensors) at the leaves; ``None`` and empty containers are kept as orbax
keeps them (no array).  ``state/`` holds

  * ``_METADATA``: ``tree_metadata`` ({"('a', 'b')": {"key_metadata": [{key,
    key_type: 2 for a dict key, 1 for a sequence index}], "value_metadata":
    {value_type, skip_deserialize, write_shape}}}), ``use_ocdbt: true``,
    ``use_zarr3: false``, ``store_array_data_equal_to_fill_value: true``;
  * ``_CHECKPOINT_METADATA`` (the handler's name, timestamps); for
    ``jax.Array`` leaves also ``_sharding`` (each array's sharding, base64 of
    its name -> JSON) and ``array_metadatas/process_<i>`` (each array's
    write and chunk shape);
  * the arrays: an OCDBT database (``utils/ocdbt.py``) whose keys are each
    array's zarr v2 ``.zarray`` and its one chunk (``<name>/.zarray``,
    ``<name>/0.0``; ``<name>/0`` for a 0-d array) with compressor zstd;
    ``<name>`` is the tree path joined by ``.``.

``write_state(dir, payload)`` writes the arrays as orbax writes host
(``np.ndarray``) leaves: no sharding is recorded, so JAX restores them onto
whatever devices its target or its mesh names (a ``jax.Array`` leaf's
recorded sharding would pin a restore without a target to the writer's
device); ``read_state(dir)`` reads any of these trees back (tuples for
sequences), from any number of processes' databases through the top-level
manifest, or from plain zarr directories when ``use_ocdbt`` is false.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from ..cache import zarr
from ..cache.kvstore import FileKvStore
from ..ops import zstd
from . import ocdbt

HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")


def _flatten(tree, path: Tuple = (), kinds: Tuple = ()):
    """(path of keys, key types, leaf) for every leaf and empty node."""
    if isinstance(tree, dict):
        if not tree:
            yield path, kinds, {}
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),), kinds + (2,))
    elif isinstance(tree, (tuple, list)):
        if not tree:
            yield path, kinds, type(tree)()
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),), kinds + (1,))
    else:
        yield path, kinds, tree


def write_state(state_dir, payload: Dict) -> None:
    """``payload`` in orbax's layout under ``state_dir`` (created)."""
    state_dir = Path(state_dir)
    state_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time_ns()
    tree_meta: Dict[str, Dict] = {}
    items: Dict[str, bytes] = {}
    for path, kinds, leaf in _flatten(payload):
        key_meta = [{"key": k, "key_type": t} for k, t in zip(path, kinds)]
        if leaf is None or isinstance(leaf, (dict, tuple, list)):
            value_type = ("None" if leaf is None else
                          {dict: "Dict", tuple: "Tuple", list: "List"}[
                              type(leaf)])
            tree_meta[str(path)] = {
                "key_metadata": key_meta,
                "value_metadata": {"value_type": value_type,
                                   "skip_deserialize": True}}
            continue
        name = ".".join(path)
        a, dtype = zarr.as_numpy(leaf)
        a = np.ascontiguousarray(a).reshape(a.shape)  # keeps a 0-d array
        if a.size:
            items[f"{name}/" + (".".join("0" for _ in a.shape) or "0")] = \
                zstd.compress_raw(a)
        items[f"{name}/.zarray"] = zarr.encode_zarray(
            a.shape, [max(s, 1) for s in a.shape], dtype, zarr.ZSTD_1)
        tree_meta[str(path)] = {
            "key_metadata": key_meta,
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    ocdbt.write_database(state_dir, items)
    (state_dir / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    (state_dir / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}))


def _insert(tree: Dict, path, kinds, value) -> None:
    node = tree
    for k, t in zip(path[:-1], kinds[:-1]):
        node = node.setdefault((k, t), {})
    node[(path[-1], kinds[-1])] = value


def _build(node):
    """The {(key, key type): child} tree -> dicts and tuples."""
    if not isinstance(node, dict) or not node or not all(
            isinstance(k, tuple) for k in node):
        return node
    if all(t == 1 for _, t in node):
        return tuple(_build(node[k]) for k in
                     sorted(node, key=lambda kt: int(kt[0])))
    return {k: _build(v) for (k, _), v in node.items()}


def read_state(state_dir) -> Dict[str, Any]:
    """The payload tree of an orbax ``state/`` directory."""
    state_dir = Path(state_dir)
    meta_path = state_dir / "_METADATA"
    if not meta_path.is_file():
        raise FileNotFoundError(f"{state_dir}: no _METADATA (not an orbax "
                                "checkpoint, or its write never finished)")
    meta = json.loads(meta_path.read_text())
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{state_dir}: zarr v3 checkpoints are not "
                                  "read")
    if meta.get("use_ocdbt", False):
        db = ocdbt.Database(state_dir)
        refs = {k.decode(): v for k, v in db.entries()}

        class _View:  # the database's newest version as a kvstore
            @staticmethod
            def read(key):
                ref = refs.get(key)
                return None if ref is None else db.read_value(ref)
        kv = _View()
    else:
        kv = FileKvStore(state_dir)
    tree: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        path = tuple(k["key"] for k in keys)
        kinds = tuple(int(k["key_type"]) for k in keys)
        value = entry["value_metadata"]
        vtype = value.get("value_type")
        if value.get("skip_deserialize"):
            leaf = {"None": None, "Dict": {}, "Tuple": (), "List": []}.get(
                vtype)
            if vtype not in ("None", "Dict", "Tuple", "List"):
                raise NotImplementedError(f"{state_dir}: leaf {path} of type "
                                          f"{vtype} is not read")
        else:
            name = ".".join(path)
            try:
                leaf = zarr.read_array(kv, name)
            except KeyError:
                raise ValueError(f"{state_dir}: array {name} is listed in "
                                 "_METADATA but not stored") from None
        _insert(tree, path, kinds, leaf)
    return _build(tree)
