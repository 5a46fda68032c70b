"""OCDBT, tensorstore's "optionally-cooperative distributed b-tree": the
database an orbax checkpoint keeps its arrays in (``use_ocdbt: true``).

A database directory holds ``manifest.ocdbt`` and data files under ``d/``
(orbax's per-process databases under ``ocdbt.process_<i>/``; the top-level
manifest names files in either by their path from the top).  Every manifest
and node is a file (or a range of a data file) laid out as

    magic (uint32, big-endian) | length (uint64, little-endian, the whole
    thing) | version (varint, 0) | compression (varint: 0 none, 1 zstd) |
    body (zstd-compressed when 1) | CRC-32C of everything before (uint32 LE)

with magics ``0x0cdb3a2a`` (manifest), ``0x0cdb1234`` (version-tree node)
and ``0x0cdb20de`` (b-tree node).  Integers in a body are LEB128 varints
unless said otherwise, and each table is stored column by column.

  * manifest: config (uuid[16], manifest kind, max inline value bytes, max
    decoded node bytes, version-tree arity log2 (uint8), compression (0, or
    1 and a zstd level int32)), a data file table, the newest versions
    (``_read_versions``) and references to version-tree nodes (generation,
    file, offset, length, generation count, commit time (uint64), height);
  * data file table: count; for files 1.. the bytes shared with the previous
    path; each path's suffix length and base-path length; the suffixes;
  * version-tree node: arity log2, height (uint8), a data file table, then
    versions (height 0) or references to the nodes below;
  * b-tree node: height (uint8), a data file table, the entry count; each
    key is the bytes it shares with the previous key plus its suffix; a
    leaf (height 0) then has each value's length, kind (0 inline, 1 in a
    data file), the file and offset of the indirect ones and the inline
    bytes; an interior node each child's common-prefix length (the child's
    keys drop that prefix of this entry's key), file, offset, length and
    statistics (keys, tree bytes, indirect value bytes).

``Database(root)`` reads the newest version through the top-level
manifest, checking every CRC-32C; its ``manifest`` is in the shape
``tensorstore.ocdbt.dump`` prints.  ``write_database(root, items)``
writes one version: values over ``max_inline_value_bytes`` and every node
in one data file, a root of height 0 (or more, when a leaf would pass
``leaf_entries``), nodes and manifest as zstd frames of raw blocks.
"""

from __future__ import annotations

import struct
import time
import uuid as _uuid
from typing import Dict, Iterator, List, Optional, Tuple

from ..cache.kvstore import open_kvstore
from ..ops import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_MAGIC = 0x0CDB20DE
MAX_INLINE = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
ARITY_LOG2 = 4
UINT64_MAX = (1 << 64) - 1


# ---- CRC-32C (Castagnoli) ---------------------------------------------------

def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    tab = _CRC
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---- byte reading ---------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, name: str):
        self.data, self.at, self.name = data, 0, name

    def fail(self, what: str):
        raise ValueError(f"{self.name}: corrupt OCDBT data: {what}")

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.at >= len(self.data):
                self.fail("varint past the end")
            b = self.data[self.at]
            self.at += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            self.fail("field past the end")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self):
        if self.at != len(self.data):
            self.fail(f"{len(self.data) - self.at} bytes after the body")


def _unframe(data: bytes, magic: int, name: str) -> bytes:
    """The body of a manifest or node: magic, length and CRC-32C checked,
    zstd undone."""
    if len(data) < 18:
        raise ValueError(f"{name}: corrupt OCDBT data: too short")
    got_magic, length = struct.unpack_from(">I", data)[0], \
        struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{name}: corrupt OCDBT data: magic "
                         f"{got_magic:#010x}, {magic:#010x} expected")
    if length != len(data):
        raise ValueError(f"{name}: corrupt OCDBT data: length {length} of "
                         f"{len(data)} bytes")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != want:
        raise ValueError(f"{name}: corrupt OCDBT data: CRC-32C mismatch")
    r = _Reader(data[:-4], name)
    r.at = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        r.fail(f"format version {version}")
    body = data[r.at:-4]
    if compression == 1:
        return bytes(zstd.decompress(body, name=name))
    if compression != 0:
        r.fail(f"compression format {compression}")
    return body


def _frame(body: bytes, magic: int) -> bytes:
    """A manifest or node around ``body`` (zstd raw blocks, CRC-32C)."""
    payload = zstd.compress_raw(body)
    head = struct.pack(">I", magic)
    length = len(head) + 8 + 2 + len(payload) + 4
    out = head + struct.pack("<Q", length) + bytes((0, 1)) + payload
    return out + struct.pack("<I", crc32c(out))


def _read_files(r: _Reader) -> List[str]:
    n = r.varint()
    shared = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)  # each path's base-path length (paths are kept whole)
    paths: List[str] = []
    for i in range(n):
        prev = paths[-1] if paths else ""
        if shared[i] > len(prev):
            r.fail("data file path shares more than its predecessor")
        paths.append(prev[:shared[i]] + r.take(suffix[i]).decode())
    return paths


def _shared(seq) -> List[int]:
    """For items 1.. of ``seq``, the length each shares with the one
    before (the prefix coding of keys and file paths)."""
    out = []
    for a, b in zip(seq, seq[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        out.append(k)
    return out


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _write_files(paths: List[str]) -> bytes:
    """A data file table (every base-path length 0: paths kept whole)."""
    shared = _shared(paths)
    full = [0] + shared
    return (_varint(len(paths)) + _varints(shared)
            + _varints(len(p) - k for p, k in zip(paths, full))
            + _varints(0 for _ in paths)
            + b"".join(p[k:].encode() for p, k in zip(paths, full)))


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _location(kind: str, files: List[str], fid: int, offset: int,
              length: int) -> Optional[str]:
    if offset == UINT64_MAX and length == UINT64_MAX:
        return None  # an empty tree
    return f"{kind}::{files[fid]}:{offset}:{length}"


def _read_versions(r: _Reader, files: List[str]) -> List[Dict]:
    n = r.varint()
    gen, height = r.varints(n), r.u8s(n)
    fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
    keys, tree, indirect = r.varints(n), r.varints(n), r.varints(n)
    commit = r.u64s(n)
    out = []
    for i in range(n):
        root = {"statistics": {"num_indirect_value_bytes": indirect[i],
                               "num_keys": keys[i],
                               "num_tree_bytes": tree[i]}}
        loc = _location("btreenode", files, fid[i], off[i], ln[i])
        if loc is not None:
            root["location"] = loc
        out.append({"commit_time": commit[i], "generation_number": gen[i],
                    "root": root, "root_height": height[i]})
    return out


def _read_version_refs(r: _Reader, files: List[str],
                       heights: Optional[int] = None) -> List[Dict]:
    n = r.varint()
    gen, fid = r.varints(n), r.varints(n)
    off, ln, ngen = r.varints(n), r.varints(n), r.varints(n)
    commit = r.u64s(n)
    height = r.u8s(n) if heights is None else [heights] * n
    return [{"commit_time": commit[i], "generation_number": gen[i],
             "height": height[i],
             "location": _location("versionnode", files, fid[i], off[i],
                                   ln[i]),
             "num_generations": ngen[i]} for i in range(n)]


def parse_manifest(data: bytes, name: str = "manifest.ocdbt") -> Dict:
    """A manifest as ``tensorstore.ocdbt.dump`` prints it."""
    r = _Reader(_unframe(data, MANIFEST_MAGIC, name), name)
    uid = r.take(16).hex()
    kind = r.varint()
    if kind != 0:
        raise NotImplementedError(f"{name}: numbered manifests (kind {kind}) "
                                  "are not read")
    max_inline, max_node = r.varint(), r.varint()
    arity = r.take(1)[0]
    method = r.varint()
    compression = None
    if method == 1:
        level = struct.unpack("<i", r.take(4))[0]
        compression = {"id": "zstd"}
        if level:
            compression["level"] = level
    elif method != 0:
        r.fail(f"compression method {method}")
    files = _read_files(r)
    versions = _read_versions(r, files)
    nodes = _read_version_refs(r, files)
    r.end()
    config = {"max_decoded_node_bytes": max_node,
              "max_inline_value_bytes": max_inline, "uuid": uid,
              "version_tree_arity_log2": arity}
    if compression is not None:
        config["compression"] = compression
    return {"config": config, "version_tree_nodes": nodes,
            "versions": versions}


class Database:
    """The newest version of the database under ``root`` (a directory or a
    ``file://`` URI), read through its top-level manifest."""

    def __init__(self, root):
        self.kv = open_kvstore(root)
        self.root = str(root)
        data = self.kv.read("manifest.ocdbt")
        if data is None:
            raise FileNotFoundError(f"{root}: no manifest.ocdbt")
        self.manifest = parse_manifest(data, f"{root}/manifest.ocdbt")
        self.config = self.manifest["config"]

    def _range(self, location: str) -> bytes:
        _, rest = location.split("::", 1)
        path, offset, length = rest.rsplit(":", 2)
        return self.kv.read_range(path, int(offset), int(length))

    def versions(self) -> List[Dict]:
        """Every version, oldest first (the version tree's nodes read)."""
        out: List[Dict] = []
        for ref in self.manifest["version_tree_nodes"]:
            out.extend(self._version_node(ref["location"]))
        return out + self.manifest["versions"]

    def _version_node(self, location: str) -> List[Dict]:
        name = f"{self.root}/{location}"
        r = _Reader(_unframe(self._range(location), VERSION_NODE_MAGIC,
                             name), name)
        r.take(1)  # arity log2
        height = r.take(1)[0]
        files = _read_files(r)
        if height == 0:
            versions = _read_versions(r, files)
            r.end()
            return versions
        refs = _read_version_refs(r, files, heights=height - 1)
        r.end()
        out = []
        for ref in refs:
            out.extend(self._version_node(ref["location"]))
        return out

    def node(self, location: str) -> Dict:
        """One b-tree node: {"height", "entries"} with each entry's key
        (relative to the node's prefix) and its value reference (leaf:
        ("inline", bytes) or ("indirect", location)) or child (interior:
        location, statistics, subtree_common_prefix)."""
        name = f"{self.root}/{location}"
        r = _Reader(_unframe(self._range(location), BTREE_MAGIC, name), name)
        height = r.take(1)[0]
        files = _read_files(r)
        n = r.varint()
        shared = [0] + r.varints(max(n - 1, 0))
        suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys: List[bytes] = []
        for i in range(n):
            prev = keys[-1] if keys else b""
            if shared[i] > len(prev):
                r.fail("key shares more than its predecessor")
            keys.append(prev[:shared[i]] + r.take(suffix[i]))
        entries = []
        if height == 0:
            lengths, kinds = r.varints(n), r.varints(n)
            ind = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                r.fail("value kind")
            fid, off = r.varints(len(ind)), r.varints(len(ind))
            refs = {i: ("indirect", f"value::{files[f]}:{o}:{lengths[i]}")
                    for i, f, o in zip(ind, fid, off)}
            for i in range(n):
                if i not in refs:
                    refs[i] = ("inline", r.take(lengths[i]))
                entries.append({"key": keys[i], "value": refs[i]})
        else:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            nkeys, tree, indirect = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                if common[i] > len(keys[i]):
                    r.fail("common prefix longer than its key")
                entries.append({
                    "key": keys[i],
                    "location": _location("btreenode", files, fid[i], off[i],
                                          ln[i]),
                    "statistics": {"num_indirect_value_bytes": indirect[i],
                                   "num_keys": nkeys[i],
                                   "num_tree_bytes": tree[i]},
                    "subtree_common_prefix": keys[i][:common[i]]})
        r.end()
        return {"height": height, "entries": entries}

    def entries(self) -> Iterator[Tuple[bytes, Tuple[str, object]]]:
        """(key, value reference) of the newest version, in key order."""
        version = self.manifest["versions"][-1] if \
            self.manifest["versions"] else None
        if version is None or "location" not in version["root"]:
            return
        yield from self._walk(version["root"]["location"], b"")

    def _walk(self, location: str, prefix: bytes):
        node = self.node(location)
        for e in node["entries"]:
            if node["height"] == 0:
                yield prefix + e["key"], e["value"]
            else:
                yield from self._walk(e["location"],
                                      prefix + e["subtree_common_prefix"])

    def read_value(self, ref) -> bytes:
        kind, what = ref
        return what if kind == "inline" else self._range(what)

    def items(self) -> Dict[str, bytes]:
        """Every key of the newest version and its value."""
        return {k.decode(): self.read_value(v) for k, v in self.entries()}


# ---- writing ----------------------------------------------------------------

def _keys(keys: List[bytes], common: bool) -> bytes:
    """The entry count and the prefix-coded keys (an interior node's
    common-prefix lengths, all 0, between the lengths and the bytes)."""
    shared = _shared(keys)
    full = [0] + shared
    return (_varint(len(keys)) + _varints(shared)
            + _varints(len(k) - n for k, n in zip(keys, full))
            + (_varints(0 for _ in keys) if common else b"")
            + b"".join(k[n:] for k, n in zip(keys, full)))


def _leaf_body(keys: List[bytes], values: List[bytes], offsets,
               files: List[str]) -> bytes:
    """A leaf: ``offsets[i]`` is value i's offset in data file 0, or None
    when it is stored inline."""
    ind = [o for o in offsets if o is not None]
    return (bytes((0,)) + _write_files(files) + _keys(keys, common=False)
            + _varints(len(v) for v in values)
            + _varints(0 if o is None else 1 for o in offsets)
            + _varints(0 for _ in ind) + _varints(ind)
            + b"".join(v for v, o in zip(values, offsets) if o is None))


def _interior_body(height: int, children, files: List[str]) -> bytes:
    """children: (first key, (offset, length) in data file 0, keys, tree
    bytes, indirect bytes); each child's keys are stored whole."""
    return (bytes((height,)) + _write_files(files)
            + _keys([c[0] for c in children], common=True)
            + _varints(0 for _ in children)
            + b"".join(_varints(field(c) for c in children) for field in (
                lambda c: c[1][0], lambda c: c[1][1], lambda c: c[2],
                lambda c: c[3], lambda c: c[4])))


def write_database(root, items: Dict[str, bytes],
                   leaf_entries: int = 4096) -> None:
    """A new database under ``root`` holding ``items`` (key -> bytes) as one
    version, at most ``leaf_entries`` keys a node.  The manifest is written
    last, so a reader sees the whole database or none."""
    kv = open_kvstore(root)
    name = f"d/{_uuid.uuid4().hex}"
    parts: List[bytes] = []  # the data file, written as it is laid out
    size = 0
    keys = sorted(k.encode() for k in items)
    vals = [items[k.decode()] for k in keys]
    vrefs = []
    for v in vals:
        if len(v) > MAX_INLINE:
            vrefs.append(size)
            parts.append(v)
            size += len(v)
        else:
            vrefs.append(None)
    indirect_total = size
    vals = [bytes(v) if r is None else v for v, r in zip(vals, vrefs)]
    files = [name]
    # leaves, then interior levels until one node is left
    level = []
    for a in range(0, max(len(keys), 1), leaf_entries):
        ks, vs, rs = keys[a:a + leaf_entries], vals[a:a + leaf_entries], \
            vrefs[a:a + leaf_entries]
        node = _frame(_leaf_body(ks, vs, rs, files), BTREE_MAGIC)
        loc = (size, len(node))
        parts.append(node)
        size += len(node)
        level.append((ks[0] if ks else b"", loc, len(ks), len(node),
                      sum(len(v) for v, r in zip(vs, rs) if r is not None)))
    height = 0
    while len(level) > 1:
        height += 1
        up = []
        for a in range(0, len(level), leaf_entries):
            kids = level[a:a + leaf_entries]
            node = _frame(_interior_body(height, kids, files), BTREE_MAGIC)
            loc = (size, len(node))
            parts.append(node)
            size += len(node)
            up.append((kids[0][0], loc, sum(c[2] for c in kids),
                       len(node) + sum(c[3] for c in kids),
                       sum(c[4] for c in kids)))
        level = up
    _, (offset, length), nkeys, tree_bytes, _ = level[0]
    kv.write(name, parts)
    body = bytearray(_uuid.uuid4().bytes)
    body += _varint(0) + _varint(MAX_INLINE) + _varint(MAX_DECODED_NODE_BYTES)
    body += bytes((ARITY_LOG2,)) + _varint(1) + struct.pack("<i", 0)
    body += _write_files(files)
    body += _varint(1) + _varint(1) + bytes((height,)) + _varint(0)
    body += _varint(offset) + _varint(length) + _varint(nkeys)
    body += _varint(tree_bytes) + _varint(indirect_total)
    body += struct.pack("<Q", time.time_ns())
    body += _varint(0)  # no version-tree nodes
    kv.write("manifest.ocdbt", _frame(bytes(body), MANIFEST_MAGIC))
