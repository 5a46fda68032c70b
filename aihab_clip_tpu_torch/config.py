"""Two-layer YAML configuration (counterpart of ``aihab_clip_tpu/config.py``).

  * ``ConfigNode`` — dict subclass with attribute access and pretty printing.
  * ``load_config_file`` — YAML -> ConfigNode, through ``safe_load`` below.
  * ``load_configs`` — base + dataset layering (dataset shallow-overrides base).
  * ``merge_from_pairs`` — ``--opts KEY VALUE ...`` overrides: a dotted key
    that resolves in the nested tree is set in place, else the last dotted
    segment must name an existing top-level key; values are literal-eval'd
    and strictly type-coerced.
  * ``set_by_dotted_path`` / ``get_by_dotted_path`` — nested dotted-key
    overrides that may create new nested keys (the sweep-launcher semantic).

``safe_load`` is the package's own reader for the YAML subset the config
files use: block mappings and sequences, flow sequences and mappings,
comments, single- and double-quoted scalars, and plain scalars resolved
exactly as PyYAML's ``safe_load`` resolves them (YAML 1.1: ``1e-4`` without
a dot is a string, ``0.00005`` a float, ``yes``/``off`` booleans, ``010``
octal, ``~`` null).  Block scalars (``|``, ``>``), anchors, aliases and tags
raise ``ValueError``.
"""

from __future__ import annotations

import copy
import datetime
import math
import os
import re
from ast import literal_eval
from pathlib import Path
from typing import Any, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), keyed like PyYAML by the
# scalar's first character and tried in PyYAML's registration order
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")
_INT_RE = re.compile(
    r"^(?:[-+]?0b[0-1_]+"
    r"|[-+]?0[0-7_]+"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?"
    r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_TIMESTAMP_PARTS = re.compile(
    r"^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)"
    r"-(?P<day>[0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])"
    r":(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?"
    r"(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)"
    r"(?::(?P<tz_minute>[0-9][0-9]))?))?)?$")

_FIRST = {
    "bool": set("yYnNtTfFoO"),
    "float": set("-+0123456789."),
    "int": set("-+0123456789"),
    "null": set("~nN"),
    "timestamp": set("0123456789"),
}


def _sexagesimal(text: str, cast) -> Any:
    digits = [cast(part) for part in text.split(":")]
    digits.reverse()
    base, value = 1, 0
    for d in digits:
        value += d * base
        base *= 60
    return value


def _construct_int(text: str) -> int:
    value = text.replace("_", "")
    sign = 1
    if value[0] == "-":
        sign, value = -1, value[1:]
    elif value[0] == "+":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = 1.0
    if value[0] == "-":
        sign, value = -1.0, value[1:]
    elif value[0] == "+":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _construct_timestamp(text: str):
    m = _TIMESTAMP_PARTS.match(text)
    v = m.groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if v["fraction"]:
        fraction = int(v["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]),
                                   minutes=int(v["tz_minute"] or 0))
        if v["tz_sign"] == "-":
            delta = -delta
        tzinfo = datetime.timezone(delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]),
                             int(v["minute"]), int(v["second"]), fraction,
                             tzinfo=tzinfo)


def resolve_plain_scalar(text: str) -> Any:
    """A plain (unquoted) YAML scalar -> its Python value, by PyYAML's
    implicit resolvers."""
    first = text[:1]
    if text == "" or first in _FIRST["null"]:
        if _NULL_RE.match(text):
            return None
    if first in _FIRST["bool"] and _BOOL_RE.match(text):
        return text.lower() in ("yes", "true", "on")
    if first in _FIRST["float"] and _FLOAT_RE.match(text):
        return _construct_float(text)
    if first in _FIRST["int"] and _INT_RE.match(text):
        return _construct_int(text)
    if first in _FIRST["timestamp"] and _TIMESTAMP_RE.match(text):
        return _construct_timestamp(text)
    return text


_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": " ", "P": " "}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


class _Cursor:
    """A position in one line of text, for flow and quoted scalars."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def error(self, msg: str) -> ValueError:
        return ValueError(f"{self.where}: {msg} in {self.text!r}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() in (" ", "\t") and self.peek():
            self.pos += 1

    def at_comment_or_end(self) -> bool:
        self.skip_spaces()
        return self.peek() in ("", "#")


def _quoted(cur: _Cursor) -> str:
    quote = cur.peek()
    cur.pos += 1
    out = []
    while True:
        ch = cur.peek()
        if ch == "":
            raise cur.error("unterminated quoted scalar")
        cur.pos += 1
        if quote == "'":
            if ch == "'":
                if cur.peek() == "'":
                    out.append("'")
                    cur.pos += 1
                    continue
                return "".join(out)
            out.append(ch)
            continue
        if ch == '"':
            return "".join(out)
        if ch == "\\":
            esc = cur.peek()
            cur.pos += 1
            if esc in _DQ_ESCAPES:
                out.append(_DQ_ESCAPES[esc])
            elif esc in _DQ_HEX:
                n = _DQ_HEX[esc]
                code = cur.text[cur.pos:cur.pos + n]
                if len(code) != n:
                    raise cur.error("short escape")
                out.append(chr(int(code, 16)))
                cur.pos += n
            else:
                raise cur.error(f"unknown escape \\{esc}")
            continue
        out.append(ch)


def _plain(cur: _Cursor, flow: bool) -> str:
    """A plain scalar up to a comment, the end, or (in flow context) a
    flow indicator; trailing spaces dropped."""
    start = cur.pos
    stops = ",[]{}" if flow else ""
    while True:
        ch = cur.peek()
        if ch == "":
            break
        if ch == "#" and cur.pos > start and cur.text[cur.pos - 1] in " \t":
            break
        if ch in stops:
            break
        if ch == ":" and flow and cur.text[cur.pos + 1:cur.pos + 2] in (
                "", " ", ",", "]", "}"):
            break
        cur.pos += 1
    return cur.text[start:cur.pos].rstrip()


def _flow_node(cur: _Cursor) -> Any:
    cur.skip_spaces()
    ch = cur.peek()
    if ch == "[":
        cur.pos += 1
        items = []
        while True:
            cur.skip_spaces()
            if cur.peek() == "]":
                cur.pos += 1
                return items
            items.append(_flow_node(cur))
            cur.skip_spaces()
            if cur.peek() == ",":
                cur.pos += 1
            elif cur.peek() != "]":
                raise cur.error("expected ',' or ']'")
    if ch == "{":
        cur.pos += 1
        mapping = {}
        while True:
            cur.skip_spaces()
            if cur.peek() == "}":
                cur.pos += 1
                return mapping
            key = _flow_node(cur)
            cur.skip_spaces()
            value = None
            if cur.peek() == ":":
                cur.pos += 1
                cur.skip_spaces()
                if cur.peek() not in (",", "}"):
                    value = _flow_node(cur)
            mapping[key] = value
            cur.skip_spaces()
            if cur.peek() == ",":
                cur.pos += 1
            elif cur.peek() != "}":
                raise cur.error("expected ',' or '}'")
    if ch in ("'", '"'):
        return _quoted(cur)
    if ch in ("&", "*", "!", "|", ">", "@", "`"):
        raise cur.error(f"unsupported YAML indicator {ch!r}")
    return resolve_plain_scalar(_plain(cur, flow=True))


def _inline_value(text: str, where: str) -> Any:
    """The value after ``key:`` or ``- `` on the same line."""
    cur = _Cursor(text, where)
    cur.skip_spaces()
    ch = cur.peek()
    if ch in ("[", "{", "'", '"'):
        value = _flow_node(cur)
        if not cur.at_comment_or_end():
            raise cur.error("trailing characters after a flow node")
        return value
    if ch in ("&", "*", "!", "|", ">", "@", "`", "%"):
        raise cur.error(f"unsupported YAML indicator {ch!r}")
    return resolve_plain_scalar(_plain(cur, flow=False))


def _split_key(text: str, where: str) -> Optional[Tuple[Any, str]]:
    """``key: rest`` -> (key, rest); None when the line is no mapping
    entry."""
    cur = _Cursor(text, where)
    if cur.peek() in ("'", '"'):
        key = _quoted(cur)
        cur.skip_spaces()
        if cur.peek() != ":":
            return None
        return key, text[cur.pos + 1:]
    i = 0
    while True:
        i = text.find(":", i)
        if i < 0:
            return None
        if i + 1 == len(text) or text[i + 1] in " \t":
            head = text[:i]
            if "#" in head and re.search(r"[ \t]#", head):
                return None
            return resolve_plain_scalar(head.rstrip()), text[i + 1:]
        i += 1


class _Lines:
    def __init__(self, text: str, name: str):
        self.items: List[Tuple[int, str, int]] = []
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError(f"{name}:{no}: tab in indentation")
            stripped = raw.strip()
            if not stripped or stripped.startswith("#"):
                continue
            if stripped in ("---", "...") and raw.startswith(stripped):
                continue
            if stripped.startswith("%"):
                continue
            self.items.append((len(raw) - len(raw.lstrip(" ")),
                               raw.strip(" ").rstrip(), no))
        self.i, self.name = 0, name

    def peek(self):
        return self.items[self.i] if self.i < len(self.items) else None

    def where(self, no: int) -> str:
        return f"{self.name}:{no}"


def _block(lines: _Lines, indent: int) -> Any:
    """The block node whose lines start at ``indent``."""
    head = lines.peek()
    if head is None:
        return None
    if head[1] == "-" or head[1].startswith("- "):
        return _block_seq(lines, indent)
    return _block_map(lines, indent)


def _value_after(lines: _Lines, rest: str, parent_indent: int, no: int,
                 seq_ok_at_parent: bool) -> Any:
    """The value of an entry whose inline text is ``rest``: an inline
    scalar or flow node, else the indented block below (a sequence may sit
    at the parent's own indentation under a mapping key)."""
    if rest.strip() and not rest.strip().startswith("#"):
        return _inline_value(rest, lines.where(no))
    nxt = lines.peek()
    if nxt is None:
        return None
    if nxt[0] > parent_indent:
        return _block(lines, nxt[0])
    if (seq_ok_at_parent and nxt[0] == parent_indent
            and (nxt[1] == "-" or nxt[1].startswith("- "))):
        return _block_seq(lines, parent_indent)
    return None


def _block_map(lines: _Lines, indent: int) -> dict:
    out: dict = {}
    while True:
        line = lines.peek()
        if line is None or line[0] < indent:
            return out
        ind, text, no = line
        if ind > indent:
            raise ValueError(f"{lines.where(no)}: unexpected indentation")
        if text == "-" or text.startswith("- "):
            return out
        kv = _split_key(text, lines.where(no))
        if kv is None:
            raise ValueError(f"{lines.where(no)}: expected 'key: value', "
                             f"got {text!r}")
        key, rest = kv
        lines.i += 1
        out[key] = _value_after(lines, rest, indent, no, True)


def _block_seq(lines: _Lines, indent: int) -> list:
    out: list = []
    while True:
        line = lines.peek()
        if line is None or line[0] != indent:
            return out
        _, text, no = line
        if not (text == "-" or text.startswith("- ")):
            return out
        rest = text[1:]
        body = rest.lstrip(" ")
        if body and not body.startswith("#") and body[0] not in "[{'\"" \
                and _split_key(body, lines.where(no)) is not None:
            # "- key: value": a mapping whose first line shares the dash;
            # its other keys sit at the column of that first key
            col = indent + 1 + (len(rest) - len(body))
            lines.items[lines.i] = (col, body, no)
            out.append(_block_map(lines, col))
            continue
        lines.i += 1
        out.append(_value_after(lines, rest, indent, no, False))


def safe_load(text: str, name: str = "<yaml>") -> Any:
    """Parse YAML ``text`` (the subset in the module docstring) into plain
    dicts, lists and scalars, as ``yaml.safe_load`` would."""
    lines = _Lines(text, name)
    if lines.peek() is None:
        return None
    first = lines.peek()
    if first[0] == 0 and _split_key(first[1], name) is None and not (
            first[1] == "-" or first[1].startswith("- ")):
        lines.i += 1
        return _inline_value(first[1], lines.where(first[2]))
    node = _block(lines, first[0])
    rest = lines.peek()
    if rest is not None:
        raise ValueError(f"{lines.where(rest[2])}: unexpected line {rest[1]!r}")
    return node


# ---------------------------------------------------------------------------
# Config tree
# ---------------------------------------------------------------------------


class ConfigNode(dict):
    """Dict-like config tree with attribute access: ``cfg['key']``,
    ``cfg.key`` and ``cfg.get(...)`` all work."""

    def __init__(self, init_dict: Optional[dict] = None):
        init_dict = {} if init_dict is None else dict(init_dict)
        for k, v in init_dict.items():
            if type(v) is dict:
                init_dict[k] = ConfigNode(v)
        super().__init__(init_dict)

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __str__(self) -> str:
        return "\n".join(self._render_lines(""))

    def _render_lines(self, prefix: str):
        for key in sorted(self):
            value = self[key]
            if isinstance(value, ConfigNode):
                yield f"{prefix}{key}:"
                yield from value._render_lines(prefix + "  ")
            else:
                yield f"{prefix}{key}: {value}"

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({super().__repr__()})"

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else v
        return out


def decode_value(v: Any) -> Any:
    """Decode a string override into a Python literal when possible."""
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def coerce_value_type(replacement: Any, original: Any, full_key: str) -> Any:
    """Coerce ``replacement`` to the type of ``original`` or raise: an exact
    type match passes, int widens to float, tuple<->list converts, a string
    spelling of a boolean becomes the boolean, a boolean may replace a
    string (tri-state keys); ``None`` on either side accepts anything."""
    if original is None or replacement is None:
        return replacement
    original_type, replacement_type = type(original), type(replacement)
    if replacement_type is original_type:
        return replacement
    if replacement_type is int and original_type is float:
        return float(replacement)
    if isinstance(replacement, tuple) and isinstance(original, list):
        return list(replacement)
    if isinstance(replacement, list) and isinstance(original, tuple):
        return tuple(replacement)
    if isinstance(original, bool) and isinstance(replacement, str):
        low = replacement.lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
    if isinstance(original, str) and isinstance(replacement, bool):
        return replacement
    raise ValueError(
        f"Type mismatch ({original_type} vs. {replacement_type}) with values "
        f"({original} vs. {replacement}) for config key: {full_key}")


def load_config_file(path: str | Path) -> ConfigNode:
    path = str(path)
    if not (os.path.isfile(path) and path.endswith((".yaml", ".yml"))):
        raise ValueError(f"{path} is not a yaml file")
    with open(path, "r", encoding="utf-8") as f:
        raw = safe_load(f.read(), name=path) or {}
    return ConfigNode(raw)


def resolve_config_path(p: str, anchors: Sequence[Path] = ()) -> str:
    """Resolve a config path relative to cwd or the given anchor dirs."""
    cand = Path(p)
    if cand.is_file():
        return str(cand)
    for anchor in anchors:
        c = Path(anchor) / p
        if c.is_file():
            return str(c)
    tried = [str(cand)] + [str(Path(a) / p) for a in anchors]
    raise FileNotFoundError(f"Config not found at '{p}' (tried: {tried})")


def load_configs(base_config: str, dataset_config: Optional[str] = None,
                 opts: Optional[List[str]] = None,
                 anchors: Sequence[Path] = ()) -> ConfigNode:
    """base + dataset layering: dataset shallow-overrides base top-level keys."""
    cfg = load_config_file(resolve_config_path(base_config, anchors))
    if dataset_config:
        ds = load_config_file(resolve_config_path(dataset_config, anchors))
        cfg.update(ds)
    if opts:
        cfg = merge_from_pairs(cfg, opts)
    return cfg


def merge_from_pairs(cfg: ConfigNode, pairs: Sequence[str]) -> ConfigNode:
    """Apply ``--opts KEY VALUE ...`` overrides (see the module docstring);
    unknown keys raise ``KeyError``, mistyped values ``ValueError``."""
    new_cfg = copy.deepcopy(cfg)
    if len(pairs) % 2 != 0:
        raise ValueError(f"--opts expects KEY VALUE pairs, got: {list(pairs)}")
    _missing = object()
    for full_key, v in zip(pairs[0::2], pairs[1::2]):
        value = decode_value(v)
        nested = get_by_dotted_path(cfg, full_key, _missing)
        if "." in full_key and nested is not _missing:
            set_by_dotted_path(new_cfg, full_key,
                               coerce_value_type(value, nested, full_key),
                               coerce=False)
            continue
        subkey = full_key.split(".")[-1]
        if subkey not in cfg:
            raise KeyError(f"Non-existent key: {full_key}")
        value = coerce_value_type(value, cfg[subkey], full_key)
        setattr(new_cfg, subkey, value)
    return new_cfg


def get_by_dotted_path(cfg: ConfigNode, dotted: str, default: Any = None) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return default
    return node


def set_by_dotted_path(cfg: ConfigNode, dotted: str, value: Any,
                       coerce: bool = True) -> None:
    """Write a (possibly new) nested key via a dotted path, in place:
    intermediate ConfigNodes are created as needed and an existing leaf's
    type is kept where the value coerces to it."""
    parts = dotted.split(".")
    node: Any = cfg
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            node[part] = ConfigNode()
        node = node[part]
    leaf = parts[-1]
    value = decode_value(value)
    if coerce and leaf in node and node[leaf] is not None:
        try:
            value = coerce_value_type(value, node[leaf], dotted)
        except ValueError:
            pass  # sweep overrides are permissive; keep the decoded value
    node[leaf] = value


def apply_dotted_overrides(cfg: ConfigNode,
                           overrides: Iterable[tuple[str, Any]]) -> ConfigNode:
    out = copy.deepcopy(cfg)
    for dotted, value in overrides:
        set_by_dotted_path(out, dotted, value)
    return out
