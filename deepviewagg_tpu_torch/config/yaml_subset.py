"""A reader for the YAML subset of the run configurations and of the
reference's published Hydra / Torch-Points3D files.

The card's machine has no PyYAML, so the port reads ``conf/*.yaml``, the
``key=value`` override values and the reference YAMLs of ``ref:`` models and
``data.ref`` itself, always (not as a fallback).  The subset:

  * block mappings nested by indentation (``key: value`` / ``key:`` + a more
    indented block; an empty value with no block below is ``None``);
  * block sequences (``- item``), of scalars, of flow values, of mappings
    (``- transform: RandomNoise`` with ``params:`` on the next, more indented
    lines) and of sequences (``- - a``, or ``-`` and a more indented block),
    also at the indentation of the key that holds them (``defaults:`` then
    ``- /data/segmentation/kitti360-sparse``);
  * ``#`` comments, whole-line or after whitespace, outside quotes;
  * flow sequences and mappings, nested, on one line or over several
    (``down_conv_nn:`` then ``[`` ... ``[FEAT, 32], ...`` ... ``]``):
    ``[1024, 512]``, ``[]``, ``{n_areas: 2, size: [64, 32]}``;
  * scalars resolved as PyYAML's ``safe_load`` resolves them (YAML 1.1):
    ``true``/``false`` (and ``yes``/``no``/``on``/``off``), ``null``/``~``,
    decimal / octal / hex / binary ints, floats with a dot (``1e-4`` without
    one stays a string, as in PyYAML), ``.inf`` / ``.nan``, bare and quoted
    strings (``${data.resolution_2d}``, ``FEAT + l4``).

Anything else (anchors and aliases, tags, block scalars, multi-line plain or
quoted scalars, sexagesimal numbers, timestamps, several documents, a plain
scalar holding a flow indicator inside a flow collection) raises
``ValueError`` instead of being read differently from PyYAML.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

__all__ = ["safe_load"]

_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# forms PyYAML resolves to types this reader does not build
_UNSUPPORTED = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")
_INDICATORS = "&*!|>%@`"


def _scalar(text: str) -> Any:
    """A plain (unquoted) scalar, resolved like PyYAML's ``safe_load``."""
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _UNSUPPORTED.match(text):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    if text[0] in _INDICATORS or text[:2] in ("- ", "? ") or text in "-?":
        raise ValueError(f"unsupported YAML syntax {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        raise ValueError(f"unsupported YAML scalar {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at ``text[i]`` and the index after it."""
    q = text[i]
    out, j = [], i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = text[j + 1:j + 2]
            table = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/",
                     "0": "\0", "r": "\r"}
            if esc not in table:
                raise ValueError(f"unsupported escape \\{esc} in {text!r}")
            out.append(table[esc])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted string in {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes) and trailing whitespace."""
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote:
            if c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif quote == '"' and c == "\\":
                i += 1
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Recursive-descent reader of one flow value (``[...]``, ``{...}``, a
    quoted or a plain scalar)."""

    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def _ws(self):
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def value(self, stops: str = "") -> Any:
        self._ws()
        t = self.text
        if self.i >= len(t):
            return None
        c = t[self.i]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "'\"":
            s, self.i = _quoted(t, self.i)
            return s
        j = self.i
        while j < len(t) and t[j] not in stops:
            if stops and t[j] == ":" and t[j + 1:j + 2] in (" ", ""):
                break
            j += 1
        raw = t[self.i:j].strip()
        self.i = j
        if stops and any(c in raw for c in "[]{}"):
            # PyYAML ends a plain scalar at a flow indicator here
            raise ValueError(f"flow indicator in plain scalar {raw!r}")
        return _scalar(raw)

    def _seq(self) -> List:
        self.i += 1
        out = []
        while True:
            self._ws()
            if self.text[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(",]"))
            self._ws()
            c = self.text[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "]":
                raise ValueError(f"bad flow sequence {self.text!r}")

    def _map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self._ws()
            if self.text[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value(",}")
            self._ws()
            if self.text[self.i:self.i + 1] == ":":
                self.i += 1
                out[key] = self.value(",}")
            else:
                out[key] = None
            self._ws()
            c = self.text[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "}":
                raise ValueError(f"bad flow mapping {self.text!r}")


def _inline(text: str) -> Any:
    """A whole value written on one line."""
    reader = _Flow(text)
    v = reader.value()
    reader._ws()
    if reader.i != len(text):
        raise ValueError(f"unsupported YAML value {text!r}")
    return v


def _split_key(content: str):
    """``(key, rest)`` of a ``key: value`` line, or None."""
    if content[0] in "'\"":
        key, j = _quoted(content, 0)
        if content[j:j + 1] == ":" and content[j + 1:j + 2] in ("", " "):
            return key, content[j + 1:].strip()
        return None
    if content.startswith(("[", "{")):
        return None
    m = re.match(r"^([^:]*?):(?: +(.*))?$", content)
    if m is None:
        return None
    return _scalar(m.group(1).strip()), (m.group(2) or "").strip()


def _is_item(content: str) -> bool:
    """Whether a line's content opens a block sequence item."""
    return content == "-" or content.startswith("- ")


def _flow_end(text: str) -> int:
    """Depth of the open ``[`` / ``{`` at the end of ``text`` (quotes
    skipped); below zero when a bracket closes that did not open."""
    depth, i, quote = 0, 0, None
    while i < len(text):
        c = text[i]
        if quote:
            if c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
            elif quote == '"' and c == "\\":
                i += 1
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth


def _value(lines, i: int, text: str):
    """The value ``text`` that starts on line ``i - 1``, with the following
    lines of a flow collection that spans lines joined to it; returns
    ``(value, index of the next line)``."""
    if text[0] in "[{":
        while _flow_end(text) > 0:
            if i >= len(lines):
                raise ValueError(f"unterminated flow collection {text!r}")
            text += " " + lines[i][1]
            i += 1
    return _inline(text), i


def _node(lines, i: int, indent: int):
    """The block node whose first line ``lines[i]`` sits at ``indent``."""
    content = lines[i][1]
    if _is_item(content):
        return _block_seq(lines, i, indent)
    if _split_key(content) is not None:
        return _block_map(lines, i, indent)
    return _value(lines, i + 1, content)


def safe_load(text: str) -> Any:
    """The value of a YAML document in the subset of the module docstring;
    ``None`` for an empty document."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation")
        content = _strip_comment(raw)
        if content.strip() in ("---", "...") and not raw.startswith(" "):
            raise ValueError("document markers are not supported")
        if content.strip():
            lines.append((len(content) - len(content.lstrip(" ")),
                          content.strip()))
    if not lines:
        return None
    value, end = _node(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"bad indentation at {lines[end][1]!r}")
    return value


def _block_seq(lines, start: int, indent: int):
    """The block sequence whose items start at ``indent``.  An item's text
    after ``- `` is read as a node at its own column (a compact mapping or
    sequence continues on the following lines at that column)."""
    out = []
    i = start
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        rest = lines[i][1][1:]
        item = rest.lstrip(" ")
        if item:
            col = indent + 1 + len(rest) - len(item)
            lines[i] = (col, item)
            value, i = _node(lines, i, col)
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            value, i = _node(lines, i + 1, lines[i + 1][0])
        else:
            value, i = None, i + 1
        out.append(value)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def _block_map(lines, start: int, indent: int):
    out = {}
    i = start
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key], i = _value(lines, i, rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_item(lines[i][1]))):
            # a more indented block, or a sequence at the key's column
            out[key], i = _node(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i
