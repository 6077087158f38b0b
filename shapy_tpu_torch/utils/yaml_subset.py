"""A reader for the subset of YAML that the repository's files use: the
anchor files (``assets/measurements/*.yaml``), the experiment configs
(``configs/*.yaml``) and a dataset's ``genders.yaml``.

The subset: nested block maps; block lists (lists of lists written
``- - x``); flow lists (``[1024, 1024]``, ``['hbw']``, nested, ``[]``)
and the empty flow map ``{}``; plain scalars resolved as PyYAML's
``safe_load`` resolves them (YAML 1.1: ``1e-4`` stays a string, ``1.0e-4``
is a float, ``True`` / ``yes`` / ``on`` are booleans, ``~`` / ``null`` and
an empty value are None, octal / hex / binary ints); single-quoted
(``''`` escapes a quote) and double-quoted scalars without backslash
escapes; and comments, whole-line or after a value (a ``#`` at the start
of a line or after a space, outside quotes).

The port runs where PyYAML is not installed, so it reads these files
itself. Anchors, aliases, tags, block strings, non-empty flow maps,
backslash escapes, sexagesimal numbers and timestamps raise
``ValueError``. The tests check that every file above reads as PyYAML
reads it.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_Line = Tuple[int, str]  # (indent, text)

_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
# Resolved by PyYAML to types this reader does not build.
_UNSUPPORTED_RE = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"  # sexagesimal
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*"  # timestamps
    r"|<<|=)$")


def _plain(text: str) -> Any:
    """A plain (unquoted) scalar, resolved as PyYAML's SafeLoader does."""
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return _BOOL[text.lower()]
    if _INT_RE.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(text):
        v = text.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v == ".nan":
            return float("nan")
        return float(v)
    if _UNSUPPORTED_RE.match(text) or text[0] in "&*!|>%@`":
        raise ValueError(f"unsupported YAML: {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[i]``; returns it and the index
    after its closing quote."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if c == q:
            if q == "'" and text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if c == "\\" and q == '"':
            raise ValueError(f"unsupported YAML escape: {text!r}")
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """The flow value (a list, ``{}`` or a scalar) starting at ``text[i]``;
    returns it and the index after it."""
    while i < len(text) and text[i] == " ":
        i += 1
    if i < len(text) and text[i] == "[":
        items: List[Any] = []
        i += 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == "]":
                return items, i + 1
            value, i = _flow(text, i)
            items.append(value)
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
            elif i < len(text) and text[i] == "]":
                return items, i + 1
            else:
                raise ValueError(f"unsupported YAML flow list: {text!r}")
    if text.startswith("{}", i):
        return {}, i + 2
    if i < len(text) and text[i] in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",[]{}":
        j += 1
    value = text[i:j].strip()
    if not value or text[j:j + 1] in ("[", "{"):
        raise ValueError(f"unsupported YAML flow value: {text!r}")
    return _plain(value), j


def _scalar(text: str) -> Any:
    """A value written on one line: a flow list, ``{}``, a quoted or a
    plain scalar."""
    if text[0] in "[{'\"":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"unsupported YAML: {text!r}")
        return value
    return _plain(text)


def _strip_comment(raw: str) -> str:
    """``raw`` without its comment: a ``#`` at the start of the text or
    after a space or tab, outside quotes."""
    quote = None
    for j, c in enumerate(raw):
        if quote is not None:
            if c == quote:
                quote = None
        elif c in "'\"" and (j == 0 or raw[j - 1] in " \t-[,:{"):
            quote = c
        elif c == "#" and (j == 0 or raw[j - 1] in " \t"):
            return raw[:j].rstrip()
    return raw.rstrip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str) -> Tuple[Any, str] | None:
    """A map entry's (key, value text), or None if ``text`` is no entry."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0)
    else:
        end = text.find(": ")
        if end < 0:
            end = len(text) - 1 if text.endswith(":") else -1
        if end <= 0 or text[0] in "[{":
            return None
        key = _plain(text[:end].strip())
    rest = text[end:]
    if not rest.startswith(":") or (len(rest) > 1 and rest[1] != " "):
        return None
    return key, rest[1:].strip()


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[Any, int]:
    """The value whose first line is ``lines[i]`` at ``indent``; returns it
    and the index of the first line after it."""
    text = lines[i][1]
    if _is_item(text):
        items = []
        while i < len(lines) and lines[i][0] == indent and _is_item(
                lines[i][1]):
            rest = lines[i][1][1:].lstrip()
            if rest:  # "- x": x sits in a column of its own
                sub = indent + len(lines[i][1]) - len(rest)
                lines[i] = (sub, rest)
                value, i = _block(lines, i, sub)
            elif i + 1 < len(lines) and lines[i + 1][0] > indent:
                value, i = _block(lines, i + 1, lines[i + 1][0])
            else:
                value, i = None, i + 1
            items.append(value)
        return items, i
    if _split_key(text) is None:
        return _scalar(text), i + 1
    out = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(
            lines[i][1]):
        entry = _split_key(lines[i][1])
        if entry is None:
            raise ValueError(f"unsupported YAML line: {lines[i][1]!r}")
        key, rest = entry
        if rest:
            out[key], i = _scalar(rest), i + 1
        elif i + 1 < len(lines) and (lines[i + 1][0] > indent or (
                lines[i + 1][0] == indent and _is_item(lines[i + 1][1]))):
            out[key], i = _block(lines, i + 1, lines[i + 1][0])
        else:
            out[key], i = None, i + 1
    return out, i


def loads(text: str) -> Any:
    """Parse ``text`` (see the module docstring for the subset)."""
    lines: List[_Line] = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        stripped = _strip_comment(raw).strip()
        if not stripped or stripped == "---":
            continue
        lines.append((len(raw) - len(raw.lstrip(" ")), stripped))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unsupported YAML near line: {lines[i][1]!r}")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
