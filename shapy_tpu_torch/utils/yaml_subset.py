"""A reader for the subset of YAML that the repository's anchor files use
(``assets/measurements/*.yaml``): nested block maps, block lists (lists
of lists written ``- - x``), and plain scalars (int, float, a bare or
simply quoted string, the empty ``[]`` and ``{}``).

The port runs where PyYAML is not installed, so it reads these files
itself. Flow collections, anchors, tags and block strings raise
``ValueError``; inline comments and other YAML beyond the subset are not
supported. ``tests/test_torch_fit_measurements.py`` checks that the anchor
files read as PyYAML reads them.
"""

from __future__ import annotations

from typing import Any, List, Tuple

_Line = Tuple[int, str]  # (indent, text)


def _scalar(text: str) -> Any:
    if text in ("[]", "{}"):
        return [] if text == "[]" else {}
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"" and (
            "\\" not in text and text[0] not in text[1:-1]):
        return text[1:-1]
    if text[0] in "[{&*!|>'\"":
        raise ValueError(f"unsupported YAML: {text!r}")
    if text in ("null", "~"):
        return None
    if text in ("true", "false"):
        return text == "true"
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


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
    if ":" not in text:
        return _scalar(text), i + 1
    out = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(
            lines[i][1]):
        key, sep, rest = lines[i][1].partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"unsupported YAML line: {lines[i][1]!r}")
        key, rest = key.strip(), rest.strip()
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
        stripped = raw.strip()
        if not stripped or stripped.startswith("#") or stripped == "---":
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
