"""
A YAML reader on the standard library (the port's ``yaml.safe_load``:
the card's machine has no PyYAML), for the subset the repo's configs use.

Covered:

- block mappings and block sequences, including ``- key: value`` items
  and a sequence written at its key's own indentation;
- flow sequences and mappings (``[tag-0, 'tag-1']``,
  ``{n_components: 2}``), also over several lines;
- plain scalars, also folded over more-indented lines; single- and
  double-quoted scalars on one line;
- ``#`` comments, anchors ``&x`` and aliases ``*x``;
- one document, which may open with ``---``.

Plain scalars resolve as PyYAML's YAML 1.1 ``SafeLoader`` resolves
them: ``yes``/``no``/``on``/``off``/``true``/``false`` in their three
case forms are booleans; ``~``, ``null`` and an empty value are None;
integers may be ``0x``, ``0b``, octal with a leading ``0``, contain
``_``, or be sexagesimal (``1:20`` is 80); a float needs a dot and a
signed exponent (``1e3`` stays a string, ``1.0e+3`` is 1000.0), and
``.inf``/``.nan`` are floats; a timestamp becomes an aware ``datetime``
when it carries an offset or ``Z`` and a naive one otherwise, and a bare
date a ``date``.

Anything else (tags, block scalars ``|`` and ``>``, merge keys ``<<``,
complex keys ``?``, directives, more than one document, multi-line
quoted scalars, tabs in indentation) raises ``ValueError`` naming the
line: the reader never returns a value other than PyYAML's in silence.
"""

import math
import re
from datetime import date, datetime, timedelta, timezone
from typing import Any, Dict, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), each tried only for
# plain scalars starting with one of its first characters, in this order
_BOOL_RE = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$"
)
_FLOAT_RE = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT_RE = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
# PyYAML's SafeConstructor.timestamp_regexp
_TIMESTAMP_PARTS = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])
    -(?P<month>[0-9][0-9]?)
    -(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)
    (?P<hour>[0-9][0-9]?)
    :(?P<minute>[0-9][0-9])
    :(?P<second>[0-9][0-9])
    (?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""",
    re.X,
)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
# double-quoted escapes (PyYAML's ESCAPE_REPLACEMENTS and ESCAPE_CODES)
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
    "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# characters that end an anchor or alias name
_NAME_END = " \t\n,[]{}"


def safe_load(stream, require_timezone: bool = False) -> Any:
    """
    The value of one YAML document (text or a file-like object), as
    ``yaml.safe_load`` gives it. With ``require_timezone``, a timestamp
    without an offset (a bare date too) raises ``ValueError``, as the
    JAX package's config loader does.
    """
    text = stream.read() if hasattr(stream, "read") else stream
    return _Reader(text, require_timezone).document()


def _is_entry(text: str) -> bool:
    """A block sequence entry: ``-`` alone or followed by a space."""
    return text == "-" or text.startswith("- ")


def _yaml_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
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
        return sign * _sexagesimal([int(part) for part in value.split(":")])
    return sign * int(value)


def _yaml_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal([float(part) for part in value.split(":")])
    return sign * float(value)


def _sexagesimal(digits: list):
    total, base = 0, 1
    for digit in reversed(digits):
        total += digit * base
        base *= 60
    return total


def _timestamp(text: str):
    parts = _TIMESTAMP_PARTS.match(text).groupdict()
    year, month, day = int(parts["year"]), int(parts["month"]), int(parts["day"])
    if not parts["hour"]:
        return date(year, month, day)
    fraction = 0
    if parts["fraction"]:
        fraction = int(parts["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if parts["tz_sign"]:
        delta = timedelta(hours=int(parts["tz_hour"]), minutes=int(parts["tz_minute"] or 0))
        tzinfo = timezone(-delta if parts["tz_sign"] == "-" else delta)
    elif parts["tz"]:
        tzinfo = timezone.utc
    return datetime(
        year, month, day, int(parts["hour"]), int(parts["minute"]), int(parts["second"]),
        fraction, tzinfo=tzinfo,
    )


class _Reader:
    """One document's lines and the anchors seen so far. Block nodes are
    read line by line (a node starts at a column of a line); flow nodes
    character by character over the rest of the document."""

    def __init__(self, text: str, require_timezone: bool):
        self.lines = [line.rstrip() for line in text.lstrip("\ufeff").splitlines()]
        self.anchors: Dict[str, Any] = {}
        self.require_timezone = require_timezone

    def error(self, line: int, message: str) -> ValueError:
        return ValueError(f"YAML line {line + 1}: {message}")

    # -- lines --------------------------------------------------------------
    def _next(self, i: int) -> int:
        """The first line from ``i`` on that holds content (not blank,
        not only a comment)."""
        while i < len(self.lines):
            stripped = self.lines[i].strip()
            if stripped and not stripped.startswith("#"):
                return i
            i += 1
        return i

    def _indent(self, i: int) -> int:
        line = self.lines[i]
        indent = len(line) - len(line.lstrip(" "))
        if line[indent] == "\t":
            raise self.error(i, "tabs are not allowed in indentation")
        return indent

    def document(self) -> Any:
        starts = [i for i, line in enumerate(self.lines) if line[:1] == "%"
                  or line in ("---", "...") or line.startswith(("--- ", "... "))]
        i = self._next(0)
        if starts and starts[0] == i and self.lines[i].startswith("---"):
            if self.lines[i][3:].strip() and not self.lines[i][3:].strip().startswith("#"):
                raise self.error(i, "content on the '---' line is not supported")
            starts.pop(0)
            i = self._next(i + 1)
        if starts:
            raise self.error(
                starts[0], "directives, '...' and more than one document are not supported"
            )
        if i == len(self.lines):
            return None
        value, i = self._block(i, self._indent(i), parent=-1)
        i = self._next(i)
        if i < len(self.lines):
            raise self.error(i, "content outside the document's top-level node")
        return value

    # -- block nodes ----------------------------------------------------------
    def _block(self, i: int, col: int, parent: int) -> Tuple[Any, int]:
        """The node whose text starts at column ``col`` of line ``i``, in a
        block whose parent collection is indented ``parent``."""
        text = self.lines[i][col:]
        if _is_entry(text):
            return self._sequence(i, col)
        if self._key(text, i) is not None:
            return self._mapping(i, col)
        return self._value(i, col, parent, same_indent_sequence=False)

    def _mapping(self, i: int, col: int) -> Tuple[dict, int]:
        result: dict = {}
        while True:
            found = self._key(self.lines[i][col:], i)
            if found is None:
                raise self.error(i, "expected 'key: value' at this indentation")
            key, offset = found
            value, i = self._value(i, col + offset, col, same_indent_sequence=True)
            try:
                result[key] = value
            except TypeError:
                raise self.error(i - 1, f"unhashable key {key!r}") from None
            i = self._next(i)
            if i == len(self.lines) or self._indent(i) < col:
                return result, i
            if self._indent(i) > col:
                raise self.error(i, "bad indentation of a mapping entry")

    def _sequence(self, i: int, col: int) -> Tuple[list, int]:
        result: list = []
        while True:
            line = self.lines[i]
            rest = line[col + 1 :].lstrip(" ")
            start = len(line) - len(rest)
            if rest and not rest.startswith("#") and (
                _is_entry(rest) or self._key(rest, i) is not None
            ):
                # a collection that opens on the entry's own line
                value, i = self._block(i, start, parent=col)
            else:
                value, i = self._value(i, col + 1, col, same_indent_sequence=False)
            result.append(value)
            i = self._next(i)
            if i == len(self.lines) or self._indent(i) < col:
                return result, i
            if self._indent(i) > col:
                raise self.error(i, "bad indentation of a sequence entry")
            if not _is_entry(self.lines[i][col:]):
                return result, i

    def _key(self, text: str, i: int) -> Optional[Tuple[Any, int]]:
        """(key, offset just past its ':') when ``text`` opens a block
        mapping entry, else None."""
        if not text or text[0] in "[{&*!|>%@`#" or _is_entry(text):
            return None
        if text[0] == "?" and text[1:2] in ("", " "):
            raise self.error(i, "complex mapping keys ('?') are not supported")
        if text[0] in "'\"":
            try:
                key, end = self._quoted(text, 0, i)
            except ValueError:  # not closed on this line: a value, not a key
                return None
            rest = text[end:].lstrip(" ")
            if rest[:1] == ":" and rest[1:2] in ("", " "):
                return key, len(text) - len(rest) + 1
            return None
        for k, ch in enumerate(text):
            if ch == "#" and text[k - 1] in " \t":
                return None
            if ch == ":" and text[k + 1 : k + 2] in ("", " "):
                key = text[:k].rstrip(" ")
                if key == "<<":
                    raise self.error(i, "merge keys ('<<') are not supported")
                return self._resolve(key, i), k + 1
        return None

    def _value(
        self, i: int, col: int, parent: int, same_indent_sequence: bool
    ) -> Tuple[Any, int]:
        """The node after a key's ':' or an entry's '-' (text from column
        ``col`` of line ``i``), on that line or on the lines below."""
        line = self.lines[i]
        text = line[col:].lstrip(" ")
        col = len(line) - len(text)
        anchor = None
        if text.startswith("&"):
            anchor, text, col = self._anchor(line, col, i)
        if not text or text.startswith("#"):
            j = self._next(i + 1)
            if j < len(self.lines) and self._indent(j) > parent:
                value, j = self._block(j, self._indent(j), parent)
            elif (
                same_indent_sequence
                and j < len(self.lines)
                and self._indent(j) == parent
                and _is_entry(self.lines[j][parent:])
            ):
                value, j = self._sequence(j, parent)
            else:
                value, j = None, i + 1
        else:
            if self._key(text, i) is not None:
                raise self.error(i, "a mapping may not start on this line")
            value, j = self._inline(i, col, parent)
        if anchor is not None:
            self.anchors[anchor] = value
        return value, j

    def _anchor(self, line: str, col: int, i: int) -> Tuple[str, str, int]:
        end = col + 1
        while end < len(line) and line[end] not in _NAME_END:
            end += 1
        name = line[col + 1 : end]
        if not name:
            raise self.error(i, "an anchor needs a name")
        text = line[end:].lstrip(" ")
        return name, text, len(line) - len(text)

    def _alias(self, name: str, i: int) -> Any:
        if name not in self.anchors:
            raise self.error(i, f"unknown alias *{name}")
        return self.anchors[name]

    def _inline(self, i: int, col: int, parent: int) -> Tuple[Any, int]:
        """A node that starts on line ``i`` at ``col`` after a key or an
        entry: a flow collection, a quoted or plain scalar, or an alias."""
        text = self.lines[i][col:]
        first = text[0]
        if first in "[{":
            return self._flow(i, col)
        if first in "'\"":
            s = self._rest(i, col)
            value, end = self._quoted(s, 0, i, multiline=True)
            return value, self._end_of(s, end, i)
        if first == "*":
            name = text[1:].split()[0] if text[1:].strip() else ""
            self._expect_end(text[1 + len(name) :], i)
            return self._alias(name, i), i + 1
        self._refuse_indicator(text, i)
        return self._plain(i, col, parent)

    def _refuse_indicator(self, text: str, i: int) -> None:
        first = text[0]
        if first == "!":
            raise self.error(i, "tags ('!') are not supported")
        if first in "|>":
            raise self.error(i, "block scalars ('|', '>') are not supported")
        if first in "%@`":
            raise self.error(i, f"a plain scalar may not start with {first!r}")
        if first in "-?:" and text[1:2] in ("", " ", "\t", "\n", ",", "[", "]", "{", "}"):
            raise self.error(i, f"unexpected indicator {first!r}")

    def _plain(self, i: int, col: int, parent: int) -> Tuple[Any, int]:
        """A plain scalar from ``col`` of line ``i``, folded over the
        following lines indented deeper than ``parent`` (one space per
        line break, a newline per blank line)."""
        value, ended = self._plain_chunk(self.lines[i][col:], i)
        j, blanks = i + 1, 0
        while not ended and j < len(self.lines):
            stripped = self.lines[j].strip()
            if not stripped:
                blanks += 1
                j += 1
                continue
            if stripped.startswith("#") or self._indent(j) <= parent:
                break
            chunk, ended = self._plain_chunk(stripped, j)
            value += ("\n" * blanks if blanks else " ") + chunk
            j, blanks = j + 1, 0
        return self._resolve(value, i), j

    def _plain_chunk(self, text: str, i: int) -> Tuple[str, bool]:
        """(one line's part of a plain scalar, whether a comment ends it)."""
        for k, ch in enumerate(text):
            if ch == "#" and k and text[k - 1] in " \t":
                return text[:k].rstrip(), True
            if ch == ":" and text[k + 1 : k + 2] in ("", " ", "\t"):
                raise self.error(i, "mapping values are not allowed here")
        return text.rstrip(), False

    def _expect_end(self, rest: str, i: int) -> None:
        stripped = rest.lstrip(" \t")
        if stripped and not (stripped.startswith("#") and len(stripped) < len(rest)):
            raise self.error(i, f"unexpected text after a value: {stripped!r}")

    # -- scalars ---------------------------------------------------------------
    def _quoted(self, s: str, p: int, i: int, multiline: bool = False) -> Tuple[str, int]:
        """The quoted scalar opening at ``s[p]`` and the index past its
        end. With ``multiline`` it may run over line breaks, folded as
        PyYAML folds them: a break and the next line's indentation become
        one space, or a newline per blank line between."""
        quote, p, out = s[p], p + 1, []
        while True:
            if p >= len(s):
                raise self.error(i + s.count("\n"), "unterminated quoted scalar")
            ch = s[p]
            if ch == "\n":
                if not multiline:
                    raise self.error(i, "a quoted key must be on one line")
                while out and out[-1] in " \t":
                    out.pop()
                p, breaks = self._fold(s, p + 1)
                out.append("\n" * breaks if breaks else " ")
                continue
            if quote == "'":
                if ch == "'":
                    if s[p + 1 : p + 2] != "'":
                        return "".join(out), p + 1
                    p += 1
                out.append(ch)
                p += 1
                continue
            if ch == '"':
                return "".join(out), p + 1
            if ch != "\\":
                out.append(ch)
                p += 1
                continue
            code = s[p + 1 : p + 2]
            if code == "\n" and multiline:  # an escaped line break joins the lines
                p, breaks = self._fold(s, p + 2)
                out.append("\n" * breaks)
            elif code in _ESCAPES:
                out.append(_ESCAPES[code])
                p += 2
            elif code in _ESCAPE_CODES:
                digits = s[p + 2 : p + 2 + _ESCAPE_CODES[code]]
                if len(digits) != _ESCAPE_CODES[code] or not all(
                    c in "0123456789abcdefABCDEF" for c in digits
                ):
                    raise self.error(i, f"bad escape \\{code}{digits}")
                out.append(chr(int(digits, 16)))
                p += 2 + len(digits)
            else:
                raise self.error(i, f"unsupported escape \\{code or 'at end of line'}")

    @staticmethod
    def _fold(s: str, p: int) -> Tuple[int, int]:
        """Past the indentation after a line break at ``p - 1`` and any
        blank lines: (index of the next text, blank lines passed)."""
        breaks = 0
        while True:
            while p < len(s) and s[p] in " \t":
                p += 1
            if p < len(s) and s[p] == "\n":
                breaks, p = breaks + 1, p + 1
            else:
                return p, breaks

    def _resolve(self, text: str, i: int) -> Any:
        """A plain scalar's value, by PyYAML's YAML 1.1 resolvers."""
        first = text[:1]
        if first in "yYnNtTfFoO" and first and _BOOL_RE.match(text):
            return _BOOLS[text.lower()]
        if first in "-+0123456789." and first and _FLOAT_RE.match(text):
            return _yaml_float(text)
        if first in "-+0123456789" and first and _INT_RE.match(text):
            return _yaml_int(text)
        if text == "<<":
            raise self.error(i, "merge keys ('<<') are not supported")
        if _NULL_RE.match(text):
            return None
        if first in "0123456789" and first and _TIMESTAMP_RE.match(text):
            stamp = _timestamp(text)
            if self.require_timezone and getattr(stamp, "tzinfo", None) is None:
                raise ValueError(
                    f"Provide timezone to timestamp {text}. Example: for UTC timezone "
                    f"use {text + 'Z'} or {text + '+00:00'}"
                )
            return stamp
        if text == "=":
            raise self.error(i, "the value key '=' is not supported")
        return text

    # -- flow nodes ------------------------------------------------------------
    def _flow(self, i: int, col: int) -> Tuple[Any, int]:
        """A flow collection opening at ``col`` of line ``i``, read over as
        many lines as it spans; returns the line after its last."""
        s = self._rest(i, col)
        value, p = self._flow_node(s, 0, i)
        return value, self._end_of(s, p, i)

    def _rest(self, i: int, col: int) -> str:
        """The document from ``col`` of line ``i`` on, lines joined by
        newlines: the text a flow node or a quoted scalar may span."""
        return "\n".join([self.lines[i][col:], *self.lines[i + 1 :]])

    def _end_of(self, s: str, p: int, i: int) -> int:
        """The line after the one where a node of ``_rest(i, ...)`` ended
        at ``p``; nothing but a comment may follow it there."""
        line_end = s.find("\n", p)
        self._expect_end(s[p : len(s) if line_end < 0 else line_end], i + s.count("\n", 0, p))
        return i + s.count("\n", 0, p) + 1

    def _skip(self, s: str, p: int) -> int:
        """Past spaces, line breaks and comments."""
        while p < len(s):
            if s[p] in " \t\n":
                p += 1
            elif s[p] == "#" and (p == 0 or s[p - 1] in " \t\n"):
                end = s.find("\n", p)
                p = len(s) if end < 0 else end
            else:
                break
        return p

    def _peek(self, s: str, p: int, i: int) -> str:
        if p >= len(s):
            raise self.error(i + s.count("\n"), "unterminated flow collection")
        return s[p]

    def _flow_node(self, s: str, p: int, i: int) -> Tuple[Any, int]:
        p = self._skip(s, p)
        line = i + s.count("\n", 0, p)
        anchor = None
        if self._peek(s, p, i) == "&":
            end = p + 1
            while end < len(s) and s[end] not in _NAME_END:
                end += 1
            anchor, p = s[p + 1 : end], self._skip(s, end)
            if not anchor:
                raise self.error(line, "an anchor needs a name")
        ch = self._peek(s, p, i)
        if ch == "[":
            value, p = self._flow_sequence(s, p + 1, i)
        elif ch == "{":
            value, p = self._flow_mapping(s, p + 1, i)
        elif ch in "'\"":
            value, p = self._quoted(s, p, line, multiline=True)
        elif ch == "*":
            end = p + 1
            while end < len(s) and s[end] not in _NAME_END:
                end += 1
            value, p = self._alias(s[p + 1 : end], line), end
        elif ch in ",]}":
            raise self.error(line, f"empty flow entry before {ch!r}")
        else:
            self._refuse_indicator(s[p:], line)
            start = p
            while p < len(s) and s[p] not in ",[]{}\n":
                if s[p] == ":" and s[p + 1 : p + 2] in ("", " ", "\t", "\n", ",", "[", "]", "{", "}"):
                    break
                if s[p] == "#" and s[p - 1] in " \t":
                    break
                p += 1
            value = self._resolve(s[start:p].rstrip(" \t"), line)
        if anchor is not None:
            self.anchors[anchor] = value
        return value, p

    def _flow_value(self, s: str, p: int, i: int) -> Tuple[Any, int]:
        """The value after a flow key's ':' (None when it is left out)."""
        p = self._skip(s, p)
        if self._peek(s, p, i) in ",]}":
            return None, p
        return self._flow_node(s, p, i)

    def _flow_sequence(self, s: str, p: int, i: int) -> Tuple[list, int]:
        items: List[Any] = []
        while True:
            p = self._skip(s, p)
            if self._peek(s, p, i) == "]":
                return items, p + 1
            item, p = self._flow_node(s, p, i)
            p = self._skip(s, p)
            if self._peek(s, p, i) == ":":  # a single-pair mapping
                value, p = self._flow_value(s, p + 1, i)
                item = self._pair({}, item, value, s, p, i)
                p = self._skip(s, p)
            items.append(item)
            ch = self._peek(s, p, i)
            if ch == ",":
                p += 1
            elif ch != "]":
                raise self.error(i + s.count("\n", 0, p), f"expected ',' or ']', found {ch!r}")

    def _flow_mapping(self, s: str, p: int, i: int) -> Tuple[dict, int]:
        result: dict = {}
        while True:
            p = self._skip(s, p)
            if self._peek(s, p, i) == "}":
                return result, p + 1
            if s[p] == "?" and s[p + 1 : p + 2] in (" ", "\n"):
                raise self.error(i + s.count("\n", 0, p), "complex keys ('?') are not supported")
            key, p = self._flow_node(s, p, i)
            p = self._skip(s, p)
            value = None
            if self._peek(s, p, i) == ":":
                value, p = self._flow_value(s, p + 1, i)
                p = self._skip(s, p)
            self._pair(result, key, value, s, p, i)
            ch = self._peek(s, p, i)
            if ch == ",":
                p += 1
            elif ch != "}":
                raise self.error(i + s.count("\n", 0, p), f"expected ',' or '}}', found {ch!r}")

    def _pair(self, mapping: dict, key, value, s: str, p: int, i: int) -> dict:
        try:
            mapping[key] = value
        except TypeError:
            raise self.error(i + s.count("\n", 0, p), f"unhashable key {key!r}") from None
        return mapping
