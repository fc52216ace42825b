"""A YAML reader for the configs, without PyYAML (the card's machine has none).

``load(text)`` returns what ``yaml.safe_load(text)`` returns for the subset
of YAML that the configs and the tests' written YAMLs use:

  * block mappings nested to any depth, comments and blank lines;
  * block sequences (``- item``, also at the indent of their key);
  * plain, single-quoted and double-quoted scalars, also over several lines
    (folded as YAML folds them);
  * flow mappings and flow sequences (``{data: 2}``, ``[1, 2]``) on one line.

Plain scalars resolve by PyYAML's YAML 1.1 rules: ``yes``/``on``/``True``
are booleans, ``~``/``null``/an empty value are None, ints take ``0x``,
``0b``, a leading ``0`` (octal), underscores and ``a:b`` (base 60), and a
float needs a dot: ``1.0e-5`` is a float but ``1e-5`` is a string.

As in PyYAML, one leading byte-order mark (U+FEFF) is dropped, a tab
outside a quoted scalar or a comment raises, a ``- `` entry cannot be the
value of a key on its line, and a document-end marker ``...`` may close the
document (only blank lines, comments and further ``...`` may follow it).

Anchors, aliases, tags, block scalars (``|``, ``>``), complex keys,
directives, several documents, a mapping inside a sequence, dates and a
key given twice raise ``ValueError`` naming the line: nothing that this
reader does not support is read silently.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (resolver.py), in its order: bool, float, int,
# merge, null, timestamp, value. A plain scalar takes the first that matches.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

# What a plain scalar may not start with, and why.
_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags",
                      "|": "block scalars", ">": "block scalars",
                      "%": "directives", "@": "reserved indicators",
                      "`": "reserved indicators"}

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Error(ValueError):
    pass


class _Unterminated(_Error):
    pass


def _sexagesimal(value: str, base_type):
    digits = [base_type(part) for part in value.split(":")]
    out, scale = 0, 1
    for d in reversed(digits):
        out += d * scale
        scale *= 60
    return out


def _int(value: str) -> int:
    value = value.replace("_", "")
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
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str, lineno: int) -> Any:
    """A plain scalar's value, by PyYAML's implicit resolvers."""
    first = text[:1]
    if first and first in "yYnNtTfFoO" and _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if first and first in "-+0123456789." and _FLOAT.match(text):
        return _float(text)
    if first and first in "-+0123456789" and _INT.match(text):
        return _int(text)
    if text == "<<":
        raise _Error(f"line {lineno}: merge keys ('<<') are not supported")
    if _NULL.match(text):
        return None
    if first and first in "0123456789" and _TIMESTAMP.match(text):
        raise _Error(f"line {lineno}: dates and timestamps ({text!r}) are not supported")
    if text == "=":
        raise _Error(f"line {lineno}: the value key ('=') is not supported")
    return text


def _check_start(text: str, lineno: int) -> None:
    """Raise on a node that starts with an indicator this reader lacks."""
    first = text[:1]
    if first in _UNSUPPORTED_START:
        raise _Error(f"line {lineno}: {_UNSUPPORTED_START[first]} ('{first}') "
                     "are not supported")
    if first == "?" and (len(text) == 1 or text[1] in " \t"):
        raise _Error(f"line {lineno}: complex keys ('?') are not supported")


def _fold(pieces: List[str]) -> str:
    """Join the lines of a multi-line scalar as YAML folds them: one line
    break becomes a space, each further (empty) line a newline."""
    out, breaks = pieces[0], 0
    for piece in pieces[1:]:
        if piece == "":
            breaks += 1
            continue
        out += "\n" * breaks if breaks else " "
        out += piece
        breaks = 0
    return out


def _quoted(text: str, pos: int, lineno: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[pos] (its quote), which may span
    lines joined by '\\n'; returns (value, index after the closing quote)."""
    quote = text[pos]
    i, out = pos + 1, []
    n = len(text)
    while True:
        if i >= n:
            raise _Unterminated(f"line {lineno}: unterminated {quote}-quoted scalar")
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and ch == '"':
            return "".join(out), i + 1
        if quote == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc == "":
                raise _Unterminated(f"line {lineno}: unterminated \"-quoted scalar")
            if esc == "\n":  # an escaped line break: no space, next line's indent dropped
                i += 2
                while i < n and text[i] in " \t":
                    i += 1
                continue
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_ESCAPES:
                width = _HEX_ESCAPES[esc]
                digits = text[i + 2:i + 2 + width]
                if len(digits) != width or not all(c in "0123456789abcdefABCDEF"
                                                   for c in digits):
                    raise _Error(f"line {lineno}: bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + width
                continue
            raise _Error(f"line {lineno}: unknown escape \\{esc}")
        if ch in " \t\n":
            j = i
            while j < n and text[j] in " \t":
                j += 1
            if j < n and text[j] == "\n":  # a line break: fold it
                breaks = 0
                while j < n and text[j] == "\n":
                    breaks += 1
                    j += 1
                    while j < n and text[j] in " \t":
                        j += 1
                out.append("\n" * (breaks - 1) if breaks > 1 else " ")
                i = j
                continue
            out.append(text[i:j])
            i = j
            continue
        out.append(ch)
        i += 1


def _rest_is_blank(text: str, pos: int, lineno: int) -> None:
    rest = text[pos:]
    stripped = rest.lstrip(" \t")
    if stripped and not (stripped.startswith("#") and len(stripped) < len(rest)):
        raise _Error(f"line {lineno}: unexpected text after a value: {stripped!r}")


# -- flow collections -------------------------------------------------------------


def _skip_to_next(text: str, pos: int, lineno: int) -> int:
    """_skip_space inside a flow collection, whose end must come."""
    pos = _skip_space(text, pos)
    if pos >= len(text):
        raise _Unterminated(f"line {lineno}: an unterminated flow collection")
    return pos


def _skip_space(text: str, pos: int) -> int:
    """Past spaces, line breaks and comments (a flow collection may span
    lines: its text is the lines joined by '\\n')."""
    while pos < len(text):
        if text[pos] in " \t\n":
            pos += 1
        elif text[pos] == "#" and (pos == 0 or text[pos - 1] in " \t\n"):
            while pos < len(text) and text[pos] != "\n":
                pos += 1
        else:
            break
    return pos


def _flow_plain_end(text: str, pos: int) -> int:
    i = pos
    while i < len(text):
        ch = text[i]
        if ch in ",[]{}":
            break
        if ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t\n,[]{}"):
            break
        if ch == "#" and i > pos and text[i - 1] in " \t\n":
            break
        i += 1
    return i


def _flow_node(text: str, pos: int, lineno: int) -> Tuple[Any, int]:
    pos = _skip_space(text, pos)
    if pos >= len(text):
        raise _Unterminated(f"line {lineno}: an unterminated flow collection")
    ch = text[pos]
    if ch == "[":
        return _flow_sequence(text, pos, lineno)
    if ch == "{":
        return _flow_mapping(text, pos, lineno)
    if ch in "'\"":
        return _quoted(text, pos, lineno)
    _check_start(text[pos:], lineno)
    end = _flow_plain_end(text, pos)
    lines = [line.strip(" \t") for line in text[pos:end].split("\n")]
    while lines and lines[-1] == "":
        lines.pop()
    if not lines:
        raise _Error(f"line {lineno}: an empty entry in a flow collection")
    if len(lines) > 1:  # a plain scalar over several lines is a string
        return _fold(lines), end
    return resolve_plain(lines[0], lineno), end


def _flow_sequence(text: str, pos: int, lineno: int) -> Tuple[list, int]:
    out, pos = [], pos + 1
    while True:
        pos = _skip_to_next(text, pos, lineno)
        if text[pos:pos + 1] == "]":
            return out, pos + 1
        value, pos = _flow_node(text, pos, lineno)
        pos = _skip_to_next(text, pos, lineno)
        if text[pos:pos + 1] == ":":
            raise _Error(f"line {lineno}: a mapping inside a flow sequence is not supported")
        out.append(value)
        if text[pos:pos + 1] == ",":
            pos += 1
        elif text[pos:pos + 1] != "]":
            raise _Error(f"line {lineno}: expected ',' or ']' in a flow sequence")


def _flow_mapping(text: str, pos: int, lineno: int) -> Tuple[dict, int]:
    out, pos = {}, pos + 1
    while True:
        pos = _skip_to_next(text, pos, lineno)
        if text[pos:pos + 1] == "}":
            return out, pos + 1
        key, pos = _flow_node(text, pos, lineno)
        pos = _skip_to_next(text, pos, lineno)
        value = None
        if text[pos:pos + 1] == ":":
            pos = _skip_to_next(text, pos + 1, lineno)
            if text[pos:pos + 1] not in (",", "}"):
                value, pos = _flow_node(text, pos, lineno)
                pos = _skip_to_next(text, pos, lineno)
        _put(out, key, value, lineno)
        if text[pos:pos + 1] == ",":
            pos += 1
        elif text[pos:pos + 1] != "}":
            raise _Error(f"line {lineno}: expected ',' or '}}' in a flow mapping")


def _put(mapping: dict, key: Any, value: Any, lineno: int) -> None:
    if isinstance(key, (dict, list)):
        raise _Error(f"line {lineno}: collection keys are not supported")
    if key in mapping:
        raise _Error(f"line {lineno}: duplicate key {key!r}")
    mapping[key] = value


# -- block structure --------------------------------------------------------------


def _check_tabs(lines: List[str]) -> None:
    """Raise on a tab outside a quoted scalar and a comment, where PyYAML's
    scanner finds "a character that cannot start any token". A quote opens
    a quoted scalar where a node may start: at the start of a line, after
    '[', '{' or ',', or after ':', '-' or '?' and a space."""
    quote = None
    for lineno, line in enumerate(lines, 1):
        prev, spaced, i = None, False, 0
        while i < len(line):
            ch = line[i]
            if quote is not None:
                if ch == "\\" and quote == '"':
                    i += 2
                    continue
                if ch == quote:
                    if quote == "'" and line[i + 1:i + 2] == "'":
                        i += 2
                        continue
                    quote, prev, spaced = None, ch, False
                i += 1
                continue
            if ch == "\t":
                raise _Error(f"line {lineno}: tabs outside quoted scalars and comments "
                             "are not supported (PyYAML rejects them)")
            if ch == "#" and (i == 0 or line[i - 1] == " "):
                break
            if ch == " ":
                spaced = True
            else:
                if ch in "'\"" and (prev is None or prev in "[{," or
                                    (prev in ":-?" and spaced)):
                    quote = ch
                prev, spaced = ch, False
            i += 1


def _is_end_marker(raw: str) -> bool:
    return raw.rstrip("\r")[:3] == "..." and raw.rstrip("\r")[3:4] in ("", " ")


class _Reader:
    def __init__(self, text: str):
        self.raw = text.split("\n")
        _check_tabs(self.raw)
        self.i = 0

    # Lines are (line number from 1, indent, content without the indent).
    def line(self, i: int) -> Tuple[int, int, str]:
        raw = self.raw[i].rstrip("\r")
        content = raw.lstrip(" ")
        return i + 1, len(raw) - len(content), content.rstrip(" \t")

    def is_blank(self, i: int) -> bool:
        content = self.raw[i].strip()
        return content == "" or content.startswith("#")

    def next_content(self, i: int) -> Optional[int]:
        while i < len(self.raw) and self.is_blank(i):
            i += 1
        return i if i < len(self.raw) else None

    def document(self) -> Any:
        self.close_at_end_marker()
        i = self.next_content(0)
        started = False
        if i is not None:
            lineno, indent, content = self.line(i)
            if content.startswith("%"):
                raise _Error(f"line {lineno}: directives are not supported")
            if content == "---" and indent == 0:
                i, started = self.next_content(i + 1), True
        if i is None:
            if self.end_line is not None and not started:
                raise _Error(f"line {self.end_line}: a document end marker ('...') "
                             "with no document before it")
            return None
        value, i = self.node(i, -1)
        i = self.next_content(i)
        if i is not None:
            lineno, indent, content = self.line(i)
            _check_marker(lineno, indent, content)
            raise _Error(f"line {lineno}: unexpected content {content!r}")
        return value

    def close_at_end_marker(self) -> None:
        """Cut the lines at the first document end marker '...', after
        which only blank lines, comments and more markers may come."""
        self.end_line = None
        for k, raw in enumerate(self.raw):
            if _is_end_marker(raw):
                self.end_line = k + 1
                break
        if self.end_line is None:
            return
        for k in range(self.end_line, len(self.raw)):
            if self.is_blank(k) or _is_end_marker(self.raw[k]):
                continue
            raise _Error(f"line {k + 1}: several documents (content after the "
                         "document end marker '...') are not supported")
        self.raw = self.raw[:self.end_line - 1]

    def node(self, i: int, parent_indent: int) -> Tuple[Any, int]:
        """The block node whose first line is line i (a content line)."""
        lineno, indent, content = self.line(i)
        _check_marker(lineno, indent, content)
        if _is_seq_entry(content):
            return self.sequence(i, indent)
        if _key_end(content, lineno) is not None:
            return self.mapping(i, indent)
        return self.inline(i, content, parent_indent)

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while True:
            lineno, ind, content = self.line(i)
            _check_marker(lineno, ind, content)
            if ind != indent:
                raise _Error(f"line {lineno}: bad indentation of a mapping entry")
            if _is_seq_entry(content):
                raise _Error(f"line {lineno}: a sequence entry inside a mapping")
            split = _key_end(content, lineno)
            if split is None:
                _check_start(content, lineno)
                raise _Error(f"line {lineno}: expected 'key: value', got {content!r}")
            key, rest = split
            rest = rest.lstrip(" \t")
            if rest == "" or rest.startswith("#"):
                j = self.next_content(i + 1)
                if j is not None and self.line(j)[1] > indent:
                    value, i = self.node(j, indent)
                elif j is not None and self.line(j)[1] == indent and \
                        _is_seq_entry(self.line(j)[2]):
                    value, i = self.sequence(j, indent)  # a sequence at its key's indent
                else:
                    value, i = None, i + 1
            else:
                if _is_seq_entry(rest):
                    raise _Error(f"line {lineno}: sequence entries are not allowed here "
                                 "(a '- ' entry as the value on its key's line)")
                value, i = self.inline(i, rest, indent)
            _put(out, key, value, lineno)
            j = self.next_content(i)
            if j is None:
                return out, len(self.raw)
            _, ind, content = self.line(j)
            if ind < indent or (ind == indent and _is_seq_entry(content)):
                return out, j
            if ind > indent:
                raise _Error(f"line {j + 1}: bad indentation (more than its mapping's)")
            i = j

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while True:
            lineno, ind, content = self.line(i)
            rest = content[1:].lstrip(" \t")
            if rest == "" or rest.startswith("#"):
                j = self.next_content(i + 1)
                if j is not None and self.line(j)[1] > indent:
                    value, i = self.node(j, indent)
                    if isinstance(value, (dict, list)):
                        raise _Error(f"line {lineno}: a collection inside a block "
                                     "sequence is not supported")
                else:
                    value, i = None, i + 1
            else:
                if _is_seq_entry(rest):
                    raise _Error(f"line {lineno}: a sequence inside a block sequence "
                                 "is not supported")
                if not rest.startswith(("'", '"', "[", "{")) and \
                        _key_end(rest, lineno) is not None:
                    raise _Error(f"line {lineno}: a mapping inside a block sequence "
                                 "is not supported")
                value, i = self.inline(i, rest, indent)
            out.append(value)
            j = self.next_content(i)
            if j is None:
                return out, len(self.raw)
            _, ind, content = self.line(j)
            if ind < indent or (ind == indent and not _is_seq_entry(content)):
                return out, j
            if ind > indent:
                raise _Error(f"line {j + 1}: bad indentation (more than its sequence's)")
            i = j

    def inline(self, i: int, rest: str, indent: int) -> Tuple[Any, int]:
        """The value that starts on line i after its key or dash (`rest`),
        with the lines indented deeper than `indent` that continue it."""
        if rest[0] in "[{'\"":
            return self.spanning(i, rest, indent)
        return self.scalar(i, rest, indent)

    def spanning(self, i: int, rest: str, indent: int) -> Tuple[Any, int]:
        """A quoted scalar or a flow collection that starts on line i and
        may go on over the lines indented deeper than `indent`."""
        lineno = i + 1
        parse = _quoted if rest[0] in "'\"" else _flow_node
        text, last = rest, i
        while True:
            try:
                value, end = parse(text, 0, lineno)
                break
            except _Unterminated:
                last += 1
                if last >= len(self.raw):
                    raise
                text += "\n" + self.raw[last].rstrip("\r")
        _rest_is_blank(text, end, last + 1)
        if last > i:
            for k in range(i + 1, last + 1):
                if self.raw[k].strip() and self.line(k)[1] <= indent:
                    raise _Error(f"line {k + 1}: a continued value is not indented "
                                 "past its key")
        j = self.next_content(last + 1)
        if j is not None and self.line(j)[1] > indent:
            raise _Error(f"line {j + 1}: unexpected indented content after a value")
        return value, last + 1

    def scalar(self, i: int, first: str, indent: int) -> Tuple[Any, int]:
        """A plain scalar starting with `first` on line i, continued by the
        following lines indented deeper than `indent`."""
        lineno = i + 1
        _check_start(first, lineno)
        if _key_end_plain(first) is not None:
            raise _Error(f"line {lineno}: a mapping value is not allowed here")
        pieces = [_strip_comment(first)]
        j, commented = i + 1, pieces[0] != first.rstrip(" \t")
        end = j
        while j < len(self.raw):
            content = self.raw[j].strip()
            if content == "":
                pieces.append("")
                j += 1
                continue
            _, ind, text = self.line(j)
            if ind <= indent or content.startswith("#"):
                break
            if commented:
                raise _Error(f"line {j + 1}: a plain scalar continues after a comment")
            if _key_end(text, j + 1) is not None or _is_seq_entry(text):
                raise _Error(f"line {j + 1}: bad indentation (a mapping or sequence "
                             "entry inside a scalar)")
            piece = _strip_comment(text)
            commented = piece != text
            pieces.append(piece)
            j += 1
            end = j
        while pieces and pieces[-1] == "":
            pieces.pop()
        value = _fold(pieces) if pieces else ""
        if len(pieces) > 1:  # a multi-line plain scalar is always a string
            return value, end
        return resolve_plain(value, lineno), end


def _check_marker(lineno: int, indent: int, content: str) -> None:
    if indent == 0 and content[:3] in ("---", "...") and content[3:4] in ("", " ", "\t"):
        raise _Error(f"line {lineno}: several documents (or a document marker) "
                     "are not supported")


def _strip_comment(text: str) -> str:
    """A plain scalar's text up to a ' #' comment, trailing spaces dropped."""
    for k in range(1, len(text)):
        if text[k] == "#" and text[k - 1] in " \t":
            return text[:k].rstrip(" \t")
    return text.rstrip(" \t")


def _is_seq_entry(content: str) -> bool:
    return content == "-" or content.startswith(("- ", "-\t"))


def _key_end(content: str, lineno: int) -> Optional[Tuple[Any, str]]:
    """(key, the text after its ':') if `content` is a block mapping entry,
    else None."""
    if content[:1] in ("'", '"'):
        try:
            key, end = _quoted(content, 0, lineno)
        except _Error:
            return None
        rest = content[end:].lstrip(" \t")
        if rest[:1] == ":" and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:]
        return None
    if content[:1] in "[{":
        try:
            _, end = _flow_node(content, 0, lineno)
        except _Unterminated:  # a flow value that goes on over the next lines
            return None
        rest = content[end:].lstrip(" \t")
        if rest[:1] == ":" and (len(rest) == 1 or rest[1] in " \t"):
            raise _Error(f"line {lineno}: flow collections as keys are not supported")
        return None
    k = _key_end_plain(content)
    if k is None:
        return None
    raw = content[:k].rstrip(" \t")
    _check_start(raw, lineno)
    return resolve_plain(raw, lineno), content[k + 1:]


def _key_end_plain(content: str) -> Optional[int]:
    for k, ch in enumerate(content):
        if ch == "#" and (k == 0 or content[k - 1] in " \t"):
            return None
        if ch == ":" and (k + 1 == len(content) or content[k + 1] in " \t"):
            return k
    return None


def load(text: str, source: str = "<yaml>") -> Any:
    """The value of the YAML document `text`, as ``yaml.safe_load`` gives it.
    Raises ValueError("<source>: line N: ...") on what the reader does not
    support. One leading byte-order mark is dropped, as PyYAML drops it."""
    if text.startswith("\ufeff"):
        text = text[1:]
    try:
        return _Reader(text).document()
    except _Error as e:
        raise ValueError(f"{source}: {e}") from None


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read(), path)
