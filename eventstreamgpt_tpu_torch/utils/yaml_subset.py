"""A reader and a writer for the subset of YAML that the repo's configs use.

Counterpart: PyYAML's ``yaml.safe_load`` and ``yaml.safe_dump``, which the
JAX package's config tool and scripts call. The port runs where PyYAML is
not installed, so it reads its configs with this module.

`load` reads block mappings and sequences (the indentless ``key:\\n- a``
too), flow collections, plain, single- and double-quoted scalars (folded
across lines as PyYAML folds them), ``? key`` for a scalar key (as
``yaml.safe_dump`` writes an empty or long one), ``#`` comments and a
trailing ``...``,
and gives what ``yaml.safe_load`` gives: scalars resolve by PyYAML's YAML
1.1 implicit resolvers (its regular expressions, copied below), so
``1.0e-2`` is a float but ``1e-3`` a string, ``yes`` a boolean, ``12:30``
the integer 750 and ``2025-01-14`` a `datetime.date`. Input that PyYAML
refuses raises `YAMLError`; YAML outside the subset (anchors, aliases, tags,
block scalars, ``---`` documents, complex (collection) keys, ``<<`` merge
keys) raises `UnsupportedYAML`, naming the construct and the line. Both are
``ValueError``s.

`dump` writes block style with sorted keys, as ``yaml.safe_dump`` does, in a
form that this reader and PyYAML read back to the same value: floats as
PyYAML writes them (``1.0e-05``, never JSON's ``1e-05``, which YAML 1.1
reads as a string), strings quoted wherever a plain scalar would resolve to
something else or parse otherwise (``'yes'``, ``'1e-3'``, ``'x: y'``).
"""

from __future__ import annotations

import datetime
import re
from pathlib import Path
from typing import Any

__all__ = ["UnsupportedYAML", "YAMLError", "dump", "dump_file", "load", "load_file"]


class YAMLError(ValueError):
    """Text that is not YAML: PyYAML raises a ``yaml.YAMLError`` on it too."""


class UnsupportedYAML(ValueError):
    """YAML outside the subset this module reads."""


# ------------------------------------------------------------------ scanning
_BREAKS = "\r\n\x85\u2028\u2029"
_WS_END = "\0 \t" + _BREAKS
_NON_PRINTABLE = re.compile("[^\x09\x0a\x0d\x20-\x7e\x85\xa0-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]")

(STREAM_END, DOC_END, SCALAR, KEY, VALUE, ENTRY, FLOW_ENTRY, BLOCK_SEQ, BLOCK_MAP, BLOCK_END, FLOW_SEQ, FLOW_MAP,
 FLOW_SEQ_END, FLOW_MAP_END) = range(14)  # fmt: skip
_NAMES = ("<stream end>", "<document end>", "<scalar>", "<key>", "':'", "'-'", "','", "<block sequence start>",
          "<block mapping start>", "<block end>", "'['", "'{'", "']'", "'}'")  # fmt: skip


class _Token:
    __slots__ = ("kind", "line", "value", "plain")

    def __init__(self, kind: int, line: int, value: str = "", plain: bool = False):
        self.kind, self.line, self.value, self.plain = kind, line, value, plain


class _SimpleKey:
    __slots__ = ("token", "required", "index", "line", "column")

    def __init__(self, token, required, index, line, column):
        self.token, self.required, self.index, self.line, self.column = token, required, index, line, column


class _Scanner:
    """PyYAML's scanner, cut to the subset: the same indentation stack, the
    same simple-key bookkeeping and the same scalar folding, fetched lazily
    as the parser asks (so an error surfaces where PyYAML's does)."""

    def __init__(self, text: str):
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise YAMLError(f"special character {bad.group()!r} is not allowed (offset {bad.start()})")
        self.s = text + "\0"
        self.i = self.line = self.col = 0
        self.tokens: list[_Token] = []
        self.taken = 0
        self.done = False
        self.flow = 0
        self.indent, self.indents = -1, []
        self.allow_key = True
        self.keys: dict[int, _SimpleKey] = {}

    # --- the reader
    def peek(self, k: int = 0) -> str:
        return self.s[self.i + k] if self.i + k < len(self.s) else "\0"

    def prefix(self, n: int) -> str:
        return self.s[self.i : self.i + n]

    def forward(self, n: int = 1) -> None:
        for _ in range(n):
            ch = self.s[self.i]
            self.i += 1
            if ch in "\n\x85\u2028\u2029" or (ch == "\r" and self.s[self.i] != "\n"):
                self.line += 1
                self.col = 0
            elif ch != "\ufeff":
                self.col += 1

    def fail(self, msg: str, cls=YAMLError):
        raise cls(f"{msg} (line {self.line + 1}, column {self.col + 1})")

    def unsupported(self, what: str):
        self.fail(f"{what} are not part of the YAML subset this reader reads", UnsupportedYAML)

    # --- the parser's side
    def peek_token(self) -> _Token:
        while self._need_more():
            self._fetch()
        return self.tokens[0]

    def get_token(self) -> _Token:
        token = self.peek_token()
        self.tokens.pop(0)
        self.taken += 1
        return token

    def _need_more(self) -> bool:
        if self.done:
            return False
        if not self.tokens:
            return True
        self._stale_keys()
        return bool(self.keys) and min(k.token for k in self.keys.values()) == self.taken

    def _append(self, kind: int, **kw) -> None:
        self.tokens.append(_Token(kind, self.line, **kw))

    # --- fetching
    def _fetch(self) -> None:
        self._skip_to_token()
        self._stale_keys()
        self._unwind(self.col)
        ch = self.peek()
        if ch == "\0":
            self._unwind(-1)
            self._remove_key()
            self.allow_key = False
            self.keys = {}
            self._append(STREAM_END)
            self.done = True
        elif ch == "%" and self.col == 0:
            self.fail("while scanning a directive: directives are not read here")
        elif ch == "-" and self._document_marker("---"):
            self.unsupported("document markers ('---', several documents)")
        elif ch == "." and self._document_marker("..."):
            self._unwind(-1)
            self._remove_key()
            self.allow_key = False
            self.forward(3)
            self._append(DOC_END)
        elif ch in "[{":
            self._save_key()
            self.flow += 1
            self.allow_key = True
            self.forward()
            self._append(FLOW_SEQ if ch == "[" else FLOW_MAP)
        elif ch in "]}":
            self._remove_key()
            self.flow -= 1
            self.allow_key = False
            self.forward()
            self._append(FLOW_SEQ_END if ch == "]" else FLOW_MAP_END)
        elif ch == ",":
            self.allow_key = True
            self._remove_key()
            self.forward()
            self._append(FLOW_ENTRY)
        elif ch == "-" and self.peek(1) in _WS_END:
            self._block_entry()
        elif ch == "?" and (self.flow or self.peek(1) in _WS_END):
            self._explicit_key()
        elif ch == ":" and (self.flow or self.peek(1) in _WS_END):
            self._value()
        elif ch == "*":
            self.unsupported("aliases ('*')")
        elif ch == "&":
            self.unsupported("anchors ('&')")
        elif ch == "!":
            self.unsupported("tags ('!')")
        elif ch in "|>" and not self.flow:
            self.unsupported("block scalars ('|', '>')")
        elif ch in "'\"":
            self._save_key()
            self.allow_key = False
            self._quoted(ch == '"')
        elif self._plain_start(ch):
            self._save_key()
            self.allow_key = False
            self._plain()
        else:
            self.fail(f"found character {ch!r} that cannot start any token")

    def _document_marker(self, marker: str) -> bool:
        return self.col == 0 and self.prefix(3) == marker and self.peek(3) in _WS_END

    def _plain_start(self, ch: str) -> bool:
        return ch not in _WS_END + "-?:,[]{}#&*!|>'\"%@`" or (
            self.peek(1) not in _WS_END and (ch == "-" or (not self.flow and ch in "?:"))
        )

    def _skip_to_token(self) -> None:
        if self.i == 0 and self.peek() == "\ufeff":
            self.forward()
        while True:
            while self.peek() == " ":
                self.forward()
            if self.peek() == "#":
                while self.peek() not in "\0" + _BREAKS:
                    self.forward()
            if self._line_break():
                if not self.flow:
                    self.allow_key = True
            else:
                return

    def _line_break(self) -> str:
        ch = self.peek()
        if ch in "\r\n\x85":
            self.forward(2 if self.prefix(2) == "\r\n" else 1)
            return "\n"
        if ch in "\u2028\u2029":
            self.forward()
            return ch
        return ""

    # --- indentation and simple keys
    def _unwind(self, column: int) -> None:
        if self.flow:
            return
        while self.indent > column:
            self.indent = self.indents.pop()
            self._append(BLOCK_END)

    def _add_indent(self, column: int) -> bool:
        if self.indent < column:
            self.indents.append(self.indent)
            self.indent = column
            return True
        return False

    def _stale_keys(self) -> None:
        for level, key in list(self.keys.items()):
            if key.line != self.line or self.i - key.index > 1024:
                if key.required:
                    self.fail("while scanning a simple key: could not find expected ':'")
                del self.keys[level]

    def _save_key(self) -> None:
        required = not self.flow and self.indent == self.col
        if self.allow_key:
            self._remove_key()
            self.keys[self.flow] = _SimpleKey(self.taken + len(self.tokens), required, self.i, self.line, self.col)

    def _remove_key(self) -> None:
        key = self.keys.pop(self.flow, None)
        if key is not None and key.required:
            self.fail("while scanning a simple key: could not find expected ':'")

    def _block_entry(self) -> None:
        if not self.flow:
            if not self.allow_key:
                self.fail("sequence entries are not allowed here")
            if self._add_indent(self.col):
                self._append(BLOCK_SEQ)
        self.allow_key = True
        self._remove_key()
        self.forward()
        self._append(ENTRY)

    def _explicit_key(self) -> None:
        if not self.flow:
            if not self.allow_key:
                self.fail("mapping keys are not allowed here")
            if self._add_indent(self.col):
                self._append(BLOCK_MAP)
        self.allow_key = not self.flow
        self._remove_key()
        self.forward()
        self._append(KEY)

    def _value(self) -> None:
        key = self.keys.pop(self.flow, None)
        if key is not None:
            at = key.token - self.taken
            self.tokens.insert(at, _Token(KEY, key.line))
            if not self.flow and self._add_indent(key.column):
                self.tokens.insert(at, _Token(BLOCK_MAP, key.line))
            self.allow_key = False
        else:
            if not self.flow:
                if not self.allow_key:
                    self.fail("mapping values are not allowed here")
                if self._add_indent(self.col):
                    self._append(BLOCK_MAP)
            self.allow_key = not self.flow
        self.forward()
        self._append(VALUE)

    # --- scalars
    _ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
                "r": "\r", "e": "\x1b", " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0",
                "L": "\u2028", "P": "\u2029"}  # fmt: skip
    _CODES = {"x": 2, "u": 4, "U": 8}

    def _quoted(self, double: bool) -> None:
        line = self.line
        quote = self.peek()
        self.forward()
        chunks = self._quoted_non_spaces(double)
        while self.peek() != quote:
            chunks += self._quoted_spaces()
            chunks += self._quoted_non_spaces(double)
        self.forward()
        self.tokens.append(_Token(SCALAR, line, "".join(chunks), False))

    def _quoted_non_spaces(self, double: bool) -> list:
        chunks = []
        while True:
            n = 0
            while self.peek(n) not in "'\"\\\0 \t" + _BREAKS:
                n += 1
            if n:
                chunks.append(self.prefix(n))
                self.forward(n)
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.forward(2)
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.forward()
            elif double and ch == "\\":
                self.forward()
                ch = self.peek()
                if ch in self._ESCAPES:
                    chunks.append(self._ESCAPES[ch])
                    self.forward()
                elif ch in self._CODES:
                    n = self._CODES[ch]
                    self.forward()
                    digits = self.prefix(n)
                    if len(digits) < n or any(c not in "0123456789ABCDEFabcdef" for c in digits):
                        self.fail(f"expected an escape sequence of {n} hexadecimal numbers")
                    chunks.append(chr(int(digits, 16)))
                    self.forward(n)
                elif ch in _BREAKS:
                    self._line_break()
                    chunks += self._quoted_breaks()
                else:
                    self.fail(f"found unknown escape character {ch!r}")
            else:
                return chunks

    def _quoted_spaces(self) -> list:
        n = 0
        while self.peek(n) in " \t":
            n += 1
        whitespace = self.prefix(n)
        self.forward(n)
        ch = self.peek()
        if ch == "\0":
            self.fail("while scanning a quoted scalar: found unexpected end of stream")
        if ch in _BREAKS:
            line_break = self._line_break()
            breaks = self._quoted_breaks()
            chunks = [line_break] if line_break != "\n" else ([] if breaks else [" "])
            return chunks + breaks
        return [whitespace]

    def _quoted_breaks(self) -> list:
        chunks = []
        while True:
            if self.prefix(3) in ("---", "...") and self.peek(3) in _WS_END:
                self.fail("while scanning a quoted scalar: found unexpected document separator")
            while self.peek() in " \t":
                self.forward()
            if self.peek() in _BREAKS:
                chunks.append(self._line_break())
            else:
                return chunks

    def _plain(self) -> None:
        line = self.line
        chunks: list = []
        indent = self.indent + 1
        spaces: list | None = []
        while self.peek() != "#":
            n = 0
            while True:
                ch = self.peek(n)
                if (ch in _WS_END
                        or (ch == ":" and self.peek(n + 1) in _WS_END + (",[]{}" if self.flow else ""))
                        or (self.flow and ch in ",?[]{}")):  # fmt: skip
                    break
                n += 1
            if n == 0:
                break
            self.allow_key = False
            chunks += spaces
            chunks.append(self.prefix(n))
            self.forward(n)
            spaces = self._plain_spaces()
            if not spaces or self.peek() == "#" or (not self.flow and self.col < indent):
                break
        self.tokens.append(_Token(SCALAR, line, "".join(chunks), True))

    def _plain_spaces(self) -> list | None:
        n = 0
        while self.peek(n) == " ":
            n += 1
        whitespace = self.prefix(n)
        self.forward(n)
        if self.peek() not in _BREAKS:
            return [whitespace] if whitespace else []
        line_break = self._line_break()
        self.allow_key = True
        if self.prefix(3) in ("---", "...") and self.peek(3) in _WS_END:
            return None
        breaks = []
        while self.peek() in " " + _BREAKS:
            if self.peek() == " ":
                self.forward()
            else:
                breaks.append(self._line_break())
                if self.prefix(3) in ("---", "...") and self.peek(3) in _WS_END:
                    return None
        chunks = [line_break] if line_break != "\n" else ([] if breaks else [" "])
        return chunks + breaks


# ------------------------------------------------------------------- parsing
# Nodes: ("s", text, plain, line), ("seq", [node], line), ("map", [(node, node)], line).
def _empty(line: int) -> tuple:
    return ("s", "", True, line)


class _Parser:
    """PyYAML's parser grammar for one implicit document."""

    def __init__(self, scanner: _Scanner):
        self.sc = scanner

    def check(self, *kinds: int) -> bool:
        return self.sc.peek_token().kind in kinds

    def fail(self, context: str, token: _Token):
        raise YAMLError(f"while parsing {context}: found {_NAMES[token.kind]} (line {token.line + 1})")

    def document(self):
        if self.check(STREAM_END):
            return None
        node = self.block_node(indentless=False)
        while self.check(DOC_END):
            self.sc.get_token()
        if not self.check(STREAM_END):
            self.fail("a stream, expected '<document start>'", self.sc.peek_token())
        return node

    def block_node(self, indentless: bool):
        token = self.sc.peek_token()
        if indentless and token.kind == ENTRY:
            items = []
            while self.check(ENTRY):
                t = self.sc.get_token()
                items.append(_empty(t.line) if self.check(ENTRY, KEY, VALUE, BLOCK_END) else self.block_node(False))
            return ("seq", items, token.line)
        if token.kind == BLOCK_SEQ:
            self.sc.get_token()
            items = []
            while self.check(ENTRY):
                t = self.sc.get_token()
                items.append(_empty(t.line) if self.check(ENTRY, BLOCK_END) else self.block_node(False))
            self._end(BLOCK_END, "a block collection, expected <block end>")
            return ("seq", items, token.line)
        if token.kind == BLOCK_MAP:
            self.sc.get_token()
            pairs = []
            while self.check(KEY):
                t = self.sc.get_token()
                key = _empty(t.line) if self.check(KEY, VALUE, BLOCK_END) else self.block_node(True)
                value = _empty(t.line)
                if self.check(VALUE):
                    self.sc.get_token()
                    if not self.check(KEY, VALUE, BLOCK_END):
                        value = self.block_node(True)
                pairs.append((key, value))
            self._end(BLOCK_END, "a block mapping, expected <block end>")
            return ("map", pairs, token.line)
        return self.flow_node("a block node")

    def flow_node(self, context: str = "a flow node"):
        token = self.sc.peek_token()
        if token.kind == SCALAR:
            self.sc.get_token()
            return ("s", token.value, token.plain, token.line)
        if token.kind in (FLOW_SEQ, FLOW_MAP):
            return self.flow_collection()
        self.fail(f"{context}, expected the node content", token)

    def flow_collection(self):
        start = self.sc.get_token()
        is_seq = start.kind == FLOW_SEQ
        end = FLOW_SEQ_END if is_seq else FLOW_MAP_END
        entries = []
        first = True
        while not self.check(end):
            if not first:
                if not self.check(FLOW_ENTRY):
                    self.fail(f"a flow {'sequence' if is_seq else 'mapping'}, expected ',' or "
                              f"'{']' if is_seq else '}'}'", self.sc.peek_token())  # fmt: skip
                self.sc.get_token()
            first = False
            if self.check(KEY):
                t = self.sc.get_token()
                key = _empty(t.line) if self.check(VALUE, FLOW_ENTRY, end) else self.flow_node()
                value = _empty(t.line)
                if self.check(VALUE):
                    self.sc.get_token()
                    if not self.check(FLOW_ENTRY, end):
                        value = self.flow_node()
                entries.append(("map", [(key, value)], t.line) if is_seq else (key, value))
            elif not self.check(end):
                node = self.flow_node()
                entries.append(node if is_seq else (node, _empty(node[-1])))
        self.sc.get_token()
        return ("seq" if is_seq else "map", entries, start.line)

    def _end(self, kind: int, context: str) -> None:
        if not self.check(kind):
            self.fail(context, self.sc.peek_token())
        self.sc.get_token()


# -------------------------------------------------------------- construction
# PyYAML's implicit resolvers (yaml/resolver.py), in its order, keyed by the first character.
_RESOLVERS: dict[str, list] = {}
for _tag, _regexp, _first in (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X), "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X), "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X), "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X), ["~", "n", "N", ""]),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X), "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
):  # fmt: skip
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append((_tag, _regexp))

_TIMESTAMP = re.compile(
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


def _resolve(text: str) -> str:
    """The tag PyYAML's SafeLoader gives a plain scalar."""
    for tag, regexp in _RESOLVERS.get(text[0] if text else "", ()):
        if regexp.match(text):
            return tag
    return "str"


def _sexagesimal(text: str, cast) -> Any:
    value = cast(0)
    base = 1
    for digit in reversed([cast(part) for part in text.split(":")]):
        value += digit * base
        base *= 60
    return value


def _construct_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _construct_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _construct_timestamp(text: str) -> datetime.date:
    v = _TIMESTAMP.match(text).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int(v["fraction"][:6].ljust(6, "0")) if v["fraction"] else 0
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]), int(v["second"]), fraction,
                             tzinfo=tzinfo)  # fmt: skip


_CONSTRUCT = {"bool": lambda t: _BOOLS[t.lower()], "float": _construct_float, "int": _construct_int,
              "null": lambda t: None, "timestamp": _construct_timestamp, "str": lambda t: t}  # fmt: skip


def _construct(node) -> Any:
    kind = node[0]
    if kind == "seq":
        return [_construct(n) for n in node[1]]
    if kind == "map":
        out = {}
        for key_node, value_node in node[1]:
            if key_node[0] != "s":
                raise UnsupportedYAML(f"complex keys (a collection as a key, line {key_node[-1] + 1}) are not part "
                                      "of the YAML subset this reader reads")  # fmt: skip
            tag = _resolve(key_node[1]) if key_node[2] else "str"
            if tag == "merge":
                raise UnsupportedYAML(f"merge keys ('<<', line {key_node[-1] + 1}) are not part of the YAML subset "
                                      "this reader reads")  # fmt: skip
            out[key_node[1] if tag == "value" else _construct(key_node)] = _construct(value_node)
        return out
    _, text, plain, line = node
    tag = _resolve(text) if plain else "str"
    if tag not in _CONSTRUCT:
        raise YAMLError(f"could not determine a constructor for the tag '{tag}' (line {line + 1})")
    return _CONSTRUCT[tag](text)


def load(text: str) -> Any:
    """``yaml.safe_load(text)`` for the subset (module docstring)."""
    node = _Parser(_Scanner(text)).document()
    return None if node is None else _construct(node)


def load_file(fp: Path | str) -> Any:
    """`load` of a UTF-8 file."""
    return load(Path(fp).read_text(encoding="utf-8"))


# ------------------------------------------------------------------- writing
_NUMBERISH = re.compile(r"[-+]?(?:\.[0-9]+|[0-9][0-9_]*(?:\.[0-9_]*)?)(?:[eE][-+]?[0-9]+)?|0o[0-7]+"
                        r"|[-+]?\.(?:inf|Inf|INF|nan|NaN|NAN)")  # fmt: skip


def _plain_ok(s: str) -> bool:
    """Whether ``s`` reads back as itself when written plain, in PyYAML and in
    `load` (and as a string under YAML 1.2's number rules too)."""
    return (
        bool(s)
        and all(" " <= c <= "~" for c in s)
        and s[0] not in "-?:,[]{}#&*!|>'\"%@` "
        and s[-1] not in " :"
        and ": " not in s
        and " #" not in s
        and not s.startswith("...")
        and _resolve(s) == "str"
        and not _NUMBERISH.fullmatch(s)
    )


def _quote(s: str) -> str:
    if _plain_ok(s):
        return s
    if all(" " <= c <= "~" for c in s):
        return "'" + s.replace("'", "''") + "'"
    out = []
    for c in s:
        if c in '"\\':
            out.append("\\" + c)
        elif " " <= c <= "~":
            out.append(c)
        elif c in "\n\t\r":
            out.append({"\n": "\\n", "\t": "\\t", "\r": "\\r"}[c])
        else:
            o = ord(c)
            out.append(f"\\x{o:02X}" if o <= 0xFF else f"\\u{o:04X}" if o <= 0xFFFF else f"\\U{o:08X}")
    return '"' + "".join(out) + '"'


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if v is True or v is False:
        return "true" if v else "false"
    if isinstance(v, int):
        return int.__repr__(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = float.__repr__(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, (datetime.date, datetime.datetime)):
        text = v.isoformat(" ") if isinstance(v, datetime.datetime) else v.isoformat()
        if _resolve(text) != "timestamp" or _construct_timestamp(text) != v:
            raise ValueError(f"{v!r} has no YAML timestamp that reads back equal")
        return text
    if isinstance(v, str):
        return _quote(str.__str__(v))
    if isinstance(v, dict) and not v:
        return "{}"
    if isinstance(v, (list, tuple)) and not v:
        return "[]"
    raise TypeError(f"cannot write a {type(v).__name__} as YAML")


def _nested(v: Any) -> bool:
    return isinstance(v, (dict, list, tuple)) and len(v) > 0


def _items(d: dict) -> list:
    """The items sorted by key as ``yaml.safe_dump`` sorts them (in their own
    order where the keys do not compare)."""
    try:
        return sorted(d.items(), key=lambda kv: kv[0])
    except TypeError:
        return list(d.items())


def _block(data: Any, indent: int) -> list[str]:
    pad = " " * indent
    if isinstance(data, dict) and data:
        lines = []
        for k, v in _items(data):
            if isinstance(k, (dict, list, tuple)):
                raise TypeError("cannot write a collection as a YAML key")
            key = _scalar(k)
            if len(key) > 1000:
                raise ValueError("a YAML key longer than 1000 characters does not read back")
            if _nested(v):
                lines.append(f"{pad}{key}:")
                lines += _block(v, indent if isinstance(v, (list, tuple)) else indent + 2)
            else:
                lines.append(f"{pad}{key}: {_scalar(v)}")
        return lines
    if isinstance(data, (list, tuple)) and data:
        lines = []
        for v in data:
            if _nested(v):
                sub = _block(v, indent + 2)
                lines.append(f"{pad}- {sub[0][indent + 2:]}")
                lines += sub[1:]
            else:
                lines.append(f"{pad}- {_scalar(v)}")
        return lines
    return [pad + _scalar(data)]


def dump(data: Any) -> str:
    """``data`` (dicts, lists, tuples, strings, numbers, booleans, None,
    dates) as block-style YAML that `load` and ``yaml.safe_load`` read back
    equal (module docstring)."""
    return "\n".join(_block(data, 0)) + "\n"


def dump_file(data: Any, fp: Path | str) -> None:
    """`dump` into a UTF-8 file."""
    Path(fp).write_text(dump(data), encoding="utf-8")
