"""A reader for the subset of YAML that the workload and model configs use.

The port reads its configs without the ``yaml`` package.  The subset:

* block mappings nested by indentation (spaces only), one ``key: value``
  per line, keys plain or quoted scalars;
* block sequences of scalars or flow lists (``- item`` lines, at the
  parent key's indentation or deeper), as ``yaml.safe_dump`` writes lists;
* ``#`` comments, on a line of their own or after whitespace;
* scalars: double-quoted (with YAML's escapes), single-quoted (``''`` for
  a quote) and plain, typed as YAML 1.1 ``safe_load`` types them
  (null, bool, int, float, else str);
* flow lists ``[a, "b", [1, 2]]`` on one line.

Everything else raises ``ValueError`` naming the file and the line:
flow mappings, anchors and aliases, tags, block scalars (``|``, ``>``),
scalars continued over several lines, directives and document markers,
tabs in indentation, timestamps, merge keys and duplicate keys.  The
result of a document in the subset equals ``yaml.safe_load``'s.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

# YAML 1.1 implicit types, as PyYAML's resolver (yaml/resolver.py) writes them
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_TRUE = frozenset("yes Yes YES true True TRUE on On ON".split())
_BOOL_FALSE = frozenset("no No NO false False FALSE off Off OFF".split())
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# a plain scalar may not start with one of these (YAML 1.1 indicators)
_PLAIN_FORBIDDEN_START = set("[]{}#&*!|>'\"%@`,")
_DQ_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
    "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
    "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " ",
}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


class _Error(ValueError):
    pass


def _sexagesimal(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve_plain(text: str) -> Any:
    """A plain scalar's value, typed as PyYAML's SafeLoader types it."""
    if _NULL.match(text):
        return None
    if text in _BOOL_TRUE:
        return True
    if text in _BOOL_FALSE:
        return False
    if _INT.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        if s[0] in "+-":
            s = s[1:]
        if s == "0":
            return 0
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if s[0] == "0":
            return sign * int(s, 8)
        if ":" in s:
            return sign * _sexagesimal(s, int)
        return sign * int(s)
    if _FLOAT.match(text):
        s = text.replace("_", "").lower()
        sign = -1.0 if s[0] == "-" else 1.0
        if s[0] in "+-":
            s = s[1:]
        if s == ".inf":
            return sign * float("inf")
        if s == ".nan":
            return float("nan")
        if ":" in s:
            return sign * _sexagesimal(s, float)
        return sign * float(s)
    if _TIMESTAMP.match(text):
        raise _Error(f"timestamp {text!r} is outside the supported YAML subset")
    if text in ("<<", "="):
        raise _Error(f"{text!r} (merge or value key) is outside the supported YAML subset")
    return text


class _Line:
    """A scanner over one line's content."""

    def __init__(self, text: str, pos: int = 0):
        self.text, self.pos = text, pos

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """True when only spaces and a comment remain."""
        rest = self.text[self.pos:]
        stripped = rest.lstrip(" ")
        return not stripped or (stripped[0] == "#" and (stripped != rest or self.pos == 0
                                                        or self.text[self.pos - 1] == " "))

    def double_quoted(self) -> str:
        self.pos += 1
        out = []
        while True:
            ch = self.peek()
            if not ch:
                raise _Error("double-quoted scalar continues over several lines "
                             "(outside the supported YAML subset)")
            self.pos += 1
            if ch == '"':
                return "".join(out)
            if ch != "\\":
                out.append(ch)
                continue
            esc = self.peek()
            self.pos += 1
            if esc in _DQ_ESCAPES:
                out.append(_DQ_ESCAPES[esc])
            elif esc in _DQ_HEX:
                n = _DQ_HEX[esc]
                digits = self.text[self.pos:self.pos + n]
                if len(digits) != n or not all(c in "0123456789abcdefABCDEF" for c in digits):
                    raise _Error(f"bad escape \\{esc}{digits} in a double-quoted scalar")
                out.append(chr(int(digits, 16)))
                self.pos += n
            else:
                raise _Error(f"unsupported escape \\{esc} in a double-quoted scalar")

    def single_quoted(self) -> str:
        self.pos += 1
        out = []
        while True:
            ch = self.peek()
            if not ch:
                raise _Error("single-quoted scalar continues over several lines "
                             "(outside the supported YAML subset)")
            self.pos += 1
            if ch == "'":
                if self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            out.append(ch)

    def plain(self, flow: bool) -> str:
        """A plain scalar up to ``: ``, `` #`` or the end (and ``,``/``]`` in
        a flow list), trailing spaces dropped."""
        ch = self.peek()
        nxt = self.text[self.pos + 1:self.pos + 2]
        if ch in _PLAIN_FORBIDDEN_START or (ch in "-?:" and nxt in ("", " ")):
            raise _Error(f"{ch!r} starts an anchor, alias, tag, block scalar, flow "
                         f"mapping or other construct outside the supported YAML subset")
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            nxt = self.text[self.pos + 1:self.pos + 2]
            if ch == ":" and (nxt in ("", " ") or (flow and nxt in ",[]{}")):
                break
            if ch == "#" and self.text[self.pos - 1] == " ":
                break
            if flow and ch in ",[]{}":
                break
            self.pos += 1
        return self.text[start:self.pos].rstrip(" ")

    def scalar(self, flow: bool = False) -> Any:
        ch = self.peek()
        if ch == '"':
            return self.double_quoted()
        if ch == "'":
            return self.single_quoted()
        return _resolve_plain(self.plain(flow))

    def flow_list(self) -> list:
        self.pos += 1
        items: list = []
        while True:
            self.skip_spaces()
            ch = self.peek()
            if not ch:
                raise _Error("flow list continues over several lines "
                             "(outside the supported YAML subset)")
            if ch == "]" and not items:
                self.pos += 1
                return items
            if ch == "{":
                raise _Error("flow mappings are outside the supported YAML subset")
            items.append(self.flow_list() if ch == "[" else self.scalar(flow=True))
            self.skip_spaces()
            ch = self.peek()
            self.pos += 1
            if ch == "]":
                return items
            if ch != ",":
                raise _Error(f"expected ',' or ']' in a flow list, found {ch!r}")

    def value(self) -> Any:
        """A value that fills the rest of the line: a flow list or a scalar."""
        self.skip_spaces()
        value = self.flow_list() if self.peek() == "[" else self.scalar()
        if not self.at_end():
            raise _Error(f"unexpected text after a value: {self.text[self.pos:]!r}")
        return value


def _split_key(line: _Line) -> Tuple[Any, bool]:
    """Reads ``key:`` from the start of ``line``; returns (key, quoted)."""
    ch = line.peek()
    if ch in ('"', "'"):
        key = line.scalar()
        quoted = True
    elif ch == "[" or ch == "{":
        raise _Error("complex (flow) keys are outside the supported YAML subset")
    elif ch == "?" and line.text[line.pos + 1:line.pos + 2] in ("", " "):
        raise _Error("explicit '?' keys are outside the supported YAML subset")
    else:
        key = _resolve_plain(line.plain(flow=False))
        quoted = False
    line.skip_spaces()
    if line.peek() != ":" or line.text[line.pos + 1:line.pos + 2] not in ("", " "):
        raise _Error("expected 'key: value' (a block mapping entry); other "
                     "constructs are outside the supported YAML subset")
    line.pos += 1
    return key, quoted


class _Parser:
    def __init__(self, path: str, text: str):
        self.path = path
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for number, raw in enumerate(text.splitlines(), start=1):
            self._check_raw(number, raw)
            content = raw.lstrip(" ")
            if not content or content.startswith("#"):
                continue
            self.lines.append((number, len(raw) - len(content), content))
        self.i = 0

    def _check_raw(self, number: int, raw: str) -> None:
        indent = raw[:len(raw) - len(raw.lstrip(" \t"))]
        if "\t" in indent:
            raise self.error(number, "tabs in indentation are not YAML")
        if raw.startswith(("%", "---", "...")):
            raise self.error(number, "directives and document markers are outside "
                                     "the supported YAML subset")

    def error(self, number: int, msg: str) -> ValueError:
        return ValueError(f"{self.path}:{number}: {msg}")

    def parse(self) -> Optional[dict]:
        if not self.lines:
            return None
        number, indent, _ = self.lines[0]
        if indent:
            raise self.error(number, "the document does not start at column 0")
        out = self.mapping(0)
        if self.i < len(self.lines):
            number = self.lines[self.i][0]
            raise self.error(number, "indentation does not match any open block")
        return out

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            number, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise self.error(number, "unexpected indentation")
            if content.startswith("- ") or content == "-":
                raise self.error(number, "a sequence item where a mapping key was expected")
            self.i += 1
            try:
                line = _Line(content)
                key, _ = _split_key(line)
                if isinstance(key, (list, dict)):
                    raise _Error("unhashable key")
                if key in out:
                    raise _Error(f"duplicate key {key!r}")
                if line.at_end():
                    out[key] = self.nested(indent)
                else:
                    out[key] = line.value()
            except _Error as e:
                raise self.error(number, str(e)) from None
        return out

    def nested(self, indent: int) -> Any:
        """The value of a key whose line ends after the colon: a block
        mapping indented deeper, a block sequence at ``indent`` or deeper,
        or null."""
        if self.i >= len(self.lines):
            return None
        _, ind, content = self.lines[self.i]
        if content.startswith("- ") or content == "-":
            return self.sequence(ind) if ind >= indent else None
        if ind > indent:
            return self.mapping(ind)
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            number, ind, content = self.lines[self.i]
            if ind != indent or not (content.startswith("- ") or content == "-"):
                if ind > indent:
                    raise self.error(number, "unexpected indentation in a block sequence")
                break
            self.i += 1
            line = _Line(content, 1)
            try:
                if line.at_end():
                    raise _Error("empty or nested block sequence items are outside "
                                 "the supported YAML subset")
                line.skip_spaces()
                rest = line.text[line.pos:]
                if rest.startswith(("- ", "-")) and rest[1:2] in ("", " "):
                    raise _Error("nested block sequences are outside the supported "
                                 "YAML subset")
                probe = _Line(rest)
                if probe.peek() not in "[\"'":
                    probe.plain(flow=False)
                    if probe.peek() == ":":
                        raise _Error("mappings inside block sequences are outside "
                                     "the supported YAML subset")
                out.append(line.value())
            except _Error as e:
                raise self.error(number, str(e)) from None
        return out


def load(path: str) -> Any:
    """The document in ``path`` (a mapping, or None when it is empty)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return loads(text, path)


def loads(text: str, path: str = "<string>") -> Any:
    """The document in ``text``; ``path`` names it in errors."""
    return _Parser(path, text).parse()
