"""A reader and an emitter for the YAML that config files use, without PyYAML.

The reader takes the subset of YAML 1.1 found in ``configs/`` and
``projects/*/configs/``, and returns what PyYAML's ``SafeLoader`` returns for
it:
  * block mappings and sequences, nested by indentation, including a sequence
    at its key's own indentation (``KEY:`` then ``- item``) and a mapping
    begun on a ``- `` line;
  * flow sequences and mappings (``[a, [b, c]]``, ``{K: v}``), also spread
    over several lines;
  * plain, single-quoted and double-quoted scalars, resolved as PyYAML
    resolves them: null, booleans (``true``, ``yes``, ``on``, ...), ints
    (decimal, ``0x``, ``0o``/leading 0, ``0b``), floats (which need a dot:
    ``2.5e-4`` is a float, ``1e-4`` a string), anything else a string. A
    tuple such as ``("a", "b")`` is a plain string here, as under PyYAML;
    ``CfgNode`` literal-evaluates it when it merges;
  * comments, blank lines;
  * the one tag configs use, ``!!python/object/apply:eval ["<expr>"]``
    (``configs/Base-RetinaNet.yaml``), evaluated with no builtins.
Anything else (anchors, aliases, other tags, block scalars, multi-line plain
scalars, complex keys, documents) raises ``YamlError`` naming the file and
line.

The emitter writes nested dicts as block mappings with sorted keys and lists
and tuples as flow sequences, with every scalar in a form the reader (and
PyYAML) resolves back to the same value.
"""

import json
import math
import re
from typing import Any, List, Tuple

__all__ = ["YamlError", "dump_yaml", "load_yaml"]

EVAL_TAG = "!!python/object/apply:eval"

_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_BOOL_RE = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF")
_NULL_RE = re.compile(r"~|null|Null|NULL|")
_INT_RE = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
                     r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_FLOAT_RE = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_TIMESTAMP_RE = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_PLAIN_OUT = re.compile(r"[A-Za-z_./][A-Za-z0-9_./-]*")


class YamlError(ValueError):
    """A YAML construct outside the reader's subset, or malformed YAML."""


def _sexagesimal(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    t = t.lstrip("+-")
    if t == "0":
        return 0
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if t.startswith("0"):
        return sign * int(t, 8)
    if ":" in t:
        return sign * _sexagesimal(t, int)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    t = t.lstrip("+-")
    if t == ".inf":
        return sign * math.inf
    if t == ".nan":
        return math.nan
    if ":" in t:
        return sign * _sexagesimal(t, float)
    return sign * float(t)


def resolve_plain(text: str, where: str = "") -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader resolves it."""
    if _NULL_RE.fullmatch(text):
        return None
    if _BOOL_RE.fullmatch(text):
        return _BOOL[text.lower()]
    if _INT_RE.fullmatch(text):
        return _int(text)
    if _FLOAT_RE.fullmatch(text):
        return _float(text)
    if _TIMESTAMP_RE.match(text):
        raise YamlError(f"{where}: timestamps are outside the config subset: {text!r}")
    return text


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[Tuple[int, int, str]] = self._logical_lines(text)

    def where(self, lineno: int) -> str:
        return f"{self.name}:{lineno}"

    # -- lines ---------------------------------------------------------------
    def _logical_lines(self, text: str) -> List[Tuple[int, int, str]]:
        """(line number, indent, content) without comments or blank lines. A
        flow collection or a quoted scalar left open is joined with the lines
        that close it, a line break folding into one space."""
        out = []
        pending = None  # (lineno, indent, content) of an open flow collection or quote
        depth, quote = 0, None
        for lineno, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
                raise YamlError(f"{self.where(lineno)}: tab in indentation")
            content, depth, quote = self._strip_comment(raw, depth, quote)
            content = content.rstrip()
            if pending is not None:
                if not content.strip():
                    raise YamlError(f"{self.where(lineno)}: blank line inside a flow collection or quoted scalar")
                ln, ind, prev = pending
                pending = (ln, ind, prev + " " + content.strip())
            elif not content.strip():
                continue
            else:
                if not out and content.startswith(("---", "...", "%")):
                    raise YamlError(f"{self.where(lineno)}: document markers and directives are outside "
                                    "the config subset")
                pending = (lineno, len(content) - len(content.lstrip(" ")), content.strip())
            if depth <= 0 and quote is None:
                out.append(pending)
                pending, depth = None, 0
        if pending is not None:
            raise YamlError(f"{self.where(pending[0])}: flow collection or quoted scalar not closed")
        return out

    @staticmethod
    def _strip_comment(line: str, depth: int, quote):
        """(the line without its comment, the flow depth and the open quote
        at its end), given those at its start."""
        i = 0
        while i < len(line):
            c = line[i]
            if quote == "'":
                if c == "'":
                    if line[i + 1: i + 2] == "'":
                        i += 1
                    else:
                        quote = None
            elif quote == '"':
                if c == "\\":
                    i += 1
                elif c == '"':
                    quote = None
            elif c == "#" and (i == 0 or line[i - 1] in " \t"):
                return line[:i], depth, quote
            elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-?"):
                quote = c
            elif c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
            i += 1
        return line, depth, quote

    # -- block structure -------------------------------------------------------
    def parse(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0][1])
        if i < len(self.lines):
            raise YamlError(f"{self.where(self.lines[i][0])}: unexpected indentation")
        return value

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        _, _, content = self.lines[i]
        if _is_item(content):
            return self.sequence(i, indent)
        return self.mapping(i, indent)

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines):
            lineno, ind, content = self.lines[i]
            if ind < indent:
                break
            if ind > indent or _is_item(content):
                raise YamlError(f"{self.where(lineno)}: unexpected indentation or sequence item in a mapping")
            key, rest = self.split_key(content, lineno)
            i += 1
            if rest:
                value = self.inline(rest, lineno)
            elif i < len(self.lines) and self.lines[i][1] > indent:
                value, i = self.block(i, self.lines[i][1])
            elif i < len(self.lines) and self.lines[i][1] == indent and _is_item(self.lines[i][2]):
                value, i = self.sequence(i, indent)
            else:
                value = None
            out[key] = value
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines):
            lineno, ind, content = self.lines[i]
            if ind < indent or (ind == indent and not _is_item(content)):
                break
            if ind > indent:
                raise YamlError(f"{self.where(lineno)}: unexpected indentation in a sequence")
            rest = content[1:].lstrip(" ")
            if not rest:
                i += 1
                if i < len(self.lines) and self.lines[i][1] > indent:
                    value, i = self.block(i, self.lines[i][1])
                else:
                    value = None
            elif _is_item(rest) or self.find_colon(rest, lineno) is not None:
                # a nested sequence or a mapping begun on the item's line:
                # re-read the line at the column its content starts at
                col = ind + len(content) - len(rest)
                self.lines[i] = (lineno, col, rest)
                value, i = self.block(i, col)
            else:
                value = self.inline(rest, lineno)
                i += 1
            out.append(value)
        return out, i

    def find_colon(self, text: str, lineno: int):
        """Index of the ``:`` that ends a block mapping key in ``text``, or
        None (outside quotes and flow collections; followed by a space or the
        end of the line)."""
        quote, depth = None, 0
        for i, c in enumerate(text):
            if quote:
                if c == quote:
                    quote = None
                continue
            if c in "'\"" and (i == 0 or text[i - 1] in " [{,"):
                quote = c
            elif c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
            elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] == " "):
                return i
        return None

    def split_key(self, content: str, lineno: int) -> Tuple[Any, str]:
        if content.startswith("? "):
            raise YamlError(f"{self.where(lineno)}: complex keys are outside the config subset")
        at = self.find_colon(content, lineno)
        if at is None:
            raise YamlError(f"{self.where(lineno)}: expected 'key: value', got {content!r} "
                            "(multi-line plain scalars are outside the config subset)")
        key_text = content[:at].strip()
        key, end = _Flow(key_text, self.where(lineno)).scalar(0, block=True)
        if end != len(key_text):
            raise YamlError(f"{self.where(lineno)}: malformed key {key_text!r}")
        return key, content[at + 1:].strip()

    def inline(self, text: str, lineno: int) -> Any:
        """The value written on a line after ``key:`` or ``- ``."""
        where = self.where(lineno)
        if text.startswith(EVAL_TAG):
            args = _Flow(text[len(EVAL_TAG):].strip(), where).whole()
            if not (isinstance(args, list) and len(args) == 1 and isinstance(args[0], str)):
                raise YamlError(f"{where}: {EVAL_TAG} takes a list of one string, got {args!r}")
            return eval(args[0], {"__builtins__": {}}, {})  # noqa: S307
        if text[0] in "!&*|>%@`":
            raise YamlError(f"{where}: {text[0]!r} (tags, anchors, aliases, block scalars) "
                            "is outside the config subset")
        return _Flow(text, where).whole(block=True)


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Flow:
    """A recursive-descent reader of one line's flow node."""

    def __init__(self, text: str, where: str):
        self.text, self.where = text, where

    def error(self, msg: str, pos: int):
        raise YamlError(f"{self.where}: {msg} at column {pos + 1} of {self.text!r}")

    def skip(self, i: int) -> int:
        while i < len(self.text) and self.text[i] == " ":
            i += 1
        return i

    def whole(self, block: bool = False) -> Any:
        value, i = self.node(0, block)
        if self.skip(i) != len(self.text):
            self.error("unexpected text", i)
        return value

    def node(self, i: int, block: bool = False) -> Tuple[Any, int]:
        i = self.skip(i)
        if i >= len(self.text):
            return None, i
        c = self.text[i]
        if c == "[":
            return self.seq(i + 1)
        if c == "{":
            return self.map(i + 1)
        if c in "!&*|>%@`":
            self.error(f"{c!r} is outside the config subset", i)
        return self.scalar(i, block)

    def seq(self, i: int) -> Tuple[list, int]:
        out = []
        while True:
            i = self.skip(i)
            if i >= len(self.text):
                self.error("flow sequence not closed", i)
            if self.text[i] == "]":
                return out, i + 1
            value, i = self.node(i)
            i = self.skip(i)
            if i < len(self.text) and self.text[i] == ":":
                self.error("single-pair mappings in a flow sequence are outside the config subset", i)
            out.append(value)
            if i < len(self.text) and self.text[i] == ",":
                i += 1
            elif i >= len(self.text) or self.text[i] != "]":
                self.error("expected ',' or ']'", i)

    def map(self, i: int) -> Tuple[dict, int]:
        out = {}
        while True:
            i = self.skip(i)
            if i >= len(self.text):
                self.error("flow mapping not closed", i)
            if self.text[i] == "}":
                return out, i + 1
            key, i = self.scalar(i)
            i = self.skip(i)
            value = None
            if i < len(self.text) and self.text[i] == ":":
                value, i = self.node(i + 1)
                i = self.skip(i)
            out[key] = value
            if i < len(self.text) and self.text[i] == ",":
                i += 1
            elif i >= len(self.text) or self.text[i] != "}":
                self.error("expected ',' or '}'", i)

    def scalar(self, i: int, block: bool = False) -> Tuple[Any, int]:
        c = self.text[i] if i < len(self.text) else ""
        if c == "'":
            return self.single(i + 1)
        if c == '"':
            return self.double(i + 1)
        j = i
        while j < len(self.text):
            ch = self.text[j]
            if ch == ":" and (j + 1 == len(self.text) or self.text[j + 1] == " "
                              or (not block and self.text[j + 1] in ",[]{}")):
                break
            if not block and ch in ",[]{}":
                break
            j += 1
        return resolve_plain(self.text[i:j].rstrip(" "), self.where), j

    def single(self, i: int) -> Tuple[str, int]:
        out = []
        while i < len(self.text):
            if self.text[i] == "'":
                if self.text[i + 1: i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(self.text[i])
            i += 1
        self.error("single-quoted scalar not closed", i)

    def double(self, i: int) -> Tuple[str, int]:
        out = []
        while i < len(self.text):
            c = self.text[i]
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                e = self.text[i + 1: i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    out.append(chr(int(self.text[i + 2: i + 2 + n], 16)))
                    i += 2 + n
                    continue
                self.error(f"unknown escape \\{e}", i)
            out.append(c)
            i += 1
        self.error("double-quoted scalar not closed", i)


def load_yaml(text: str, name: str = "<string>") -> Any:
    """The value of one YAML document in the config subset (None when it is
    empty). ``name`` goes into error messages."""
    return _Reader(text, name).parse()


# -- emitter ---------------------------------------------------------------------


def _emit_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:  # YAML 1.1 floats need a dot
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _PLAIN_OUT.fullmatch(v) and resolve_plain(v) == v:
            return v
        return json.dumps(v, ensure_ascii=False)  # a JSON string is a YAML double-quoted scalar
    raise TypeError(f"cannot write {type(v).__name__} {v!r} to YAML")


def _emit_flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_emit_scalar(k)}: {_emit_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_emit_flow(x) for x in v) + "]"
    return _emit_scalar(v)


def _emit_mapping(d: dict, indent: int, lines: List[str]) -> None:
    for k in sorted(d, key=str):
        v = d[k]
        head = " " * indent + _emit_scalar(k) + ":"
        if isinstance(v, dict) and v:
            lines.append(head)
            _emit_mapping(v, indent + 2, lines)
        else:
            lines.append(head + " " + _emit_flow(v))


def dump_yaml(data: dict) -> str:
    """``data`` (nested dicts of scalars, lists and tuples) as a YAML block
    mapping, keys sorted, lists and tuples as flow sequences."""
    lines: List[str] = []
    _emit_mapping(data, 0, lines)
    return "\n".join(lines) + "\n"
