"""A reader for the YAML subset SILO's config files use.

The database, preprocessing and runtime configs are block mappings and
block sequences of scalars or mappings, with comments, quoted or plain
scalars, booleans, null, numbers and simple one-line flow lists. This
module parses exactly that (and raises YamlError on anything else), so
the configs load without a YAML package.
"""

from __future__ import annotations

import json
import re


class YamlError(ValueError):
    pass


_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)([eE][-+]?[0-9]+)?$")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str):
    text = text.strip()
    if not text:
        return None
    if text[0] == '"':
        try:
            return json.loads(text)
        except ValueError as ex:
            raise YamlError(f"bad double-quoted scalar {text!r}") from ex
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise YamlError(f"bad single-quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[0] == "[":
        if text[-1] != "]":
            raise YamlError(f"unterminated flow sequence {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(part) for part in inner.split(",")] if inner else []
    if text == "{}":
        return {}
    if text[0] in "{&*!|>%@`":
        raise YamlError(f"unsupported YAML construct {text!r}")
    if text in ("null", "Null", "NULL", "~"):
        return None
    if text in ("true", "True", "TRUE"):
        return True
    if text in ("false", "False", "FALSE"):
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _split_key(content: str, lineno: int):
    """(key, rest) for a `key: rest` line."""
    if content[0] in "\"'":
        end = content.find(content[0], 1)
        if end < 0 or not content[end + 1:].startswith(":"):
            raise YamlError(f"line {lineno}: bad quoted key")
        return _scalar(content[: end + 1]), content[end + 2:]
    match = re.match(r"([^:#]+?)\s*:(\s+|$)", content)
    if not match:
        raise YamlError(f"line {lineno}: expected 'key: value', got "
                        f"{content!r}")
    return match.group(1), content[match.end():]


class _Parser:
    def __init__(self, text: str):
        self.lines = []
        for lineno, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YamlError(f"line {lineno}: tab indentation")
            line = _strip_comment(raw).rstrip()
            if not line.strip() or line.strip() in ("---", "..."):
                continue
            indent = len(line) - len(line.lstrip(" "))
            self.lines.append((indent, line.strip(), lineno))
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int):
        line = self.peek()
        if line is None or line[0] < indent:
            return None
        if line[1] == "-" or line[1].startswith("- "):
            return self.sequence(line[0])
        return self.mapping(line[0])

    def mapping(self, indent: int, first: str | None = None):
        out: dict = {}
        while True:
            if first is not None:
                content, lineno = first, self.lines[self.i - 1][2]
                first = None
            else:
                line = self.peek()
                if line is None or line[0] < indent:
                    return out
                if line[0] > indent:
                    raise YamlError(f"line {line[2]}: unexpected indent")
                if line[1] == "-" or line[1].startswith("- "):
                    return out
                _, content, lineno = line
                self.i += 1
            key, rest = _split_key(content, lineno)
            if key in out:
                raise YamlError(f"line {lineno}: duplicate key {key!r}")
            if rest.strip():
                out[key] = _scalar(rest)
                continue
            nxt = self.peek()
            if nxt is not None and (nxt[0] > indent or (
                    nxt[0] == indent and (nxt[1] == "-"
                                          or nxt[1].startswith("- ")))):
                out[key] = self.block(nxt[0])
            else:
                out[key] = None

    def sequence(self, indent: int):
        out = []
        while True:
            line = self.peek()
            if line is None or line[0] < indent:
                return out
            if line[0] > indent:
                raise YamlError(f"line {line[2]}: unexpected indent")
            if not (line[1] == "-" or line[1].startswith("- ")):
                return out
            self.i += 1
            rest = line[1][1:]
            item_indent = indent + 1 + (len(rest) - len(rest.lstrip(" ")))
            rest = rest.strip()
            if not rest:
                out.append(self.block(indent + 1))
            elif re.match(r"(\"[^\"]*\"|'[^']*'|[^:#\[\"']+?)\s*:(\s|$)",
                          rest):
                out.append(self.mapping(item_indent, first=rest))
            else:
                out.append(_scalar(rest))


def load(text: str):
    """The document's value (None for an empty document)."""
    parser = _Parser(text)
    value = parser.block(0)
    if parser.peek() is not None:
        raise YamlError(f"line {parser.peek()[2]}: unexpected content")
    return value


def load_file(path):
    with open(path) as f:
        return load(f.read())


def dump_mapping(mapping: dict) -> str:
    """A flat mapping of scalars as YAML (`key: value` lines, strings
    double-quoted) — what the CLI's config files need."""
    lines = []
    for key, value in mapping.items():
        lines.append(f"{key}: {json.dumps(value)}")
    return "\n".join(lines) + "\n"
