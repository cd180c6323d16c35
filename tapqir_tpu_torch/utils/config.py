"""``.tapqir/config.yaml`` without PyYAML.

The workspace config is the small YAML document that the JAX package's CLI
writes with ``yaml.dump(config, sort_keys=False)``: a block mapping of
scalars (int, float, bool, null, plain or quoted strings), the nested
``priors`` mapping, and the ``channels`` list of mappings that ``glimpse``
writes. :func:`load_config` reads that subset of YAML (with YAML 1.1
scalar resolution, as ``yaml.safe_load`` does), and :func:`dump_config`
writes a document in it that ``yaml.safe_load`` reads back to the same
values. Anchors, tags, flow collections other than ``[]`` / ``{}``, block
scalars (``|``, ``>``) and multi-document streams are not part of it and
raise ``ValueError``.
"""

import json
import math
import re

__all__ = ["load_config", "dump_config"]

_BOOLS = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$"
)
_SPECIAL_FLOATS = {
    **dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"), math.inf),
    **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), -math.inf),
    **dict.fromkeys((".nan", ".NaN", ".NAN"), math.nan),
}
_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
               "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
               "\\": "\\", "N": "\x85", "_": "\xa0"}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _scalar(text):
    """A plain or quoted scalar, resolved as YAML 1.1 resolves it."""
    text = text.strip()
    if text.startswith("'"):
        if not text.endswith("'") or len(text) < 2:
            raise ValueError(f"unterminated quoted scalar: {text}")
        return text[1:-1].replace("''", "'")
    if text.startswith('"'):
        if not text.endswith('"') or len(text) < 2:
            raise ValueError(f"unterminated quoted scalar: {text}")
        return _unescape(text[1:-1])
    if text == "[]":
        return []
    if text == "{}":
        return {}
    if text[:1] in ("&", "*", "!", "|", ">", "[", "{", "%", "@", "`"):
        raise ValueError(f"unsupported YAML construct: {text}")
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    return text


def _unescape(body):
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1]
        if code in _DQ_ESCAPES:
            out.append(_DQ_ESCAPES[code])
            i += 2
        elif code in "xuU":
            n = {"x": 2, "u": 4, "U": 8}[code]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"unsupported escape \\{code}")
    return "".join(out)


def _strip_comment(line, quote=None):
    """The line without a trailing `` #`` comment outside quotes, and the
    quote still open at its end (a quoted scalar may span lines); ``quote``
    is the one open at its start."""
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'" and line.startswith("''", i):
            i += 1  # an escaped quote
        elif quote == '"' and ch == "\\":
            i += 1
        elif quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip(), None
        i += 1
    return line.rstrip(), quote


def _split_key(text):
    """(key, rest) for a ``key: value`` or ``key:`` entry, else None."""
    if text.startswith(("'", '"')):
        end = text.index(text[0], 1)
        while text[0] == "'" and text[end + 1:end + 2] == "'":  # '' escape
            end = text.index("'", end + 2)
        key, rest = _scalar(text[:end + 1]), text[end + 1:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    m = re.match(r"^([^#\s][^:]*?|[^#\s]*?):(?: (.*))?$", text)
    if m is None:
        return None
    return _scalar(m.group(1)), (m.group(2) or "").strip()


class _Lines:
    def __init__(self, text):
        self.items = []
        quote = None
        for raw in text.splitlines():
            if raw.strip() in ("---", "...") and not raw.startswith(" "):
                raise ValueError("multi-document YAML is not supported")
            line, quote = _strip_comment(raw, quote)
            if line.strip():
                if "\t" in line[: len(line) - len(line.lstrip())]:
                    raise ValueError("tabs in indentation")
                self.items.append((len(line) - len(line.lstrip(" ")), line.strip()))
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else (None, None)


def _continued(lines, indent, text):
    """A plain or quoted scalar folded over more-indented lines: a line break
    reads as a space, and not at all after the escaping backslash of a
    double-quoted scalar."""
    while True:
        ind, t = lines.peek()
        if ind is None or ind <= indent:
            return text
        escaped = text.startswith('"') and (len(text) - len(text.rstrip("\\"))) % 2
        text = text[:-1] + t if escaped else text + " " + t
        lines.pos += 1


def _block(lines, indent):
    """The block node (mapping or sequence) whose entries sit at ``indent``."""
    _, text = lines.peek()
    if text.startswith("- ") or text == "-":
        return _sequence(lines, indent)
    return _mapping(lines, indent)


def _value(lines, indent, rest, parent_indent):
    """The value after ``key:`` or ``- ``: inline, or a nested block."""
    if rest:
        return _scalar(_continued(lines, parent_indent, rest))
    ind, text = lines.peek()
    if ind is None:
        return None
    # a sequence may sit at its key's own indentation (yaml.dump's style)
    if ind > indent or (ind == indent and (text.startswith("- ") or text == "-")):
        return _block(lines, ind)
    return None


def _mapping(lines, indent):
    out = {}
    while True:
        ind, text = lines.peek()
        if ind is None or ind < indent:
            return out
        if ind > indent:
            raise ValueError(f"bad indentation at {text!r}")
        kv = _split_key(text)
        if kv is None:
            if text.startswith("- "):
                return out  # a sequence at the parent key's indentation ends here
            raise ValueError(f"expected 'key: value', got {text!r}")
        lines.pos += 1
        key, rest = kv
        out[key] = _value(lines, indent, rest, indent)


def _sequence(lines, indent):
    out = []
    while True:
        ind, text = lines.peek()
        if ind is None or ind < indent or not (text.startswith("- ") or text == "-"):
            return out
        if ind > indent:
            raise ValueError(f"bad indentation at {text!r}")
        item = text[2:].strip()
        item_indent = indent + 2
        if item and _split_key(item) is not None:
            # a mapping that starts on the dash line: rewrite its first entry
            # as a line of its own at the mapping's indentation
            lines.items[lines.pos] = (item_indent, item)
            out.append(_mapping(lines, item_indent))
        else:
            lines.pos += 1
            out.append(_value(lines, indent, item, indent))


def load_config(text):
    """Parse a config document; an empty one gives {}."""
    lines = _Lines(text)
    if not lines.items:
        return {}
    ind, _ = lines.peek()
    node = _block(lines, ind)
    if lines.pos != len(lines.items):
        raise ValueError(f"unexpected content at {lines.peek()[1]!r}")
    return node


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_PLAIN = re.compile(r"^[A-Za-z0-9_./\\()+=][A-Za-z0-9_./\\()+=\- ]*$")


def _dump_scalar(value):
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)  # 1e-05 alone would read as a string
        return text
    text = str(value)
    if any(ord(c) < 32 or ord(c) == 127 for c in text):
        return json.dumps(text)  # a JSON string is a valid double-quoted scalar
    if _PLAIN.match(text) and not text.endswith(" ") and _scalar(text) == text:
        return text
    return "'" + text.replace("'", "''") + "'"


def _dump(value, indent, out):
    pad = " " * indent
    for key, v in value.items():
        k = _dump_scalar(key)
        if isinstance(v, dict) and v:
            out.append(f"{pad}{k}:")
            _dump(v, indent + 2, out)
        elif isinstance(v, (list, tuple)) and v:
            out.append(f"{pad}{k}:")
            for item in v:
                if isinstance(item, dict) and item:
                    sub = []
                    _dump(item, indent + 2, sub)
                    out.append(f"{pad}- {sub[0].lstrip()}")
                    out.extend(sub[1:])
                elif isinstance(item, (dict, list, tuple)):
                    out.append(f"{pad}- {'{}' if isinstance(item, dict) else '[]'}")
                else:
                    out.append(f"{pad}- {_dump_scalar(item)}")
        elif isinstance(v, dict):
            out.append(f"{pad}{k}: {{}}")
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{k}: []")
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}")


def dump_config(config):
    """The config mapping as a YAML document in the subset above (block
    style, keys in insertion order, as ``yaml.dump(..., sort_keys=False)``)."""
    out = []
    _dump(config, 0, out)
    return "\n".join(out) + "\n"
