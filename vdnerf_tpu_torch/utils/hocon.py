"""Minimal HOCON config parser + typed accessors.

The reference drives everything from pyhocon ``.conf`` files with raw-text
template substitution of ``CASE_NAME`` / ``IMG_DIR`` / ``TYPE`` before parsing
(see reference dpt_runner.py:28-36) and typed getters with defaults
(``conf.get_int/get_float/get_bool``, dpt_runner.py:52-105) plus dotted
sub-tree access (``conf['model.sdf_network']`` splatted as kwargs).

pyhocon is not available in this environment, so this module implements the
HOCON subset those config files actually use:

- ``#`` and ``//`` comments (the latter only when preceded by whitespace)
- nested objects ``name { ... }``
- ``key = value`` / ``key : value`` assignments, optional trailing commas
- lists ``[a, b, c]``, possibly multi-line with trailing commas
- scalars: bools (true/false, any case), ints, floats (incl. ``5e-4``),
  and unquoted/quoted strings (paths like ``./exp/CASE_NAME/womsk_white``)
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Iterator


class Config(Mapping):
    """An immutable-ish nested config with dotted-path access.

    ``cfg['a.b.c']`` descends through nested objects; sub-objects come back
    wrapped in :class:`Config` so they support the same API and can be
    splatted (``**cfg['model.nerf']``).
    """

    def __init__(self, data: dict):
        self._data = data

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        node: Any = self._data
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(key)
            node = node[part]
        if isinstance(node, dict):
            return Config(node)
        return node

    def __setitem__(self, key: str, value: Any) -> None:
        node = self._data
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def __contains__(self, key: object) -> bool:
        try:
            self[key]  # type: ignore[index]
            return True
        except (KeyError, TypeError):
            return False

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def to_dict(self) -> dict:
        return self._data

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    # -- typed getters (pyhocon-compatible surface) -------------------------
    _MISSING = object()

    def _get(self, key: str, default: Any) -> Any:
        try:
            return self[key]
        except KeyError:
            if default is Config._MISSING:
                raise
            return default

    def get(self, key: str, default: Any = None) -> Any:
        return self._get(key, default)

    def get_int(self, key: str, default: Any = _MISSING) -> int:
        v = self._get(key, default)
        return v if v is default and default is not Config._MISSING else int(v)

    def get_float(self, key: str, default: Any = _MISSING) -> float:
        v = self._get(key, default)
        return v if v is default and default is not Config._MISSING else float(v)

    def get_bool(self, key: str, default: Any = _MISSING) -> bool:
        v = self._get(key, default)
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            if v.lower() in ("true", "yes", "on"):
                return True
            if v.lower() in ("false", "no", "off"):
                return False
        if v is default:
            return v
        raise ValueError(f"config key {key!r} is not a bool: {v!r}")

    def get_string(self, key: str, default: Any = _MISSING) -> str:
        v = self._get(key, default)
        return v if v is default and default is not Config._MISSING else str(v)

    def get_list(self, key: str, default: Any = _MISSING) -> list:
        return self._get(key, default)


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    out = []
    in_quote: str | None = None
    i = 0
    while i < len(line):
        ch = line[i]
        if in_quote:
            out.append(ch)
            if ch == in_quote:
                in_quote = None
            i += 1
            continue
        if ch in ("'", '"'):
            in_quote = ch
            out.append(ch)
            i += 1
            continue
        if ch == "#":
            break
        if ch == "/" and i + 1 < len(line) and line[i + 1] == "/":
            # `//` opens a comment only at line start or after whitespace,
            # so unquoted paths containing `//` survive.
            if i == 0 or line[i - 1].isspace():
                break
        out.append(ch)
        i += 1
    return "".join(out).rstrip()


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok and tok[0] in ("'", '"') and tok[-1] == tok[0] and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    try:
        i = int(tok)
        # values with leading zeros (e.g. the path component `00`) must stay
        # strings; only canonical integer spellings become ints
        if str(i) == tok or (tok.startswith("+") and str(i) == tok[1:]):
            return i
        return tok
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _split_list_items(body: str) -> list:
    items = [s.strip() for s in body.split(",")]
    return [_parse_scalar(s) for s in items if s]


class _Parser:
    def __init__(self, text: str):
        # Flatten to a single cleaned character stream per line for a simple
        # line-oriented recursive parse.
        self.lines = [_strip_comment(ln) for ln in text.splitlines()]
        self.pos = 0

    def parse(self) -> dict:
        root: dict = {}
        self._parse_object_body(root, top=True)
        return root

    def _next_nonempty(self) -> str | None:
        while self.pos < len(self.lines):
            line = self.lines[self.pos].strip()
            self.pos += 1
            if line:
                return line
        return None

    def _parse_object_body(self, obj: dict, top: bool = False) -> None:
        while True:
            line = self._next_nonempty()
            if line is None:
                if not top:
                    raise ValueError("unexpected end of config inside object")
                return
            if line == "}":
                if top:
                    raise ValueError("unbalanced '}' in config")
                return
            self._parse_entry(line, obj)

    def _parse_entry(self, line: str, obj: dict) -> None:
        # object opener: `name {`  (possibly `name = {` / `name: {`)
        if line.endswith("{"):
            key = line[:-1].rstrip().rstrip("=:").strip()
            child = obj.setdefault(key, {})
            self._parse_object_body(child)
            return

        # single-line object: `name { key = v ... }` — requeue the body and
        # closer as synthetic lines so the normal object path handles it
        brace = line.find("{")
        if brace >= 0 and line.rstrip().endswith("}") and "=" not in line[:brace] and ":" not in line[:brace]:
            key = line[:brace].rstrip().rstrip("=:").strip()
            body = line[brace + 1 :].rstrip()
            body = body[: body.rfind("}")]
            self.lines[self.pos : self.pos] = [body, "}"]
            child = obj.setdefault(key, {})
            self._parse_object_body(child)
            return

        # key/value split on first `=` or `:` outside quotes
        sep_idx = -1
        for i, ch in enumerate(line):
            if ch in "=:":
                sep_idx = i
                break
        if sep_idx < 0:
            raise ValueError(f"cannot parse config line: {line!r}")
        key = line[:sep_idx].strip()
        value = line[sep_idx + 1 :].strip()

        # several comma-separated assignments on one line
        # (`D = 2, W = 64, ...`) — split at top-level commas and recurse
        if "=" in value and not value.startswith("["):
            parts, depth, cur = [], 0, []
            for ch in line:
                if ch in "[{":
                    depth += 1
                elif ch in "]}":
                    depth -= 1
                if ch == "," and depth == 0:
                    parts.append("".join(cur))
                    cur = []
                else:
                    cur.append(ch)
            parts.append("".join(cur))
            if len(parts) > 1:
                for part in parts:
                    part = part.strip()
                    if part:
                        self._parse_entry(part, obj)
                return

        if value.startswith("["):
            body = value[1:]
            while "]" not in body:
                nxt = self._next_nonempty()
                if nxt is None:
                    raise ValueError("unterminated list in config")
                body += " " + nxt
            body, _, rest = body.partition("]")
            obj[key] = _split_list_items(body)
            rest = rest.strip().lstrip(",").strip()
            if rest:  # more assignments after the list on the same line
                self._parse_entry(rest, obj)
            return

        value = value.rstrip(",").strip()
        obj[key] = _parse_scalar(value)


def parse_string(text: str) -> Config:
    return Config(_Parser(text).parse())


def load_conf(
    path: str,
    case: str = "",
    img_dir: str = "image",
    npz_postfix: str = "",
) -> Config:
    """Load a .conf with the reference's raw-text template substitution.

    Mirrors reference dpt_runner.py:28-36: ``CASE_NAME`` / ``IMG_DIR`` /
    ``TYPE`` are replaced in the raw text before parsing.
    """
    with open(path) as f:
        text = f.read()
    text = text.replace("CASE_NAME", case)
    text = text.replace("IMG_DIR", img_dir)
    text = text.replace("TYPE", npz_postfix)
    return parse_string(text)
