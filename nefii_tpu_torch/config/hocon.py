"""Minimal HOCON-subset parser + ConfigTree (the port's copy of
nefii_tpu/config/hocon.py, so that the port imports nothing of the JAX
package).

The reference framework configures everything through pyhocon `.conf` files
(its confs_sg/conf.conf, read by training/idr_train.py:42). This parser
covers the subset of HOCON that the NeFII config schema uses, without
pyhocon:

  - `section { ... }` blocks (brace on same or next line), arbitrarily nested
  - `key = value` / `key : value` assignments
  - `#` and `//` comments (full-line and trailing)
  - scalars: int, float (incl. scientific notation), true/false/True/False,
    null/None, quoted and unquoted strings
  - lists: `[ 512, 512 ]`, possibly spanning multiple lines
  - later duplicate keys override earlier ones; duplicate sections merge

The resulting `ConfigTree` mirrors the pyhocon API surface the reference code
relies on: `get_config`, `get_string`, `get_int`, `get_float`, `get_bool`,
`get_list`, `get(key, default)`, dotted-path lookup, and dict-style access.
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Optional


class ConfigMissingError(KeyError):
    pass


class ConfigTree(dict):
    """dict with typed getters and dotted-path access (pyhocon-compatible)."""

    def _resolve(self, key: str, default: Any = ...) -> Any:
        node: Any = self
        for part in key.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                if default is ...:
                    raise ConfigMissingError(f"missing config key: {key!r}")
                return default
        return node

    # pyhocon API surface -------------------------------------------------
    def get(self, key: str, default: Any = ...) -> Any:  # type: ignore[override]
        return self._resolve(key, default)

    def get_config(self, key: str, default: Any = ...) -> "ConfigTree":
        val = self._resolve(key, default)
        if val is default and val is not ...:
            return val
        if not isinstance(val, ConfigTree):
            raise TypeError(f"config key {key!r} is not a section: {val!r}")
        return val

    def get_string(self, key: str, default: Any = ...) -> str:
        val = self._resolve(key, default)
        return val if val is default else str(val)

    def get_int(self, key: str, default: Any = ...) -> int:
        val = self._resolve(key, default)
        return val if val is default else int(val)

    def get_float(self, key: str, default: Any = ...) -> float:
        val = self._resolve(key, default)
        return val if val is default else float(val)

    def get_bool(self, key: str, default: Any = ...) -> bool:
        val = self._resolve(key, default)
        if isinstance(val, bool):
            return val
        if isinstance(val, str):
            low = val.strip().lower()
            if low in ("true", "yes", "on", "1"):
                return True
            if low in ("false", "no", "off", "0"):
                return False
        if isinstance(val, (int, float)):
            return bool(val)
        if val is default:
            return val
        raise TypeError(f"config key {key!r} is not a bool: {val!r}")

    def get_list(self, key: str, default: Any = ...) -> List[Any]:
        val = self._resolve(key, default)
        if val is default or isinstance(val, list):
            return val
        raise TypeError(f"config key {key!r} is not a list: {val!r}")

    def put(self, key: str, value: Any) -> None:
        """Set a (possibly dotted) key, creating intermediate sections."""
        parts = key.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.setdefault(part, ConfigTree())
            if not isinstance(nxt, ConfigTree):
                nxt = ConfigTree()
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value

    def merge(self, other: Dict[str, Any]) -> "ConfigTree":
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k, None), ConfigTree):
                self[k].merge(v)
            else:
                self[k] = _wrap(v)
        return self

    def as_plain_dict(self) -> Dict[str, Any]:
        return {
            k: (v.as_plain_dict() if isinstance(v, ConfigTree) else v)
            for k, v in self.items()
        }

    def copy(self) -> "ConfigTree":  # type: ignore[override]
        out = ConfigTree()
        out.merge(self)
        return out


def _wrap(v: Any) -> Any:
    if isinstance(v, ConfigTree):
        return v
    if isinstance(v, dict):
        t = ConfigTree()
        for k, vv in v.items():
            t[k] = _wrap(vv)
        return t
    return v


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

def _strip_comment(line: str) -> str:
    """Remove trailing #/// comments, respecting quoted strings."""
    out = []
    in_str: Optional[str] = None
    i = 0
    while i < len(line):
        c = line[i]
        if in_str:
            out.append(c)
            if c == in_str:
                in_str = None
        elif c in ("'", '"'):
            in_str = c
            out.append(c)
        elif c == "#":
            break
        elif c == "/" and i + 1 < len(line) and line[i + 1] == "/":
            break
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] in "'\"" and tok[-1] == tok[0]:
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _parse_list(text: str) -> List[Any]:
    body = text.strip()
    assert body.startswith("[") and body.endswith("]"), body
    body = body[1:-1].strip()
    if not body:
        return []
    items, depth, cur = [], 0, []
    for c in body:
        if c == "[":
            depth += 1
            cur.append(c)
        elif c == "]":
            depth -= 1
            cur.append(c)
        elif c == "," and depth == 0:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        items.append("".join(cur))
    out: List[Any] = []
    for item in items:
        item = item.strip()
        if not item:
            continue
        out.append(_parse_list(item) if item.startswith("[") else _parse_scalar(item))
    return out


def _tokenize(text: str) -> List[str]:
    """Split into logical lines with structural braces as standalone tokens.

    Braces never appear inside the values this schema uses (scalars and
    numeric/string lists), so splitting on them outside quotes is safe.
    """
    tokens: List[str] = []
    for raw in io.StringIO(text).read().splitlines():
        line = _strip_comment(raw)
        cur: List[str] = []
        in_str: Optional[str] = None
        for c in line:
            if in_str:
                cur.append(c)
                if c == in_str:
                    in_str = None
            elif c in ("'", '"'):
                in_str = c
                cur.append(c)
            elif c in "{}":
                if "".join(cur).strip():
                    tokens.append("".join(cur).strip())
                cur = []
                tokens.append(c)
            else:
                cur.append(c)
        if "".join(cur).strip():
            tokens.append("".join(cur).strip())
    return tokens


def parse_string(text: str) -> ConfigTree:
    tokens = _tokenize(text)
    root = ConfigTree()
    stack: List[ConfigTree] = [root]
    i = 0
    n = len(tokens)

    def open_section(key: str) -> None:
        child = stack[-1].get(key, None)
        if not isinstance(child, ConfigTree):
            child = ConfigTree()
            stack[-1].put(key, child)
        stack.append(child)

    while i < n:
        tok = tokens[i]
        i += 1
        if tok == "}":
            if len(stack) == 1:
                raise ValueError("unbalanced '}' in config")
            stack.pop()
            continue
        if tok == "{":
            raise ValueError("'{' without a section name")

        sep = len(tok)
        for j, c in enumerate(tok):
            if c in "=:":
                sep = j
                break
        key = tok[:sep].strip()
        rest = tok[sep + 1 :].strip() if sep < len(tok) else ""

        if sep == len(tok):
            # bare name: must be a section with `{` as the next token
            if i < n and tokens[i] == "{":
                i += 1
                open_section(key)
                continue
            raise ValueError(f"cannot parse config token: {tok!r}")

        if not rest:
            # `key = {` object syntax
            if i < n and tokens[i] == "{":
                i += 1
                open_section(key)
                continue
            raise ValueError(f"missing value for key {key!r}")

        # value may be a multi-line list (bracket counting across tokens)
        if rest.startswith("[") and rest.count("[") > rest.count("]"):
            parts = [rest]
            while i < n and "".join(parts).count("[") > "".join(parts).count("]"):
                parts.append(tokens[i])
                i += 1
            rest = " ".join(parts)

        if rest.startswith("["):
            stack[-1].put(key, _parse_list(rest))
        else:
            stack[-1].put(key, _parse_scalar(rest))

    if len(stack) != 1:
        raise ValueError("unbalanced '{' in config")
    return root


def parse_file(path: str) -> ConfigTree:
    with open(path, "r") as f:
        return parse_string(f.read())


class ConfigFactory:
    """pyhocon-compatible entry point (reference: idr_train.py:42)."""

    parse_file = staticmethod(parse_file)
    parse_string = staticmethod(parse_string)
