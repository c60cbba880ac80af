"""Metadata filter DSL: parse + evaluate.

Same grammar and semantics as the reference (`src/index/filter.rs:41-439`):

  Simple:      source:*.rs   type=code    lines>50
  AND:         type=code,lines>50   or   "type=code AND lines>50"
  OR:          type=code OR type=text      (OR binds looser than AND)
  In/NotIn:    type in [code,text]   type not_in [code]
  Contains:    source~keyword   or   source:*keyword*
  StartsWith:  source^prefix    or   source:prefix*
  EndsWith:    source$suffix    or   source:*suffix
  Exists:      field?

Values coerce to int -> float -> bool -> string; field paths may be
dotted for nested metadata; comparisons are numeric when both sides
parse as numbers, else lexicographic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Union


@dataclass
class Condition:
    field: str
    op: str  # eq ne gt gte lt lte in not_in contains starts_with ends_with exists
    value: Any


@dataclass
class And:
    parts: List["MetadataFilter"]


@dataclass
class Or:
    parts: List["MetadataFilter"]


FilterNode = Union[Condition, And, Or]


def _parse_value(s: str) -> Any:
    s = s.strip()
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s == "true":
        return True
    if s == "false":
        return False
    return s


def _split_commas_outside_brackets(s: str) -> List[str]:
    parts, cur, depth = [], [], 0
    for ch in s:
        if ch == "[":
            depth += 1
            cur.append(ch)
        elif ch == "]":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


class MetadataFilter:
    def __init__(self, node: FilterNode, source: Optional[str] = None):
        self.node = node
        # original DSL text when parsed; lets callers (the server's
        # micro-batcher) group requests by identical filters cheaply
        self.source = source

    # ---------------- parsing ----------------

    @staticmethod
    def parse(filter_str: str) -> Optional["MetadataFilter"]:
        node = MetadataFilter._parse(filter_str.strip())
        if node is None:
            return None
        return MetadataFilter(node, source=filter_str.strip())

    @staticmethod
    def _parse(s: str) -> Optional[FilterNode]:
        s = s.strip()
        if not s:
            return None
        if " OR " in s:
            parts = [MetadataFilter._parse(p) for p in s.split(" OR ")]
            parts = [p for p in parts if p is not None]
            if len(parts) > 1:
                return Or(parts)  # type: ignore[arg-type]
            return parts[0] if parts else None

        has_and = " AND " in s
        comma_parts = _split_commas_outside_brackets(s)
        if has_and or len(comma_parts) > 1:
            raw = s.split(" AND ") if has_and else comma_parts
            parts = [MetadataFilter._parse_single(p.strip()) for p in raw]
            parts = [p for p in parts if p is not None]
            if len(parts) > 1:
                return And(parts)  # type: ignore[arg-type]
            return parts[0] if parts else None

        return MetadataFilter._parse_single(s)

    @staticmethod
    def _parse_single(s: str) -> Optional[Condition]:
        s = s.strip()
        if not s:
            return None
        if s.endswith("?"):
            return Condition(s[:-1], "exists", None)

        for kw, op in ((" in [", "in"), (" not_in [", "not_in")):
            idx = s.find(kw)
            if idx != -1:
                rest = s[idx + len(kw):]
                end = rest.find("]")
                if end != -1:
                    values = [_parse_value(v) for v in rest[:end].split(",")]
                    return Condition(s[:idx].strip(), op, values)

        if "~" in s:
            f, v = s.split("~", 1)
            return Condition(f, "contains", v)
        if "^" in s and ">=" not in s:
            f, v = s.split("^", 1)
            return Condition(f, "starts_with", v)
        if "$" in s:
            f, v = s.split("$", 1)
            return Condition(f, "ends_with", v)

        for sym, op in (("!=", "ne"), (">=", "gte"), ("<=", "lte"), (">", "gt"), ("<", "lt")):
            if sym in s:
                f, v = s.split(sym, 1)
                return Condition(f, op, _parse_value(v))

        if "=" in s:
            f, v = s.split("=", 1)
        elif ":" in s:
            f, v = s.split(":", 1)
        else:
            return None

        # Glob sugar on the value side.
        if "*" in v:
            if v.startswith("*") and v.endswith("*") and len(v) > 2:
                return Condition(f, "contains", v[1:-1])
            if v.startswith("*"):
                return Condition(f, "ends_with", v[1:])
            if v.endswith("*"):
                return Condition(f, "starts_with", v[:-1])
        return Condition(f, "eq", _parse_value(v))

    # ---------------- evaluation ----------------

    def matches(self, metadata: Any) -> bool:
        return self._matches(self.node, metadata)

    @staticmethod
    def _matches(node: FilterNode, metadata: Any) -> bool:
        if isinstance(node, And):
            return all(MetadataFilter._matches(p.node if isinstance(p, MetadataFilter) else p, metadata) for p in node.parts)
        if isinstance(node, Or):
            return any(MetadataFilter._matches(p.node if isinstance(p, MetadataFilter) else p, metadata) for p in node.parts)
        return _cond_matches(node, metadata)


def _get_nested(metadata: Any, path: str) -> Any:
    cur = metadata
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return _MISSING
    return cur


_MISSING = object()


def _values_equal(a: Any, b: Any) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return abs(float(a) - float(b)) < 1e-12
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if a is None and b is None:
        return True
    return False


def _as_float(v: Any) -> Optional[float]:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


def _compare(a: Any, b: Any) -> Optional[int]:
    fa, fb = _as_float(a), _as_float(b)
    if fa is not None and fb is not None:
        return -1 if fa < fb else (1 if fa > fb else 0)
    if isinstance(a, str) and isinstance(b, str):
        return -1 if a < b else (1 if a > b else 0)
    return None


def _cond_matches(cond: Condition, metadata: Any) -> bool:
    v = _get_nested(metadata, cond.field)
    present = v is not _MISSING
    op = cond.op
    if op == "exists":
        return present
    if op == "eq":
        return present and _values_equal(v, cond.value)
    if op == "ne":
        return (not present) or not _values_equal(v, cond.value)
    if op in ("gt", "gte", "lt", "lte"):
        if not present:
            return False
        c = _compare(v, cond.value)
        if c is None:
            return False
        return {"gt": c > 0, "gte": c >= 0, "lt": c < 0, "lte": c <= 0}[op]
    if op == "in":
        return present and any(_values_equal(v, item) for item in cond.value)
    if op == "not_in":
        return (not present) or not any(_values_equal(v, item) for item in cond.value)
    if op in ("contains", "starts_with", "ends_with"):
        if not present or not isinstance(v, str):
            return False
        pat = cond.value if isinstance(cond.value, str) else str(cond.value)
        if op == "contains":
            return pat in v
        if op == "starts_with":
            return v.startswith(pat)
        return v.endswith(pat)
    return False
