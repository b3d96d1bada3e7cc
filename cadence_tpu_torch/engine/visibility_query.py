"""Visibility query language: filtered List/Scan/Count.

Reference: advanced visibility routes SQL-ish query strings to
Elasticsearch (workflowHandler.go:2837-3322 ListWorkflowExecutions with
`query`; common/elasticsearch/esql translates them). Here the same query
surface compiles to a predicate evaluated over the visibility store's
records — a recursive-descent parser for

    expr       := term ("OR" term)*
    term       := factor ("AND" factor)*
    factor     := "(" expr ")" | comparison
    comparison := field op value
    op         := = | != | < | <= | > | >=
    value      := number | 'string' | "string"

Fields: the built-in columns WorkflowID, WorkflowType, RunID, CloseStatus
(numeric or a CloseStatus name), StartTime, CloseTime — plus ANY custom
search-attribute key (UpsertWorkflowSearchAttributes decision), exactly
the split the reference indexes into ES.

The parser produces an AST (Cmp/And/Or) first, and the host predicate is
compiled FROM the AST — the same tree the device visibility tier
(engine/visibility_device.py) compiles into vectorized column-mask
kernels, so the two evaluators can never drift on the grammar.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

from ..core.enums import CloseStatus
from .persistence import VisibilityRecord


class QueryParseError(Exception):
    """Malformed visibility query (BadRequestError in the reference)."""


_TOKEN = re.compile(r"""\s*(?:
    (?P<lparen>\() | (?P<rparen>\)) |
    (?P<op><=|>=|!=|=|<|>) |
    (?P<num>-?\d+(?:\.\d+)?) |
    '(?P<sq>[^']*)' | "(?P<dq>[^"]*)" |
    (?P<word>[A-Za-z_][A-Za-z0-9_.-]*)
)""", re.VERBOSE)


def _tokenize(query: str) -> List[Tuple[str, str]]:
    tokens, pos = [], 0
    while pos < len(query):
        m = _TOKEN.match(query, pos)
        if m is None or m.end() == pos:
            if query[pos:].strip():
                raise QueryParseError(f"bad token at: {query[pos:]!r}")
            break
        pos = m.end()
        for kind in ("lparen", "rparen", "op", "num", "sq", "dq", "word"):
            val = m.group(kind)
            if val is not None:
                if kind == "word" and val.upper() in ("AND", "OR"):
                    tokens.append(("bool", val.upper()))
                elif kind in ("sq", "dq"):
                    tokens.append(("str", val))
                else:
                    tokens.append((kind, val))
                break
    return tokens


# -- AST --------------------------------------------------------------------
# The parse result both evaluators consume: the host predicate below and
# the device mask compiler (ops/scan.py compile_ast). Value-typed and
# hashable, so a query's STRUCTURE (shape + fields + ops, values
# excluded) can key compiled kernel variants.


@dataclass(frozen=True)
class Cmp:
    """One comparison leaf: `field op value` (value already normalized —
    CloseStatus names resolved to their numeric code)."""

    field: str
    op: str
    value: object


@dataclass(frozen=True)
class And:
    left: "Node"
    right: "Node"


@dataclass(frozen=True)
class Or:
    left: "Node"
    right: "Node"


Node = Union[Cmp, And, Or]


_BUILTINS = {
    "workflowid": lambda r: r.workflow_id,
    "workflowtype": lambda r: r.workflow_type,
    "runid": lambda r: r.run_id,
    "closestatus": lambda r: r.close_status,
    "starttime": lambda r: r.start_time,
    "closetime": lambda r: r.close_time,
}


def _field_value(rec: VisibilityRecord, field: str):
    getter = _BUILTINS.get(field.lower())
    if getter is not None:
        return getter(rec)
    v = rec.search_attrs.get(field)
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


_OPS: dict = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]) -> None:
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def take(self) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise QueryParseError("unexpected end of query")
        self.pos += 1
        return tok

    def parse(self) -> Node:
        node, self.hints = self.expr()
        if self.peek() is not None:
            raise QueryParseError(f"trailing tokens: {self.tokens[self.pos:]}")
        return node

    # Each production returns (node, hints): hints is a {field: value}
    # dict of EQUALITY constraints every matching record must satisfy —
    # AND merges them, OR discards (a disjunction guarantees nothing).
    # The store's query planner intersects index sets from these before
    # evaluating the predicate (the esql → index-lookup split).

    def expr(self):
        left, hints = self.term()
        while self.peek() == ("bool", "OR"):
            self.take()
            right, _ = self.term()
            left = Or(left, right)
            hints = {}
        return left, hints

    def term(self):
        left, hints = self.factor()
        while self.peek() == ("bool", "AND"):
            self.take()
            right, rhints = self.factor()
            left = And(left, right)
            hints = {**hints, **rhints}
        return left, hints

    def factor(self):
        kind, val = self.take()
        if kind == "lparen":
            inner = self.expr()
            if self.take()[0] != "rparen":
                raise QueryParseError("unbalanced parentheses")
            return inner
        if kind != "word":
            raise QueryParseError(f"expected a field name, got {val!r}")
        field = val
        op_kind, op = self.take()
        if op_kind != "op":
            raise QueryParseError(f"expected an operator after {field!r}")
        vkind, raw = self.take()
        if vkind == "num":
            value: object = float(raw) if "." in raw else int(raw)
        elif vkind == "str":
            value = raw
            if field.lower() == "closestatus":
                try:
                    value = int(CloseStatus[raw])
                except KeyError:
                    raise QueryParseError(
                        f"unknown CloseStatus {raw!r} "
                        f"(one of {[s.name for s in CloseStatus]})")
        else:
            raise QueryParseError(f"expected a value, got {raw!r}")
        hints = {field.lower(): value} if op == "=" else {}
        return Cmp(field, op, value), hints


def eval_node(node: Node, rec: VisibilityRecord) -> bool:
    """Evaluate the AST against one record — the reference host
    semantics both tiers are gated on: a missing field never matches,
    and a cross-type ordering comparison (TypeError) never matches."""
    if isinstance(node, And):
        return eval_node(node.left, rec) and eval_node(node.right, rec)
    if isinstance(node, Or):
        return eval_node(node.left, rec) or eval_node(node.right, rec)
    actual = _field_value(rec, node.field)
    if actual is None:
        return False
    try:
        return _OPS[node.op](actual, node.value)
    except TypeError:
        return False


def parse_query(query: str) -> Tuple[Optional[Node], dict]:
    """(AST, equality-hints) for a query string; (None, {}) for the
    empty match-all query."""
    tokens = _tokenize(query)
    if not tokens:
        return None, {}
    parser = _Parser(tokens)
    node = parser.parse()
    return node, parser.hints


def compile_query(query: str) -> Callable[[VisibilityRecord], bool]:
    """Compile a visibility query string into a record predicate."""
    pred, _ = compile_query_with_hints(query)
    return pred


def compile_query_with_hints(query: str):
    """(predicate, equality-hints): hints map lowercased field names to
    values every matching record must carry — the store intersects its
    (type, status) indexes from them before evaluating the predicate."""
    node, hints = parse_query(query)
    if node is None:
        return (lambda rec: True), {}
    return (lambda rec: eval_node(node, rec)), hints
