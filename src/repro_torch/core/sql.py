"""SQL subset parser: text -> logical plan.

Covers the full surface of the paper's six query templates (Fig. 2), parsed
verbatim: SELECT lists with aliases, FROM table/aliased-subquery, JOIN ... ON,
WHERE conjunctions/disjunctions, DISTANCE(a, b), ``${param}`` placeholders,
RANK() OVER (PARTITION BY ... ORDER BY ...), ORDER BY, LIMIT.

This is a hand-written recursive-descent parser (the production analogue of
LingoDB's SQL frontend) — deliberately small but real: the benchmark queries in
:mod:`benchmarks` are authored as SQL strings, not pre-built plans.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from .expr import (Arith, BoolOp, Cmp, Column, Const, Distance, Expr, Param)
from .plan import (Filter, Join, Limit, OrderBy, PlanNode, Project, Scan,
                   WindowRank)

_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+)
    | (?P<param>\$\{\s*[A-Za-z_][A-Za-z0-9_]*\s*\})
    | (?P<number>\d+\.\d+|\.\d+|\d+)
    | (?P<string>'(?:[^']|'')*')
    | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op><>|<=|>=|!=|=|<|>)
    | (?P<punct>[(),.*])
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "where", "and", "or", "not", "order", "by", "limit",
    "join", "on", "as", "rank", "over", "partition", "distance", "asc", "desc",
    "inner",
}


@dataclasses.dataclass
class Token:
    """One lexeme: (kind, text, source position)."""
    kind: str
    text: str
    pos: int


def tokenize(sql: str) -> list[Token]:
    """Lex ``sql`` into tokens (keywords lower-cased, whitespace dropped)."""
    out: list[Token] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SyntaxError(f"bad character at {i}: {sql[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "name" and text.lower() in KEYWORDS:
            kind = "kw"
            text = text.lower()
        out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


@dataclasses.dataclass
class SelectItem:
    """One SELECT-list entry (expression, window item, or ``*``)."""
    expr: Expr | None       # None for window items (handled specially) or '*'
    alias: str | None
    window: Optional["WindowSpec"] = None
    star: bool = False


@dataclasses.dataclass
class WindowSpec:
    """RANK() OVER (PARTITION BY ... ORDER BY ...) clause body."""
    partition_by: list[Expr]
    order_by: Expr


class Parser:
    """Recursive-descent parser for the hybrid-query SQL template surface."""

    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token plumbing ------------------------------------------------------
    def peek(self, off: int = 0) -> Token:
        """Look ahead ``off`` tokens without consuming."""
        return self.toks[min(self.i + off, len(self.toks) - 1)]

    def next(self) -> Token:
        """Consume and return the current token."""
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, text: str | None = None) -> Token | None:
        """Consume the current token iff it matches; None otherwise."""
        t = self.peek()
        if t.kind == kind and (text is None or t.text == text):
            return self.next()
        return None

    def expect(self, kind: str, text: str | None = None) -> Token:
        """Consume a required token or raise SyntaxError."""
        t = self.accept(kind, text)
        if t is None:
            got = self.peek()
            raise SyntaxError(f"expected {text or kind}, got {got.text!r} at {got.pos}")
        return t

    def parse_alias(self) -> str:
        """An alias name (permits the ``rank`` keyword as a name)."""
        t = self.peek()
        if t.kind == "name" or (t.kind == "kw" and t.text in ("rank",)):
            return self.next().text
        raise SyntaxError(f"expected alias, got {t.text!r} at {t.pos}")

    # -- entry ---------------------------------------------------------------
    def parse(self) -> PlanNode:
        """Parse a full statement to a logical plan (must consume all input)."""
        plan = self.parse_select()
        self.expect("eof")
        return plan

    def parse_select(self) -> PlanNode:
        """SELECT ... FROM ... [WHERE] [ORDER BY] [LIMIT] -> plan tree."""
        self.expect("kw", "select")
        items = [self.parse_select_item()]
        while self.accept("punct", ","):
            items.append(self.parse_select_item())

        self.expect("kw", "from")
        plan = self.parse_from_item()
        while self.peek().kind == "kw" and self.peek().text in ("join", "inner"):
            if self.accept("kw", "inner"):
                pass
            self.expect("kw", "join")
            right = self.parse_from_item()
            cond = None
            if self.accept("kw", "on"):
                cond = self.parse_expr()
            plan = Join(plan, right, cond)

        if self.accept("kw", "where"):
            plan = Filter(plan, self.parse_expr())

        # window items become WindowRank nodes above the filtered input
        for it in items:
            if it.window is not None:
                plan = WindowRank(plan, tuple(it.window.partition_by),
                                  it.window.order_by, it.alias or "rank")

        if self.accept("kw", "order"):
            self.expect("kw", "by")
            key = self.parse_expr()
            if self.accept("kw", "desc"):
                key = Arith("*", Const(-1), key)
            else:
                self.accept("kw", "asc")
            plan = OrderBy(plan, key)

        if self.accept("kw", "limit"):
            t = self.peek()
            if t.kind == "number":
                self.next()
                plan = Limit(plan, int(t.text))
            elif t.kind == "param":
                self.next()
                plan = Limit(plan, _param_name(t.text))
            else:
                raise SyntaxError(f"bad LIMIT at {t.pos}")

        outs = []
        star = False
        for it in items:
            if it.star:
                star = True
            elif it.window is None:
                name = it.alias or _default_name(it.expr)
                outs.append((name, it.expr))
            else:
                outs.append((it.alias or "rank", Column(it.alias or "rank")))
        if not star:
            plan = Project(plan, tuple(outs))
        return plan

    def parse_from_item(self) -> PlanNode:
        """A FROM item: table (with alias) or parenthesized subquery."""
        if self.accept("punct", "("):
            sub = self.parse_select()
            self.expect("punct", ")")
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect("name").text
            elif self.peek().kind == "name":
                alias = self.next().text
            return _Aliased(sub, alias) if alias else sub
        t = self.expect("name")
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("name").text
        elif self.peek().kind == "name":
            alias = self.next().text
        return Scan(t.text, alias or t.text)

    def parse_select_item(self) -> SelectItem:
        """A SELECT-list item: ``*``, RANK() OVER (...), or expression."""
        if self.accept("punct", "*"):
            return SelectItem(None, None, star=True)
        # RANK() OVER (...)
        if self.peek().kind == "kw" and self.peek().text == "rank" \
                and self.peek(1).text == "(":
            self.next()
            self.expect("punct", "(")
            self.expect("punct", ")")
            self.expect("kw", "over")
            self.expect("punct", "(")
            parts: list[Expr] = []
            if self.accept("kw", "partition"):
                self.expect("kw", "by")
                parts.append(self.parse_expr())
                while self.accept("punct", ","):
                    parts.append(self.parse_expr())
            self.expect("kw", "order")
            self.expect("kw", "by")
            order = self.parse_expr()
            self.expect("punct", ")")
            alias = None
            if self.accept("kw", "as"):
                alias = self.parse_alias()
            return SelectItem(None, alias, window=WindowSpec(parts, order))
        e = self.parse_expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.parse_alias()
        return SelectItem(e, alias)

    # -- expressions (precedence: or < and < not < cmp < add < mul < unary) --
    def parse_expr(self) -> Expr:
        """An expression at the lowest precedence level (OR)."""
        return self.parse_or()

    def parse_or(self) -> Expr:
        """Left-associative OR chain."""
        e = self.parse_and()
        while self.accept("kw", "or"):
            e = BoolOp("or", (e, self.parse_and()))
        return e

    def parse_and(self) -> Expr:
        """Left-associative AND chain."""
        e = self.parse_not()
        while self.accept("kw", "and"):
            e = BoolOp("and", (e, self.parse_not()))
        return e

    def parse_not(self) -> Expr:
        """Prefix NOT (right-associative)."""
        if self.accept("kw", "not"):
            return BoolOp("not", (self.parse_not(),))
        return self.parse_cmp()

    def parse_cmp(self) -> Expr:
        """A comparison (non-associative) over additive operands."""
        e = self.parse_add()
        t = self.peek()
        if t.kind == "op":
            self.next()
            op = "<>" if t.text == "!=" else t.text
            return Cmp(op, e, self.parse_add())
        return e

    def parse_add(self) -> Expr:
        """Additive level (template surface: passthrough to unary)."""
        # The template surface needs no arithmetic beyond DESC negation
        # (built internally); extendable here if required.
        return self.parse_unary()

    def parse_unary(self) -> Expr:
        """Atoms: parens, literals, params, DISTANCE(...), columns."""
        t = self.peek()
        if t.kind == "punct" and t.text == "(":
            self.next()
            e = self.parse_expr()
            self.expect("punct", ")")
            return e
        if t.kind == "number":
            self.next()
            return Const(float(t.text) if "." in t.text else int(t.text))
        if t.kind == "string":
            self.next()
            return Const(t.text[1:-1].replace("''", "'"))
        if t.kind == "param":
            self.next()
            return Param(_param_name(t.text))
        if t.kind == "kw" and t.text == "distance":
            self.next()
            self.expect("punct", "(")
            a = self.parse_expr()
            self.expect("punct", ",")
            b = self.parse_expr()
            self.expect("punct", ")")
            return Distance(a, b)
        if t.kind == "name":
            self.next()
            if self.accept("punct", "."):
                f = self.peek()
                if f.kind == "name" or (f.kind == "kw" and f.text in ("rank",)):
                    self.next()
                    return Column(f.text, table=t.text)
                raise SyntaxError(f"expected field name at {f.pos}")
            return Column(t.text)
        if t.kind == "kw" and t.text == "rank":
            # bare reference to a rank alias outside window syntax
            self.next()
            return Column("rank")
        raise SyntaxError(f"unexpected token {t.text!r} at {t.pos}")


@dataclasses.dataclass(frozen=True, eq=False)
class _Aliased(PlanNode):
    """FROM (subquery) AS alias — transparent wrapper kept for qualification."""
    child: PlanNode
    alias: str

    def children(self):
        return (self.child,)

    def label(self):
        return f"Aliased[{self.alias}]"


def _param_name(text: str) -> str:
    return text.strip()[2:-1].strip()


def _default_name(e: Expr) -> str:
    if isinstance(e, Column):
        return e.name
    return "expr"


def parse_sql(sql: str) -> PlanNode:
    """Parse a SQL string into the initial (pre-rewrite) logical plan."""
    return Parser(sql).parse()
