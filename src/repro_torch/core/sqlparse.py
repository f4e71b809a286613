"""SQL parser for the paper's OLAP subset (§3.1).

Grammar (case-insensitive keywords):

    query      := SELECT select_item (',' select_item)*
                  FROM table_ref (join_clause)*
                  [WHERE conj] [GROUP BY colref (',' colref)*]
                  [HAVING conj] [ORDER BY order_item (',' order_item)*]
                  [LIMIT int]
    select_item:= expr [[AS] ident]
    join_clause:= [INNER] JOIN table_ref ON colref '=' colref
    table_ref  := ident [[AS] ident]
    conj       := pred (AND pred)*  |  '(' conj ')' (AND ...)*
    pred       := expr cmp expr | expr BETWEEN lit AND lit | expr IN '(' lit,* ')'
                  | expr [NOT] LIKE str
    expr       := term (('+'|'-') term)* ; term := factor (('*'|'/') factor)*
    factor     := lit | colref | agg '(' [DISTINCT] expr ')' | COUNT '(' '*' ')' | '(' expr ')'

Anything outside the subset — window functions (OVER), CTEs (WITH), set ops
(UNION/EXCEPT/INTERSECT), subqueries, OR disjunctions, DISTINCT projections,
outer joins — raises :class:`UnsupportedQuery`; the middleware bypasses the
cache for those, exactly as the paper prescribes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Union

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "join", "inner", "on", "as", "and", "or", "not", "in", "between",
    "distinct", "asc", "desc", "like", "with", "union", "except", "intersect",
    "over", "left", "right", "full", "outer", "cross", "lateral", "recursive",
}
AGG_FUNCS = {"sum", "count", "min", "max", "avg"}
UNSUPPORTED_KEYWORDS = {
    "with", "union", "except", "intersect", "over", "left", "right", "full",
    "outer", "cross", "lateral", "recursive", "or",
}


class SQLSyntaxError(Exception):
    """The text is not valid SQL under our grammar."""


class UnsupportedQuery(Exception):
    """Valid-looking SQL that is outside the §3.1 subset -> cache bypass."""


# ------------------------------------------------------------------ tokenizer

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d+|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*'|"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\.|\*|/|\+|-|;)
    """,
    re.VERBOSE | re.DOTALL,
)


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # 'num' | 'str' | 'ident' | 'kw' | 'op' | 'eof'
    value: str
    pos: int


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SQLSyntaxError(f"unexpected character {sql[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "ident":
            low = val.lower()
            if low in KEYWORDS:
                tokens.append(Token("kw", low, m.start()))
            else:
                tokens.append(Token("ident", low, m.start()))
        elif kind == "str":
            quote = val[0]
            body = val[1:-1].replace(quote * 2, quote)
            tokens.append(Token("str", body, m.start()))
        elif kind == "op" and val == "<>":
            tokens.append(Token("op", "!=", m.start()))
        else:
            tokens.append(Token(kind or "op", val, m.start()))
    tokens.append(Token("eof", "", len(sql)))
    return tokens


# ------------------------------------------------------------------ AST nodes


@dataclasses.dataclass(frozen=True)
class ColRef:
    table: Optional[str]  # alias or table name (lowercased), None if bare
    column: str


@dataclasses.dataclass(frozen=True)
class Literal:
    value: Any  # int | float | str


@dataclasses.dataclass(frozen=True)
class BinOp:
    op: str  # '+', '-', '*', '/'
    left: "Expr"
    right: "Expr"


@dataclasses.dataclass(frozen=True)
class AggCall:
    func: str  # 'SUM' | 'COUNT' | 'MIN' | 'MAX' | 'AVG'
    arg: Optional["Expr"]  # None for COUNT(*)
    distinct: bool = False


Expr = Union[ColRef, Literal, BinOp, AggCall]


@dataclasses.dataclass(frozen=True)
class Slot:
    """Literal placeholder in a template AST (see :func:`parse_slotted`).

    ``index`` addresses the i-th num/str token of the query text (every
    num/str token is consumed as a literal by this grammar, so a sequential
    counter over consumed literal tokens matches token-stream order).
    ``negated`` marks a literal that appeared under a leading unary minus;
    :func:`bind_slots` applies the negation at bind time.
    """

    index: int
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Predicate:
    left: Expr
    op: str  # '=', '!=', '<', '<=', '>', '>=', 'in', 'between'
    right: Any  # Expr | list[Literal] | (Literal, Literal) for between


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str]


@dataclasses.dataclass(frozen=True)
class Join:
    table: str
    alias: str
    left: ColRef
    right: ColRef


@dataclasses.dataclass(frozen=True)
class Query:
    select: tuple[SelectItem, ...]
    table: str
    alias: str
    joins: tuple[Join, ...]
    where: tuple[Predicate, ...]
    group_by: tuple[ColRef, ...]
    having: tuple[Predicate, ...]
    order_by: tuple[tuple[Expr, bool], ...]  # (expr, desc)
    limit: Optional[int]


# -------------------------------------------------------------------- parser


class _Parser:
    def __init__(self, tokens: list[Token], sql: str, slotted: bool = False):
        self.toks = tokens
        self.sql = sql
        self.i = 0
        # slot mode: literal tokens become Slot placeholders instead of
        # converted values (the template-cache cold parse)
        self._slotted = slotted
        self._slot_i = 0

    def _take_slot(self) -> int:
        k = self._slot_i
        self._slot_i += 1
        return k

    # -- token plumbing
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise SQLSyntaxError(
                f"expected {value or kind} at pos {got.pos}, got {got.value!r}"
            )
        return t

    def kw(self, word: str) -> bool:
        return self.accept("kw", word) is not None

    # -- entry
    def parse(self) -> Query:
        if self.peek().kind == "kw" and self.peek().value in UNSUPPORTED_KEYWORDS:
            raise UnsupportedQuery(f"{self.peek().value.upper()} is outside the OLAP subset")
        self.expect("kw", "select")
        if self.kw("distinct"):
            raise UnsupportedQuery("SELECT DISTINCT is outside the OLAP subset")
        select = [self.select_item()]
        while self.accept("op", ","):
            select.append(self.select_item())
        self.expect("kw", "from")
        table, alias = self.table_ref()
        joins: list[Join] = []
        while True:
            if self.peek().kind == "kw" and self.peek().value in (
                "left", "right", "full", "cross", "outer", "lateral",
            ):
                raise UnsupportedQuery(f"{self.peek().value.upper()} JOIN is outside the OLAP subset")
            if self.kw("inner"):
                self.expect("kw", "join")
            elif not self.kw("join"):
                break
            jt, ja = self.table_ref()
            self.expect("kw", "on")
            l = self.colref_only()
            self.expect("op", "=")
            r = self.colref_only()
            joins.append(Join(jt, ja, l, r))
        where: tuple[Predicate, ...] = ()
        if self.kw("where"):
            where = tuple(self.conjunction())
        group_by: list[ColRef] = []
        if self.kw("group"):
            self.expect("kw", "by")
            group_by.append(self.colref_only())
            while self.accept("op", ","):
                group_by.append(self.colref_only())
        having: tuple[Predicate, ...] = ()
        if self.kw("having"):
            having = tuple(self.conjunction())
        order_by: list[tuple[Expr, bool]] = []
        if self.kw("order"):
            self.expect("kw", "by")
            order_by.append(self.order_item())
            while self.accept("op", ","):
                order_by.append(self.order_item())
        limit = None
        if self.kw("limit"):
            tok = self.expect("num")
            # convert even in slot mode so a malformed bound (e.g. LIMIT 5.5)
            # raises identically on the template path and the cold path
            limit = int(tok.value)
            if self._slotted:
                limit = Slot(self._take_slot())
        self.accept("op", ";")
        t = self.peek()
        if t.kind != "eof":
            if t.kind == "kw" and t.value in UNSUPPORTED_KEYWORDS:
                raise UnsupportedQuery(f"{t.value.upper()} is outside the OLAP subset")
            raise SQLSyntaxError(f"trailing input at pos {t.pos}: {t.value!r}")
        return Query(
            select=tuple(select), table=table, alias=alias, joins=tuple(joins),
            where=where, group_by=tuple(group_by), having=having,
            order_by=tuple(order_by), limit=limit,
        )

    # -- pieces
    def table_ref(self) -> tuple[str, str]:
        t = self.expect("ident")
        alias = t.value
        if self.kw("as"):
            alias = self.expect("ident").value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return t.value, alias

    def select_item(self) -> SelectItem:
        e = self.expr()
        alias = None
        if self.kw("as"):
            alias = self.expect("ident").value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return SelectItem(e, alias)

    def order_item(self) -> tuple[Expr, bool]:
        e = self.expr()
        desc = False
        if self.kw("desc"):
            desc = True
        else:
            self.kw("asc")
        return e, desc

    def colref_only(self) -> ColRef:
        e = self.factor()
        if not isinstance(e, ColRef):
            raise SQLSyntaxError(f"expected column reference near pos {self.peek().pos}")
        return e

    def conjunction(self) -> list[Predicate]:
        preds = self.pred_group()
        while self.kw("and"):
            preds.extend(self.pred_group())
        if self.peek().kind == "kw" and self.peek().value == "or":
            raise UnsupportedQuery("OR disjunctions are outside the OLAP subset")
        return preds

    def pred_group(self) -> list[Predicate]:
        # parenthesized conjunction or single predicate; lookahead to tell a
        # paren-group of predicates from a parenthesized arithmetic expr
        if self.peek().kind == "op" and self.peek().value == "(" and self._paren_is_conj():
            self.expect("op", "(")
            preds = self.conjunction()
            self.expect("op", ")")
            return preds
        return [self.predicate()]

    def _paren_is_conj(self) -> bool:
        """Lookahead: does this '(' open a predicate conjunction (vs arithmetic)?"""
        depth = 0
        j = self.i
        while j < len(self.toks):
            t = self.toks[j]
            if t.kind == "op" and t.value == "(":
                depth += 1
            elif t.kind == "op" and t.value == ")":
                depth -= 1
                if depth == 0:
                    return False
            elif depth >= 1 and (
                (t.kind == "op" and t.value in ("=", "!=", "<", "<=", ">", ">="))
                or (t.kind == "kw" and t.value in ("between", "in", "and", "or", "like", "not"))
            ):
                return True
            j += 1
        return False

    def predicate(self) -> Predicate:
        left = self.expr()
        if self.kw("not"):
            if self.peek().kind == "kw" and self.peek().value in ("in", "like", "between"):
                raise UnsupportedQuery("NOT IN / NOT LIKE / NOT BETWEEN is outside the OLAP subset")
            raise SQLSyntaxError("unexpected NOT")
        if self.kw("between"):
            lo = self.literal()
            self.expect("kw", "and")
            hi = self.literal()
            return Predicate(left, "between", (lo, hi))
        if self.kw("in"):
            self.expect("op", "(")
            if self.peek().kind == "kw" and self.peek().value == "select":
                raise UnsupportedQuery("subqueries are outside the OLAP subset")
            vals = [self.literal()]
            while self.accept("op", ","):
                vals.append(self.literal())
            self.expect("op", ")")
            return Predicate(left, "in", vals)
        if self.kw("like"):
            raise UnsupportedQuery("LIKE predicates are outside the OLAP subset")
        for op in ("<=", ">=", "!=", "=", "<", ">"):
            if self.accept("op", op):
                right = self.expr()
                return Predicate(left, op, right)
        t = self.peek()
        raise SQLSyntaxError(f"expected comparison operator at pos {t.pos}, got {t.value!r}")

    def literal(self) -> Literal:
        t = self.peek()
        if t.kind == "num":
            self.next()
            if self._slotted:
                return Literal(Slot(self._take_slot()))
            return Literal(float(t.value) if "." in t.value else int(t.value))
        if t.kind == "str":
            self.next()
            if self._slotted:
                return Literal(Slot(self._take_slot()))
            return Literal(t.value)
        if t.kind == "op" and t.value == "-":
            self.next()
            n = self.expect("num")
            if self._slotted:
                return Literal(Slot(self._take_slot(), negated=True))
            return Literal(-(float(n.value) if "." in n.value else int(n.value)))
        raise SQLSyntaxError(f"expected literal at pos {t.pos}, got {t.value!r}")

    # -- expressions
    def expr(self) -> Expr:
        e = self.term()
        while True:
            if self.accept("op", "+"):
                e = BinOp("+", e, self.term())
            elif self.accept("op", "-"):
                e = BinOp("-", e, self.term())
            else:
                return e

    def term(self) -> Expr:
        e = self.factor()
        while True:
            if self.accept("op", "*"):
                e = BinOp("*", e, self.factor())
            elif self.accept("op", "/"):
                e = BinOp("/", e, self.factor())
            else:
                return e

    def factor(self) -> Expr:
        t = self.peek()
        if t.kind == "num" or t.kind == "str" or (t.kind == "op" and t.value == "-"):
            return self.literal()
        if t.kind == "op" and t.value == "(":
            self.next()
            e = self.expr()
            self.expect("op", ")")
            return e
        if t.kind == "ident":
            name = self.next().value
            if self.peek().kind == "op" and self.peek().value == "(":
                if name not in AGG_FUNCS:
                    raise UnsupportedQuery(f"function {name.upper()!r} is outside the OLAP subset")
                self.next()  # '('
                distinct = self.kw("distinct")
                if self.accept("op", "*"):
                    if name != "count":
                        raise SQLSyntaxError(f"{name.upper()}(*) is invalid")
                    arg = None
                else:
                    arg = self.expr()
                self.expect("op", ")")
                if self.peek().kind == "kw" and self.peek().value == "over":
                    raise UnsupportedQuery("window functions are outside the OLAP subset")
                return AggCall(name.upper(), arg, distinct)
            if self.accept("op", "."):
                col = self.expect("ident").value
                return ColRef(name, col)
            return ColRef(None, name)
        raise SQLSyntaxError(f"unexpected token {t.value!r} at pos {t.pos}")


def parse(sql: str) -> Query:
    """Parse SQL text into a Query AST (raises SQLSyntaxError / UnsupportedQuery)."""
    return _Parser(tokenize(sql), sql).parse()


# ------------------------------------------------------- template extraction

_INT_SLOT, _FLOAT_SLOT, _STR_SLOT = "?i", "?f", "?s"


def template_of(sql: str) -> tuple[tuple, list[Token], tuple]:
    """Tokenize once and split the text into structure and literals: returns
    ``(fingerprint, tokens, literal_values)``.

    The fingerprint is the token stream with each literal token replaced by a
    *typed* placeholder (int-like and float-like numbers are distinguished —
    ``1`` and ``1.5`` parse differently under LIMIT), so two texts share a
    fingerprint iff they differ only in literal values.  Keyword case,
    whitespace, and comments are already normalized away by the tokenizer.
    ``literal_values`` converts each num/str token exactly as the parser's
    ``literal()`` would, in token-stream order — the currency of
    :func:`bind_slots`.
    """
    tokens = tokenize(sql)
    fp: list = []
    values: list = []
    for t in tokens:
        if t.kind == "num":
            if "." in t.value:
                fp.append(_FLOAT_SLOT)
                values.append(float(t.value))
            else:
                fp.append(_INT_SLOT)
                values.append(int(t.value))
        elif t.kind == "str":
            fp.append(_STR_SLOT)
            values.append(t.value)
        else:
            fp.append((t.kind, t.value))
    return tuple(fp), tokens, tuple(values)


def parse_slotted(tokens: list[Token], sql: str) -> Query:
    """Parse a tokenized query into a *template* AST whose literals are
    :class:`Slot` placeholders.  Raises exactly like :func:`parse` — parse
    structure never depends on literal values, only on token kinds, so one
    slotted parse is valid for every text sharing the fingerprint."""
    return _Parser(tokens, sql, slotted=True).parse()


def bind_slots(q: Query, values) -> Query:
    """Substitute concrete literal values into a slotted template AST.

    ``bind_slots(parse_slotted(tokenize(sql)), template_of(sql)[2])`` is
    structurally identical to ``parse(sql)`` (property-tested in
    tests/test_frontend_fastpath.py) — that equality is the template cache's
    correctness guarantee.
    """

    def lit(l: Literal) -> Literal:
        s = l.value
        if isinstance(s, Slot):
            v = values[s.index]
            return Literal(-v if s.negated else v)
        return l

    def expr(e: Expr) -> Expr:
        if isinstance(e, Literal):
            return lit(e)
        if isinstance(e, BinOp):
            return BinOp(e.op, expr(e.left), expr(e.right))
        if isinstance(e, AggCall):
            return AggCall(e.func, None if e.arg is None else expr(e.arg), e.distinct)
        return e  # ColRef: no literals inside

    def pred(p: Predicate) -> Predicate:
        right = p.right
        if p.op == "between":
            lo, hi = right
            right = (lit(lo), lit(hi))
        elif p.op == "in":
            right = [lit(v) for v in right]
        elif isinstance(right, (Literal, BinOp, AggCall)):
            right = expr(right)
        return Predicate(expr(p.left), p.op, right)

    limit = q.limit
    if isinstance(limit, Slot):
        limit = values[limit.index]
    return Query(
        select=tuple(SelectItem(expr(s.expr), s.alias) for s in q.select),
        table=q.table, alias=q.alias, joins=q.joins,
        where=tuple(pred(p) for p in q.where),
        group_by=q.group_by,
        having=tuple(pred(p) for p in q.having),
        order_by=tuple((expr(e), d) for e, d in q.order_by),
        limit=limit,
    )


def parse_expr(text: str) -> Expr:
    """Parse a standalone expression (used to validate LLM-emitted measure
    expressions).  '*' alone denotes COUNT(*)'s argument placeholder."""
    if text.strip() == "*":
        return Literal("*")
    p = _Parser(tokenize(text), text)
    e = p.expr()
    if p.peek().kind != "eof":
        raise SQLSyntaxError(f"trailing input in expression: {text!r}")
    return e
