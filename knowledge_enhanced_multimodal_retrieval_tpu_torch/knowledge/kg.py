"""In-process SPARQL engine over an in-memory triple store.

The reference can only run its knowledge half against a live GraphDB
endpoint (``src/text2sparql/entity_linking.py:130-141`` POSTs every query;
there is no local evaluation anywhere) — so its Text2SPARQL pipeline is
untestable and undemoable offline. This module supplies the missing piece:
a :class:`TripleStore` plus a SPARQL evaluator covering the exact query
surface this framework emits —

- the JSON->SPARQL compiler (``knowledge.json2sparql``): PREFIX blocks,
  ``SELECT [DISTINCT]``, basic graph patterns, ``rdf:type``/``a`` triples,
  ``UNION`` alternates, ``OPTIONAL``, ``FILTER NOT EXISTS``, equality
  FILTERs with typed/lang-tagged literals, and range FILTERs;
- the entity linker (``knowledge.entity_linking``): the 7-way fuzzy label
  FILTER (``LCASE``/``STR``/``STRSTARTS``/``STRENDS``/``CONTAINS``),
  ``EXISTS`` in expressions, and the ``rdfs:label`` / ``skos:exactMatch``
  UNION template;
- the post-fix passes: dimension chains and the
  ``label UNION schema:description`` rewrite.

:class:`LocalKGSparqlClient` adapts a store to the ``SparqlClient``
protocol (standard JSON-results bindings), so the WHOLE Text2SPARQL
pipeline — LLM JSON -> reconciliation -> compilation -> execution -> UUID
extraction — runs in-process with no network. Deliberate simplifications
(documented, adequate for the emitted surface): filters are evaluated at
the end of their group scope; literal ``=`` compares numerically for
numeric datatypes and lexically otherwise, ignoring language tags;
expression evaluation errors make the filter false (SPARQL error
semantics).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"

_DEFAULT_PREFIXES = {
    "rdf": "http://www.w3.org/1999/02/22-rdf-syntax-ns#",
    "rdfs": "http://www.w3.org/2000/01/rdf-schema#",
    "xsd": "http://www.w3.org/2001/XMLSchema#",
    "skos": "http://www.w3.org/2004/02/skos/core#",
    "schema": "https://schema.org/",
}

_NUMERIC_DATATYPES = {
    "http://www.w3.org/2001/XMLSchema#integer",
    "http://www.w3.org/2001/XMLSchema#decimal",
    "http://www.w3.org/2001/XMLSchema#double",
    "http://www.w3.org/2001/XMLSchema#float",
    "http://www.w3.org/2001/XMLSchema#int",
    "http://www.w3.org/2001/XMLSchema#long",
}


class SparqlSyntaxError(ValueError):
    """Raised on queries outside the supported subset."""


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class URI:
    value: str


@dataclass(frozen=True)
class Literal:
    value: str
    datatype: Optional[str] = None
    lang: Optional[str] = None


@dataclass(frozen=True)
class Var:
    name: str


Term = Union[URI, Literal, Var]


def _term_json(term: Union[URI, Literal]) -> Dict[str, str]:
    if isinstance(term, URI):
        return {"type": "uri", "value": term.value}
    out = {"type": "literal", "value": term.value}
    if term.datatype:
        out["datatype"] = term.datatype
    if term.lang:
        out["xml:lang"] = term.lang
    return out


# ---------------------------------------------------------------------------
# Triple store
# ---------------------------------------------------------------------------


_NT_LINE = re.compile(
    r"^<([^>]*)>\s+<([^>]*)>\s+"
    r"(?:<([^>]*)>|\"((?:[^\"\\]|\\.)*)\"(?:\^\^<([^>]*)>|@([A-Za-z-]+))?)"
    r"\s*\.\s*$"
)

_URI_LIKE = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*://")


class TripleStore:
    """Indexed in-memory triple store (SPO list + predicate/subject maps).

    Subjects and predicates are URIs; objects are URIs or literals. Scale
    target is demo/test knowledge graphs (up to ~10^5 triples) — evaluation
    is index-assisted scanning, not a query optimizer.
    """

    def __init__(self) -> None:
        self.triples: List[Tuple[str, str, Union[URI, Literal]]] = []
        self._by_p: Dict[str, List[int]] = {}
        self._by_s: Dict[str, List[int]] = {}

    def __len__(self) -> int:
        return len(self.triples)

    def add(self, s: str, p: str, o: Union[URI, Literal, str]) -> None:
        """Add one triple. A plain-string object becomes a URI when it looks
        like an absolute IRI (``scheme://``), else a plain literal; pass a
        :class:`URI`/:class:`Literal` to force."""
        if isinstance(o, str):
            o = URI(o) if _URI_LIKE.match(o) else Literal(o)
        idx = len(self.triples)
        self.triples.append((s, p, o))
        self._by_p.setdefault(p, []).append(idx)
        self._by_s.setdefault(s, []).append(idx)

    # -- matching -------------------------------------------------------------

    def match(
        self,
        s: Optional[str],
        p: Optional[str],
        o: Optional[Union[URI, Literal]],
    ) -> Iterable[Tuple[str, str, Union[URI, Literal]]]:
        """All triples matching the given constants (None = wildcard)."""
        if s is not None:
            rows = self._by_s.get(s, ())
        elif p is not None:
            rows = self._by_p.get(p, ())
        else:
            rows = range(len(self.triples))
        for i in rows:
            ts, tp, to = self.triples[i]
            if s is not None and ts != s:
                continue
            if p is not None and tp != p:
                continue
            if o is not None and not _object_equal(to, o):
                continue
            yield ts, tp, to

    # -- loaders ----------------------------------------------------------------

    @classmethod
    def from_json(cls, obj: Union[str, Mapping[str, Any], Sequence]) -> "TripleStore":
        """Load from ``{"triples": [[s, p, o], ...]}`` (or a bare list).

        Each ``o`` may be a string (URI-like -> URI, else literal), or a
        dict ``{"uri": ...}`` / ``{"value": ..., "datatype"?, "lang"?}``.
        ``obj`` may also be a path to a JSON file.
        """
        if isinstance(obj, str):
            with open(obj) as f:
                obj = json.load(f)
        rows = obj.get("triples", []) if isinstance(obj, Mapping) else obj
        store = cls()
        for s, p, o in rows:
            if isinstance(o, Mapping):
                if "uri" in o:
                    o = URI(o["uri"])
                else:
                    o = Literal(str(o["value"]), o.get("datatype"), o.get("lang"))
            store.add(s, p, o)
        return store

    @classmethod
    def from_ntriples(cls, text: str) -> "TripleStore":
        """Minimal N-Triples parser (URI / plain / typed / lang-tagged
        objects; ``#`` comment lines)."""
        store = cls()
        for lineno, line in enumerate(text.splitlines(), 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = _NT_LINE.match(line)
            if not m:
                raise SparqlSyntaxError(f"bad N-Triples line {lineno}: {line!r}")
            s, p, o_uri, o_lit, o_dt, o_lang = m.groups()
            if o_uri is not None:
                store.add(s, p, URI(o_uri))
            else:
                value = o_lit.replace('\\"', '"').replace("\\\\", "\\")
                store.add(s, p, Literal(value, o_dt, o_lang))
        return store


def _object_equal(a: Union[URI, Literal], b: Union[URI, Literal]) -> bool:
    """Object-position term match: URIs by value; literals leniently by
    lexical form + datatype-if-both-typed (language tags ignored — labels in
    real KGs are tagged unpredictably)."""
    if isinstance(a, URI) or isinstance(b, URI):
        return type(a) is type(b) and a.value == b.value
    if a.datatype and b.datatype and a.datatype != b.datatype:
        return False
    return a.value == b.value


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "prefix", "select", "distinct", "where", "union", "optional",
    "filter", "not", "exists", "a",
}

_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_-]*")
_NUMBER = re.compile(r"-?\d+(\.\d+)?")


@dataclass
class _Tok:
    kind: str  # kw, var, uri, pname, str, num, punct
    value: Any
    pos: int = 0


def _tokenize(text: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
        elif c == "#":  # comment to EOL ('#' inside <...>/"..." never gets here)
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
        elif c == "<" and not text.startswith("<=", i):
            j = text.find(">", i)
            if j < 0:
                raise SparqlSyntaxError(f"unterminated URI at {i}")
            toks.append(_Tok("uri", text[i + 1 : j], i))
            i = j + 1
        elif c == '"':
            j = i + 1
            buf = []
            while j < n and text[j] != '"':
                if text[j] == "\\" and j + 1 < n:
                    buf.append(text[j + 1])
                    j += 2
                else:
                    buf.append(text[j])
                    j += 1
            if j >= n:
                raise SparqlSyntaxError(f"unterminated string at {i}")
            toks.append(_Tok("str", "".join(buf), i))
            i = j + 1
        elif c == "?":
            m = _WORD.match(text, i + 1)
            if not m:
                raise SparqlSyntaxError(f"bad variable at {i}")
            toks.append(_Tok("var", m.group(0), i))
            i = m.end()
        elif text.startswith("^^", i):
            toks.append(_Tok("punct", "^^", i))
            i += 2
        elif c == "@":
            m = _WORD.match(text, i + 1)
            if not m:
                raise SparqlSyntaxError(f"bad language tag at {i}")
            toks.append(_Tok("punct", "@" + m.group(0), i))
            i = m.end()
        elif text.startswith("&&", i) or text.startswith("||", i):
            toks.append(_Tok("punct", text[i : i + 2], i))
            i += 2
        elif text.startswith(">=", i) or text.startswith("<=", i) or text.startswith("!=", i):
            toks.append(_Tok("punct", text[i : i + 2], i))
            i += 2
        elif c in "{}().,=!><":
            toks.append(_Tok("punct", c, i))
            i += 1
        elif _NUMBER.match(text, i):
            m = _NUMBER.match(text, i)
            toks.append(_Tok("num", m.group(0), i))
            i = m.end()
        else:
            m = _WORD.match(text, i)
            if not m:
                raise SparqlSyntaxError(f"unexpected character {c!r} at {i}")
            word = m.group(0)
            i = m.end()
            if i < n and text[i] == ":":  # prefixed name p:local
                m2 = _WORD.match(text, i + 1)
                local = m2.group(0) if m2 else ""
                toks.append(_Tok("pname", (word, local), i))
                i = (m2.end() if m2 else i + 1)
            elif word.lower() in _KEYWORDS:
                toks.append(_Tok("kw", word.lower(), i))
            else:
                toks.append(_Tok("word", word, i))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class TriplePattern:
    s: Term
    p: Term
    o: Term


@dataclass
class Group:
    elements: List[Any] = field(default_factory=list)  # patterns/unions/optionals
    filters: List[Any] = field(default_factory=list)  # expression ASTs


@dataclass
class UnionBlock:
    branches: List[Group]


@dataclass
class OptionalBlock:
    group: Group


@dataclass
class NotExists:
    group: Group


@dataclass
class ExistsExpr:
    group: Group


@dataclass
class FuncCall:
    name: str
    args: List[Any]


@dataclass
class BinOp:
    op: str
    left: Any
    right: Any


@dataclass
class SelectQuery:
    variables: List[str]
    distinct: bool
    where: Group


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0
        self.prefixes = dict(_DEFAULT_PREFIXES)

    # -- token helpers --------------------------------------------------------

    def _peek(self, offset: int = 0) -> Optional[_Tok]:
        j = self.i + offset
        return self.toks[j] if j < len(self.toks) else None

    def _next(self) -> _Tok:
        if self.i >= len(self.toks):
            raise SparqlSyntaxError("unexpected end of query")
        t = self.toks[self.i]
        self.i += 1
        return t

    def _expect(self, kind: str, value: Any = None) -> _Tok:
        t = self._next()
        if t.kind != kind or (value is not None and t.value != value):
            raise SparqlSyntaxError(f"expected {value or kind}, got {t.kind}:{t.value!r} at {t.pos}")
        return t

    def _at_kw(self, word: str) -> bool:
        t = self._peek()
        return t is not None and t.kind == "kw" and t.value == word

    def _at_punct(self, value: str) -> bool:
        t = self._peek()
        return t is not None and t.kind == "punct" and t.value == value

    def _resolve_pname(self, pname: Tuple[str, str]) -> str:
        prefix, local = pname
        if prefix not in self.prefixes:
            raise SparqlSyntaxError(f"unknown prefix {prefix!r}")
        return self.prefixes[prefix] + local

    # -- grammar ----------------------------------------------------------------

    def parse(self) -> SelectQuery:
        while self._at_kw("prefix"):
            self._next()
            pname = self._expect("pname")
            uri = self._expect("uri")
            self.prefixes[pname.value[0]] = uri.value
        self._expect("kw", "select")
        distinct = False
        if self._at_kw("distinct"):
            self._next()
            distinct = True
        variables: List[str] = []
        while self._peek() is not None and self._peek().kind == "var":
            variables.append(self._next().value)
        if not variables:
            raise SparqlSyntaxError("SELECT needs at least one variable")
        self._expect("kw", "where")
        where = self._group()
        if self._peek() is not None:
            t = self._peek()
            raise SparqlSyntaxError(f"trailing tokens at {t.pos}: {t.value!r}")
        return SelectQuery(variables, distinct, where)

    def _group(self) -> Group:
        self._expect("punct", "{")
        group = Group()
        while not self._at_punct("}"):
            t = self._peek()
            if t is None:
                raise SparqlSyntaxError("unterminated group")
            if t.kind == "punct" and t.value == "{":
                group.elements.append(self._union_chain())
            elif t.kind == "kw" and t.value == "optional":
                self._next()
                group.elements.append(OptionalBlock(self._group()))
            elif t.kind == "kw" and t.value == "filter":
                self._next()
                if self._at_kw("not"):
                    self._next()
                    self._expect("kw", "exists")
                    group.filters.append(NotExists(self._group()))
                else:
                    self._expect("punct", "(")
                    expr = self._expr()
                    self._expect("punct", ")")
                    group.filters.append(expr)
            elif t.kind == "punct" and t.value == ".":
                self._next()  # stray separator
            else:
                group.elements.append(self._triple())
        self._expect("punct", "}")
        return group

    def _union_chain(self) -> Any:
        branches = [self._group()]
        while self._at_kw("union"):
            self._next()
            branches.append(self._group())
        if len(branches) == 1:
            # a plain nested group scopes like an inline union of one branch
            return UnionBlock(branches)
        return UnionBlock(branches)

    def _triple(self) -> TriplePattern:
        s = self._term(position="s")
        p = self._term(position="p")
        o = self._term(position="o")
        if self._at_punct("."):
            self._next()
        return TriplePattern(s, p, o)

    def _term(self, position: str) -> Term:
        t = self._next()
        if t.kind == "var":
            return Var(t.value)
        if t.kind == "uri":
            return URI(t.value)
        if t.kind == "pname":
            return URI(self._resolve_pname(t.value))
        if t.kind == "kw" and t.value == "a" and position == "p":
            return URI(RDF_TYPE)
        if t.kind in ("str", "num") and position == "o":
            return self._literal_tail(t)
        raise SparqlSyntaxError(f"bad {position} term {t.value!r} at {t.pos}")

    def _literal_tail(self, t: _Tok) -> Literal:
        value = str(t.value)
        nxt = self._peek()
        if nxt is not None and nxt.kind == "punct" and nxt.value == "^^":
            self._next()
            dt = self._next()
            if dt.kind == "uri":
                return Literal(value, dt.value)
            if dt.kind == "pname":
                return Literal(value, self._resolve_pname(dt.value))
            raise SparqlSyntaxError(f"bad datatype at {dt.pos}")
        if nxt is not None and nxt.kind == "punct" and str(nxt.value).startswith("@"):
            self._next()
            return Literal(value, lang=str(nxt.value)[1:])
        if t.kind == "num":
            dt = "integer" if "." not in value else "decimal"
            return Literal(value, f"http://www.w3.org/2001/XMLSchema#{dt}")
        return Literal(value)

    # -- expressions ------------------------------------------------------------

    def _expr(self) -> Any:
        left = self._and_expr()
        while self._at_punct("||"):
            self._next()
            left = BinOp("||", left, self._and_expr())
        return left

    def _and_expr(self) -> Any:
        left = self._unary_expr()
        while self._at_punct("&&"):
            self._next()
            left = BinOp("&&", left, self._unary_expr())
        return left

    def _unary_expr(self) -> Any:
        if self._at_punct("!"):
            self._next()
            return FuncCall("!", [self._unary_expr()])
        left = self._primary()
        t = self._peek()
        if t is not None and t.kind == "punct" and t.value in ("=", "!=", ">=", "<=", ">", "<"):
            self._next()
            return BinOp(t.value, left, self._primary())
        return left

    def _primary(self) -> Any:
        t = self._peek()
        if t is None:
            raise SparqlSyntaxError("unexpected end of expression")
        if t.kind == "punct" and t.value == "(":
            self._next()
            inner = self._expr()
            self._expect("punct", ")")
            return inner
        if t.kind == "kw" and t.value == "exists":
            self._next()
            return ExistsExpr(self._group())
        if t.kind == "word":  # function name
            self._next()
            self._expect("punct", "(")
            args = [self._expr()]
            while self._at_punct(","):
                self._next()
                args.append(self._expr())
            self._expect("punct", ")")
            return FuncCall(t.value.upper(), args)
        if t.kind == "var":
            self._next()
            return Var(t.value)
        if t.kind in ("str", "num"):
            self._next()
            return self._literal_tail(t)
        if t.kind == "uri":
            self._next()
            return URI(t.value)
        if t.kind == "pname":
            self._next()
            return URI(self._resolve_pname(t.value))
        raise SparqlSyntaxError(f"bad expression token {t.value!r} at {t.pos}")


def parse_query(text: str) -> SelectQuery:
    return _Parser(_tokenize(text)).parse()


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

Solution = Dict[str, Union[URI, Literal]]


class _Evaluator:
    def __init__(self, store: TripleStore):
        self.store = store

    # -- patterns ---------------------------------------------------------------

    def eval_group(self, group: Group, solutions: List[Solution]) -> List[Solution]:
        for element in group.elements:
            if isinstance(element, TriplePattern):
                solutions = self._join_triple(element, solutions)
            elif isinstance(element, UnionBlock):
                merged: List[Solution] = []
                for branch in element.branches:
                    merged.extend(self.eval_group(branch, solutions))
                solutions = merged
            elif isinstance(element, OptionalBlock):
                out: List[Solution] = []
                for mu in solutions:
                    extended = self.eval_group(element.group, [mu])
                    out.extend(extended if extended else [mu])
                solutions = out
            else:  # pragma: no cover - parser emits only the above
                raise SparqlSyntaxError(f"unsupported element {element!r}")
            if not solutions:
                break
        # SPARQL scopes FILTERs to their group: apply at group end
        for f in group.filters:
            if isinstance(f, NotExists):
                solutions = [mu for mu in solutions if not self.eval_group(f.group, [mu])]
            else:
                solutions = [mu for mu in solutions if self._truthy(f, mu)]
        return solutions

    def _join_triple(self, tp: TriplePattern, solutions: List[Solution]) -> List[Solution]:
        out: List[Solution] = []
        for mu in solutions:
            s, p, o = self._bind(tp.s, mu), self._bind(tp.p, mu), self._bind(tp.o, mu)
            s_const = s.value if isinstance(s, URI) else None
            p_const = p.value if isinstance(p, URI) else None
            o_const = o if not isinstance(o, Var) else None
            if isinstance(s, Literal):
                continue  # literal subjects never match
            for ts, tpred, to in self.store.match(s_const, p_const, o_const):
                nu = dict(mu)
                ok = True
                for term, value in ((tp.s, URI(ts)), (tp.p, URI(tpred)), (tp.o, to)):
                    if isinstance(term, Var):
                        prev = nu.get(term.name)
                        if prev is None:
                            nu[term.name] = value
                        elif not _object_equal(prev, value):
                            ok = False
                            break
                if ok:
                    out.append(nu)
        return out

    @staticmethod
    def _bind(term: Term, mu: Solution) -> Term:
        if isinstance(term, Var) and term.name in mu:
            return mu[term.name]
        return term

    # -- expressions ------------------------------------------------------------

    def _truthy(self, expr: Any, mu: Solution) -> bool:
        try:
            return bool(self._eval_expr(expr, mu))
        except Exception:
            return False  # SPARQL: expression errors make the filter false

    def _eval_expr(self, expr: Any, mu: Solution) -> Any:
        if isinstance(expr, BinOp):
            if expr.op == "||":
                return self._truthy(expr.left, mu) or self._truthy(expr.right, mu)
            if expr.op == "&&":
                return self._truthy(expr.left, mu) and self._truthy(expr.right, mu)
            left = self._eval_expr(expr.left, mu)
            right = self._eval_expr(expr.right, mu)
            return _compare(expr.op, left, right)
        if isinstance(expr, ExistsExpr):
            return bool(self.eval_group(expr.group, [mu]))
        if isinstance(expr, FuncCall):
            if expr.name == "!":
                return not self._truthy(expr.args[0], mu)
            args = [self._eval_expr(a, mu) for a in expr.args]
            return _call(expr.name, args)
        if isinstance(expr, Var):
            if expr.name not in mu:
                raise ValueError(f"unbound ?{expr.name}")
            return mu[expr.name]
        if isinstance(expr, (URI, Literal)):
            return expr
        raise SparqlSyntaxError(f"unsupported expression {expr!r}")


def _as_string(value: Any) -> str:
    if isinstance(value, Literal):
        return value.value
    if isinstance(value, URI):
        return value.value
    return str(value)


def _as_number(value: Any) -> float:
    if isinstance(value, Literal):
        return float(value.value)
    if isinstance(value, (int, float)):
        return float(value)
    raise ValueError(f"not numeric: {value!r}")


def _is_numeric(value: Any) -> bool:
    return (
        isinstance(value, (int, float))
        or (isinstance(value, Literal) and value.datatype in _NUMERIC_DATATYPES)
    )


def _compare(op: str, left: Any, right: Any) -> bool:
    if isinstance(left, URI) or isinstance(right, URI):
        l, r = _as_string(left), _as_string(right)
    elif _is_numeric(left) and _is_numeric(right):
        l, r = _as_number(left), _as_number(right)
    else:
        # lexical comparison: correct for strings and ISO dateTimes; language
        # tags deliberately ignored (KG labels are tagged unpredictably)
        l, r = _as_string(left), _as_string(right)
    if op == "=":
        return l == r
    if op == "!=":
        return l != r
    if op == ">=":
        return l >= r
    if op == "<=":
        return l <= r
    if op == ">":
        return l > r
    if op == "<":
        return l < r
    raise SparqlSyntaxError(f"unsupported operator {op}")


def _call(name: str, args: List[Any]) -> Any:
    if name == "STR":
        return Literal(_as_string(args[0]))
    if name == "LCASE":
        return Literal(_as_string(args[0]).lower())
    if name == "UCASE":
        return Literal(_as_string(args[0]).upper())
    if name == "STRSTARTS":
        return _as_string(args[0]).startswith(_as_string(args[1]))
    if name == "STRENDS":
        return _as_string(args[0]).endswith(_as_string(args[1]))
    if name == "CONTAINS":
        return _as_string(args[1]) in _as_string(args[0])
    if name == "STRLEN":
        return len(_as_string(args[0]))
    if name == "BOUND":
        return True  # reaching here means the variable evaluated (unbound raises)
    if name == "REGEX":
        flags = re.IGNORECASE if len(args) > 2 and "i" in _as_string(args[2]) else 0
        return re.search(_as_string(args[1]), _as_string(args[0]), flags) is not None
    raise SparqlSyntaxError(f"unsupported function {name}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def execute(store: TripleStore, query_text: str) -> Dict[str, Any]:
    """Run a SPARQL SELECT against the store; standard JSON results dict."""
    query = parse_query(query_text)
    solutions = _Evaluator(store).eval_group(query.where, [{}])
    rows: List[Dict[str, Dict[str, str]]] = []
    seen = set()
    for mu in solutions:
        row = {v: _term_json(mu[v]) for v in query.variables if v in mu}
        if query.distinct:
            key = tuple(sorted((k, tuple(sorted(d.items()))) for k, d in row.items()))
            if key in seen:
                continue
            seen.add(key)
        rows.append(row)
    return {
        "head": {"vars": list(query.variables)},
        "results": {"bindings": rows},
    }


class LocalKGSparqlClient:
    """``SparqlClient`` over an in-process :class:`TripleStore` — the whole
    Text2SPARQL pipeline runs with no network. Accepts a store, a path to a
    ``.json`` / ``.nt`` file, or raw N-Triples text."""

    def __init__(self, store: Union[TripleStore, str]):
        if isinstance(store, str):
            if store.endswith(".json"):
                store = TripleStore.from_json(store)
            else:
                with open(store) as f:
                    store = TripleStore.from_ntriples(f.read())
        self.store = store
        self.queries: List[str] = []

    def execute(self, query: str) -> Dict[str, Any]:
        self.queries.append(query)
        return execute(self.store, query)
