"""Sparnatural JSON -> SPARQL compiler.

A fresh implementation of the query-generation semantics the reference
re-implements from Sparnatural AI (``src/text2sparql/json2sparql.py`` —
SURVEY §2.5). Input schema::

    {
      "distinct": bool,
      "variables": [{"termType": "Variable", "value": name}, ...],
      "branches": [
        {
          "line": {
            "s": var, "p": uri, "o": var,
            "sType": [uri, ...], "oType": [uri, ...],
            "values": [
              {"label": str, "rdfTerm": {"type": "uri"|"literal", "value": v}},
              {"min": x, "max": y, "label": str},       # range restriction
            ],
          },
          "optional": bool, "notExists": bool,
          "children": [branch, ...],
        }, ...
      ],
      "order": ...,
    }

Semantics (matching ``json2sparql.py:24-299``):
- PREFIX block for rdf/rdfs/xsd; SELECT [DISTINCT] over declared variables;
- each subject/object variable gets one ``rdf:type`` triple per type — a
  UNION block when multiple types are given;
- URI ``values`` become fixed-object triples; several values become UNION
  alternates; the reconciliation placeholder URI is skipped;
- literal ``values`` become equality FILTERs with datatype inference
  (int -> xsd:integer, float -> xsd:decimal, ISO dates -> xsd:dateTime,
  else a language-tagged string);
- ``{min,max}`` restrictions become range FILTERs appended at the end of the
  WHERE block;
- ``optional``/``notExists`` branches wrap their patterns in
  ``OPTIONAL { ... }`` / ``FILTER NOT EXISTS { ... }``. (The reference emits
  a bare ``NOT EXISTS { ... }`` — ``json2sparql.py:207-208`` — which is not
  valid SPARQL; the FILTER form is the standard-conformant equivalent.)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Mapping, Optional, Sequence, Union

PLACEHOLDER = "https://services.sparnatural.eu/api/v1/URI_NOT_FOUND"

DEFAULT_PREFIXES = {
    "rdf": "http://www.w3.org/1999/02/22-rdf-syntax-ns#",
    "rdfs": "http://www.w3.org/2000/01/rdf-schema#",
    "xsd": "http://www.w3.org/2001/XMLSchema#",
}

_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}")


def infer_datatype(value: Union[int, float, str, bool]) -> str:
    """Literal datatype inference (``json2sparql.py:94-120``)."""
    if isinstance(value, bool):
        return "xsd:boolean"
    if isinstance(value, int):
        return "xsd:integer"
    if isinstance(value, float):
        return "xsd:decimal"
    if isinstance(value, str):
        try:
            int(value)
            return "xsd:integer"
        except ValueError:
            pass
        try:
            float(value)
            return "xsd:decimal"
        except ValueError:
            pass
        if _DATE_RE.match(value):
            return "xsd:dateTime"
    return "xsd:string"


def _escape_string(value: Any) -> str:
    """Make a literal safe inside a double-quoted SPARQL string.

    The values come straight from an LLM in production (the reference pipes
    its JSON output here unsanitized — ``text2sparql_retrieval.py:30-43`` —
    so a value containing ``"`` breaks out of the string and injects query
    text). Backslashes and quotes are escaped; raw newlines (invalid in
    single-quoted SPARQL strings) become spaces.
    """
    s = str(value)
    s = s.replace("\\", "\\\\").replace('"', '\\"')
    return s.replace("\r", " ").replace("\n", " ")


def _escape_uri(uri: Any) -> str:
    """Make a URI safe inside ``<...>``: percent-encode the delimiters and
    whitespace an adversarial value could use to escape the IRI ref, and a
    leading ``=``, which right after the ``<`` would read as the ``<=``
    operator (the parser's tokenizer reads nothing else inside ``<...>``
    before the closing ``>``)."""
    s = str(uri)
    for ch, enc in (("<", "%3C"), (">", "%3E"), ('"', "%22"), ("{", "%7B"),
                    ("}", "%7D"), ("|", "%7C"), ("^", "%5E"), ("`", "%60"),
                    ("\\", "%5C"), ("\r", "%0D"), ("\n", "%0A"), (" ", "%20"),
                    ("\t", "%09")):
        s = s.replace(ch, enc)
    if s.startswith("="):
        s = "%3D" + s[1:]
    return s


def _comment(label: Any) -> str:
    """A label is only ever emitted inside a ``# ...`` comment; strip the
    newlines that would let it inject tokens past the comment's EOL."""
    return str(label).replace("\r", " ").replace("\n", " ")


_VAR_CLEAN = re.compile(r"[A-Za-z][A-Za-z0-9]*(?:_[A-Za-z0-9]+)*")
_VAR_BAD = re.compile(r"[^A-Za-z0-9_]")


def _safe_var(name: Any) -> str:
    """A SPARQL variable name for a raw name: ASCII, letter first, and one
    to one. A clean name (an ASCII letter, then letters and digits in runs
    joined by single underscores) is kept as it is; any other name becomes
    its ASCII-sanitized form, letter first, then ``__`` and the hex of its
    UTF-8 bytes. No clean name holds ``__``, and the hex tail names the raw
    name, so distinct raw names stay distinct, and every mention of one
    raw name maps to the same variable."""
    raw = str(name)
    if _VAR_CLEAN.fullmatch(raw):
        return raw
    cleaned = _VAR_BAD.sub("_", raw).strip("_")
    if not cleaned[:1].isalpha():
        cleaned = "v" + cleaned
    return f"{cleaned}__{raw.encode('utf-8').hex()}"


def _format_literal(value: Any, datatype: str) -> str:
    if datatype == "xsd:string":
        return f'"{_escape_string(value)}"@en'
    return f'"{_escape_string(value)}"^^{datatype}'


def _format_bound(value: Any, datatype: str) -> str:
    if datatype == "xsd:string":
        return f'"{_escape_string(value)}"'
    return f'"{_escape_string(value)}"^^{datatype}'


@dataclass
class _Emit:
    """Accumulated compiler state for one conversion."""

    lines: List[str] = field(default_factory=list)
    trailing_filters: List[str] = field(default_factory=list)
    declared_vars: set = field(default_factory=set)

    def add(self, indent: int, text: str) -> None:
        self.lines.append("  " * indent + text)


class SparnaturalToSparql:
    """Stateless-per-call compiler (``convert`` is a pure function of input +
    registered prefixes)."""

    def __init__(self, prefixes: Optional[Mapping[str, str]] = None):
        self.prefixes = dict(DEFAULT_PREFIXES)
        if prefixes:
            self.prefixes.update(prefixes)

    def add_prefix(self, prefix: str, uri: str) -> None:
        self.prefixes[prefix] = uri

    # -- public -------------------------------------------------------------

    def convert(self, query: Mapping[str, Any]) -> str:
        distinct = query.get("distinct", True)
        variables = [
            v.get("value")
            for v in query.get("variables", [])
            if isinstance(v, Mapping) and v.get("termType") == "Variable" and v.get("value")
        ]
        emit = _Emit()
        for branch in query.get("branches", []):
            self._branch(branch, emit, indent=1)
        for f in emit.trailing_filters:
            emit.add(1, f)

        parts = [
            "\n".join(f"PREFIX {p}: <{u}>" for p, u in sorted(self.prefixes.items())),
            ("SELECT DISTINCT" if distinct else "SELECT")
            + " "
            + " ".join(f"?{v}" for v in sorted({_safe_var(v) for v in variables}))
            + " WHERE {",
            "\n".join(emit.lines),
            "}",
        ]
        return "\n".join(p for p in parts if p)

    # -- branches -------------------------------------------------------------

    def _type_triples(self, var: str, types: Sequence[str], emit: _Emit, indent: int) -> None:
        var = _safe_var(var)
        if not types or var in emit.declared_vars:
            return
        if len(types) == 1:
            emit.add(indent, f"?{var} rdf:type <{_escape_uri(types[0])}>.")
        else:
            emit.add(indent, f"{{ ?{var} rdf:type <{_escape_uri(types[0])}>. }}")
            for t in types[1:]:
                emit.add(indent + 1, "UNION")
                emit.add(indent, f"{{ ?{var} rdf:type <{_escape_uri(t)}>. }}")
        emit.declared_vars.add(var)

    def _branch(self, branch: Mapping[str, Any], emit: _Emit, indent: int) -> None:
        if "line" not in branch:
            return
        line = branch["line"]
        subject, predicate, obj = line.get("s"), line.get("p"), line.get("o")
        s_type, o_type = line.get("sType"), line.get("oType")

        uri_values: List[Mapping] = []
        literal_values: List[Mapping] = []
        range_values: List[Mapping] = []
        for v in line.get("values", []) or []:
            term = v.get("rdfTerm") if isinstance(v, Mapping) else None
            if term is None:
                range_values.append(v)
            elif term.get("type") == "uri":
                uri_values.append(v)
            elif term.get("type") == "literal":
                literal_values.append(v)

        wrapped = branch.get("optional", False) or branch.get("notExists", False)
        if branch.get("optional", False):
            emit.add(indent, "OPTIONAL {")
            indent += 1
        elif branch.get("notExists", False):
            emit.add(indent, "FILTER NOT EXISTS {")
            indent += 1

        if subject and s_type:
            self._type_triples(subject, s_type, emit, indent)

        if subject and predicate and obj:
            subj_v, obj_v = _safe_var(subject), _safe_var(obj)
            pred_u = _escape_uri(predicate)
            resolved = [v for v in uri_values if v["rdfTerm"].get("value") != PLACEHOLDER]
            if resolved:
                if len(resolved) > 1:
                    for i, v in enumerate(resolved):
                        if i > 0:
                            emit.add(indent + 1, "UNION")
                        label = _comment(v.get("label", ""))
                        emit.add(indent + 1, f"{{ ?{subj_v} <{pred_u}> <{_escape_uri(v['rdfTerm']['value'])}>. }} # {label}")
                else:
                    v = resolved[0]
                    label = _comment(v.get("label", ""))
                    if label:
                        emit.add(indent, f"# {label}")
                    emit.add(indent, f"?{subj_v} <{pred_u}> <{_escape_uri(v['rdfTerm']['value'])}>.")
            elif not uri_values:
                emit.add(indent, f"?{subj_v} <{pred_u}> ?{obj_v}.")
                if o_type:
                    self._type_triples(obj, o_type, emit, indent)
            # note: when every URI value was an unresolved placeholder the
            # constraint is dropped entirely (reference behavior: the loop
            # over values emits nothing, json2sparql.py:222-249).

            for v in literal_values:
                value = v["rdfTerm"].get("value")
                emit.add(indent + 1, f"FILTER(?{obj_v} = {_format_literal(value, infer_datatype(value))})")

            for r in range_values:
                f = self._range_filter(obj, r, indent=1)
                if f:
                    emit.trailing_filters.append(f)

        for child in branch.get("children", []) or []:
            self._branch(child, emit, indent)

        if wrapped:
            indent -= 1
            emit.add(indent, "}")

    def _range_filter(self, variable: str, restriction: Mapping[str, Any], indent: int) -> Optional[str]:
        min_val, max_val = restriction.get("min"), restriction.get("max")
        if min_val is None and max_val is None:
            return None
        variable = _safe_var(variable)
        datatype = infer_datatype(max_val if max_val is not None else min_val)
        conditions = []
        if min_val is not None:
            conditions.append(f"?{variable} >= {_format_bound(min_val, datatype)}")
        if max_val is not None:
            conditions.append(f"?{variable} <= {_format_bound(max_val, datatype)}")
        body = conditions[0] if len(conditions) == 1 else f"({conditions[0]}) && ({conditions[1]})"
        label = _comment(restriction.get("label", ""))
        prefix = f"# {label}\n  " if label else ""
        return f"{prefix}FILTER({body})"


def convert(query: Mapping[str, Any], prefixes: Optional[Mapping[str, str]] = None) -> str:
    """Functional entry point."""
    return SparnaturalToSparql(prefixes).convert(query)
