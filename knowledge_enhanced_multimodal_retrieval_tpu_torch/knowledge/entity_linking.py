"""Entity linking / reconciliation for LLM-produced Sparnatural JSON.

Fresh implementation of the reference's reconciliation pipeline
(``src/text2sparql/entity_linking.py`` — SURVEY §2.4), with the remote
endpoint injected as a :class:`~.clients.SparqlClient` so the whole pipeline
runs against fakes in tests.

Stages:
1. walk the JSON collecting ``URI_NOT_FOUND`` placeholders with their
   (label, oType, predicate) context (``entity_linking.py:425-472``);
2. resolve them in batches — one SPARQL query per (type, predicate) group —
   using a 7-way fuzzy label FILTER (exact-match-only for
   ``P62_depicts``), with per-(query, type, predicate) caching and a
   per-entity fallback when the batch query errors
   (``entity_linking.py:237-414``);
3. inject resolved URIs in place; extra URIs become additional ``values``
   entries (``entity_linking.py:474-526``);
4. post-fix regex passes: ``fix_dimension_query`` rebuilds CIDOC-CRM
   P43/E54/P90 dimension chains (``:34-95``); ``fix_label_union`` rewrites
   rdfs:label triples into ``label UNION schema:description`` (``:602-612``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .clients import SparqlClient
from .json2sparql import PLACEHOLDER, SparnaturalToSparql

P62_DEPICTS = "http://www.cidoc-crm.org/cidoc-crm/P62_depicts"
CRM = "http://www.cidoc-crm.org/cidoc-crm"


@dataclass
class QueryInput:
    """One placeholder to reconcile (entity_linking.py:97-102)."""

    query: str
    type: Optional[Sequence[str]] = None
    predicate: Optional[str] = None


@dataclass
class ReconciliationResult:
    """One resolved entity (entity_linking.py:104-108)."""

    id: str
    name: str


def _escape(name: str) -> str:
    return name.replace('"', '\\"').lower()


def _fuzzy_conditions(escaped_name: str) -> str:
    """The 7-way fuzzy label match (entity_linking.py:316-325)."""
    n = escaped_name
    return (
        f'(LCASE(STR(?label)) = "{n}" || '
        f'STRSTARTS(LCASE(?label), "{n}") || '
        f'STRENDS(LCASE(?label), "{n}") || '
        f'CONTAINS(LCASE(?label), "{n}") || '
        f'STRSTARTS("{n}", LCASE(?label)) || '
        f'STRENDS("{n}", LCASE(?label)) || '
        f'CONTAINS("{n}", LCASE(?label)))'
    )


def _label_matches(query_lower: str, label_lower: str) -> bool:
    """Host-side mirror of the fuzzy filter for distributing batch results
    (entity_linking.py:383-395)."""
    return (
        query_lower == label_lower
        or label_lower.startswith(query_lower)
        or label_lower.endswith(query_lower)
        or query_lower in label_lower
        or query_lower.startswith(label_lower)
        or query_lower.endswith(label_lower)
        or label_lower in query_lower
    )


def _type_filter(type_uri: Optional[Sequence[str]]) -> str:
    if not type_uri:
        return ""
    if len(type_uri) == 1:
        return f"?x a <{type_uri[0]}> ."
    optionals = "\n".join(f"OPTIONAL {{ ?x a <{t}> . }}" for t in type_uri)
    exists = " || ".join(f"EXISTS {{ ?x a <{t}> }}" for t in type_uri)
    return f"{{\n{optionals}\nFILTER({exists})\n}}"


def _entity_query(names_filter: str, type_uri: Optional[Sequence[str]], predicate: Optional[str], with_label: bool) -> str:
    select = "?x ?label" if with_label else "?x"
    return f"""PREFIX rdfs: <http://www.w3.org/2000/01/rdf-schema#>
PREFIX skos: <http://www.w3.org/2004/02/skos/core#>

SELECT DISTINCT {select} WHERE {{
{_type_filter(type_uri)}
{{
    ?s <{predicate}> ?x .
    ?x rdfs:label ?label .
}}
UNION
{{
    ?external skos:exactMatch ?x .
    ?external rdfs:label ?label .
}}
    FILTER({names_filter})
}}"""


class ReconciliationService:
    """Label -> URI resolution against the KG (entity_linking.py:111-414)."""

    def __init__(self, sparql_client: SparqlClient, max_results: int = 10):
        self.client = sparql_client
        self.max_results = max_results
        self._cache: Dict[Tuple[str, str, Optional[str]], List[ReconciliationResult]] = {}

    # -- single -------------------------------------------------------------

    def search_entity(
        self,
        name: str,
        type_uri: Optional[Sequence[str]] = None,
        predicate: Optional[str] = None,
    ) -> List[ReconciliationResult]:
        escaped = _escape(name)
        if predicate != P62_DEPICTS:
            names_filter = _fuzzy_conditions(escaped)
        else:
            names_filter = f'LCASE(STR(?label)) = "{escaped}"'
        query = _entity_query(names_filter, type_uri, predicate, with_label=False)
        try:
            data = self.client.execute(query)
        except Exception:
            return []
        rows = data.get("results", {}).get("bindings", [])
        uris = sorted({b["x"]["value"] for b in rows if "x" in b}, key=len)
        return [ReconciliationResult(id=u, name=name) for u in uris[: self.max_results]]

    # -- batch --------------------------------------------------------------

    def reconcile_batch(self, queries: Mapping[str, QueryInput]) -> Dict[str, List[ReconciliationResult]]:
        results: Dict[str, List[ReconciliationResult]] = {}
        uncached: Dict[str, QueryInput] = {}
        for key, qi in queries.items():
            cache_key = (qi.query.lower(), str(qi.type), qi.predicate)
            if cache_key in self._cache:
                results[key] = self._cache[cache_key]
            else:
                uncached[key] = qi
        if not uncached:
            return results

        groups: Dict[Tuple[str, Optional[str]], List[Tuple[str, QueryInput]]] = {}
        for key, qi in uncached.items():
            groups.setdefault((str(qi.type), qi.predicate), []).append((key, qi))

        for _, members in groups.items():
            batch = self._search_entity_batch([m[1] for m in members])
            for (key, qi), entity_results in zip(members, batch):
                results[key] = entity_results
                self._cache[(qi.query.lower(), str(qi.type), qi.predicate)] = entity_results
        return results

    def _search_entity_batch(self, queries: Sequence[QueryInput]) -> List[List[ReconciliationResult]]:
        if not queries:
            return []
        type_uri = queries[0].type
        predicate = queries[0].predicate
        escaped = [_escape(q.query) for q in queries]
        if predicate != P62_DEPICTS:
            combined = " || ".join(_fuzzy_conditions(n) for n in escaped)
        else:
            combined = " || ".join(f'LCASE(STR(?label)) = "{n}"' for n in escaped)
        query = _entity_query(combined, type_uri, predicate, with_label=True)
        try:
            data = self.client.execute(query)
        except Exception:
            # batch failed: fall back to per-entity queries (entity_linking.py:411-414)
            return [self.search_entity(q.query, q.type, q.predicate) for q in queries]

        by_label: Dict[str, List[str]] = {}
        for b in data.get("results", {}).get("bindings", []):
            if "x" in b and "label" in b:
                by_label.setdefault(b["label"]["value"].lower(), []).append(b["x"]["value"])

        out: List[List[ReconciliationResult]] = []
        for qi in queries:
            qlow = qi.query.lower()
            matched: List[str] = []
            for label, uris in by_label.items():
                if _label_matches(qlow, label):
                    matched.extend(uris)
            matched = sorted(set(matched), key=len)
            out.append([ReconciliationResult(id=u, name=qi.query) for u in matched[: self.max_results]])
        return out


# ---------------------------------------------------------------------------
# Placeholder collection / injection
# ---------------------------------------------------------------------------


class SparnaturalPostProcessor:
    """Placeholder resolution over the LLM JSON (entity_linking.py:417-564)."""

    PLACEHOLDER_URI = PLACEHOLDER
    _MARK = "_placeholder_key"

    def __init__(self, reconciliation_service: ReconciliationService):
        self.reconciliation = reconciliation_service

    def _collect_and_mark(self, obj: Any) -> Dict[str, QueryInput]:
        placeholders: Dict[str, QueryInput] = {}
        counter = [0]

        def walk(node: Any, predicate: Optional[str]) -> None:
            if isinstance(node, dict):
                if "p" in node:
                    predicate = node.get("p")
                values = node.get("values")
                if isinstance(values, list):
                    o_type = node.get("oType")
                    for item in values:
                        if not (isinstance(item, dict) and "rdfTerm" in item):
                            continue
                        term = item["rdfTerm"]
                        if term.get("type") == "uri" and term.get("value") == self.PLACEHOLDER_URI:
                            key = f"label_{counter[0]}"
                            counter[0] += 1
                            placeholders[key] = QueryInput(
                                query=item.get("label", ""), type=o_type, predicate=predicate
                            )
                            item[self._MARK] = key
                for v in node.values():
                    walk(v, predicate)
            elif isinstance(node, list):
                for item in node:
                    walk(item, predicate)

        walk(obj, None)
        return placeholders

    def _inject(self, obj: Any, uri_mapping: Mapping[str, Sequence[str]]) -> None:
        def walk(node: Any) -> None:
            if isinstance(node, dict):
                values = node.get("values")
                if isinstance(values, list):
                    extra: List[dict] = []
                    for item in values:
                        if not isinstance(item, dict):
                            continue
                        key = item.pop(self._MARK, None)
                        if key is None or key not in uri_mapping:
                            continue
                        uris = list(uri_mapping[key])
                        if uris:
                            item["rdfTerm"]["value"] = uris[0]
                            label = item.get("label", "")
                            extra.extend(
                                {"label": label, "rdfTerm": {"type": "uri", "value": u}} for u in uris[1:]
                            )
                    values.extend(extra)
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for item in node:
                    walk(item)

        walk(obj)

    def process(self, sparnatural_json: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(sparnatural_json, dict):
            raise TypeError(f"sparnatural_json must be a dict, got {type(sparnatural_json).__name__}")
        placeholders = self._collect_and_mark(sparnatural_json)
        if not placeholders:
            return sparnatural_json
        resolved = self.reconciliation.reconcile_batch(placeholders)
        uri_mapping = {k: [r.id for r in v] for k, v in resolved.items()}
        self._inject(sparnatural_json, uri_mapping)
        return sparnatural_json


# ---------------------------------------------------------------------------
# SPARQL post-fix passes (entity_linking.py:34-95, 602-612)
# ---------------------------------------------------------------------------

_VALUE_RE = re.compile(r"\?Value_(\d+)")
_SUBJECT_RE = re.compile(r"\?(\w+)\s+<[^>]*P43_has_dimension[^>]*>\s+\?Dimension_\d+")
_PAINTING_RE = re.compile(r"\?(\w*Painting\w*)")
_E54_RE = re.compile(r"\s*\?Dimension_\d+\s+rdf:type\s+<[^>]*E54_Dimension[^>]*>\s*\.")
_P90_RE = re.compile(r"\s*\?Dimension_\d+\s+<[^>]*P90_has_value[^>]*>\s+\?Value_\d+\s*\.")
_WHERE_RE = re.compile(r"WHERE\s*\{", re.IGNORECASE)
_LABEL_RE = re.compile(
    r"(\?[A-Za-z_][A-Za-z0-9_]*)\s+<http://www\.w3\.org/2000/01/rdf-schema#label>\s+"
    r"(\?[A-Za-z_][A-Za-z0-9_]*)\s*\."
)


def fix_dimension_query(sparql: str) -> str:
    """Rebuild CIDOC-CRM dimension chains: for each ?Value_N, emit a clean
    ``?s P43 ?Dimension_i . ?Dimension_i a E54 . ?Dimension_i P90 ?Value_N .``
    chain right after WHERE, dropping the LLM's malformed attempts."""
    value_numbers = sorted({int(n) for n in _VALUE_RE.findall(sparql)})
    if not value_numbers:
        return sparql

    subject_match = _SUBJECT_RE.search(sparql)
    if subject_match:
        subject = f"?{subject_match.group(1)}"
    else:
        painting = _PAINTING_RE.search(sparql)
        subject = f"?{painting.group(1)}" if painting else "?Painting_1"

    # strip the malformed originals
    sparql = re.compile(
        r"\s*" + re.escape(subject) + r"\s+<[^>]*P43_has_dimension[^>]*>\s+\?Dimension_\d+\s*\."
    ).sub("", sparql)
    sparql = _E54_RE.sub("", sparql)
    sparql = _P90_RE.sub("", sparql)

    where = _WHERE_RE.search(sparql)
    if not where:
        return sparql
    chains = ["\n  # Dimensions (auto-fixed)"]
    for i, value_num in enumerate(value_numbers, 1):
        dim = f"?Dimension_{i}"
        chains.append(f"\n  {subject} <{CRM}/P43_has_dimension> {dim}.")
        chains.append(f"\n  {dim} rdf:type <{CRM}/E54_Dimension>.")
        chains.append(f"\n  {dim} <{CRM}/P90_has_value> ?Value_{value_num}.")
    pos = where.end()
    return sparql[:pos] + "".join(chains) + sparql[pos:]


def fix_label_union(sparql: str) -> str:
    """rdfs:label triples -> ``{ label } UNION { schema:description }``."""

    def repl(m: re.Match) -> str:
        subj, obj = m.group(1), m.group(2)
        return (
            f"{{ {subj} <http://www.w3.org/2000/01/rdf-schema#label> {obj} . }} UNION "
            f"{{ {subj} <https://schema.org/description> {obj} . }}"
        )

    return _LABEL_RE.sub(repl, sparql)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class Text2JsonToSparqlPipeline:
    """JSON post-processing + SPARQL conversion (entity_linking.py:615-647)."""

    def __init__(self, sparql_client: SparqlClient, max_results: int = 10):
        self.reconciliation = ReconciliationService(sparql_client, max_results)
        self.post_processor = SparnaturalPostProcessor(self.reconciliation)
        self.converter = SparnaturalToSparql()

    def process_json_to_sparql(
        self, llm_json: Dict[str, Any], skip_reconciliation: bool = False
    ) -> Tuple[Dict[str, Any], str]:
        if not isinstance(llm_json, dict):
            raise TypeError(f"llm_json must be a dict, got {type(llm_json).__name__}")
        processed = llm_json if skip_reconciliation else self.post_processor.process(llm_json)
        sparql = self.converter.convert(processed)
        if "Dimension" in sparql:
            sparql = fix_dimension_query(sparql)
        if "Label_" in sparql:
            sparql = fix_label_union(sparql)
        return processed, sparql
