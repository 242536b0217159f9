"""Text2SPARQL retrieval: natural language -> KG artefact UUIDs.

The 4-stage pipeline of the reference's ``TEXT2SPARQLRetrieval``
(``src/text2sparql/text2sparql_retrieval.py:17-66``):

1. query -> Sparnatural JSON via an LLM agent (code-fence stripped, :30-43);
2. JSON -> SPARQL via reconciliation + compilation (:45-47);
3. SPARQL POSTed to the KG endpoint (:49-53);
4. ``DigitalArtefact`` UUIDs extracted from bindings by last path segment
   (:55-58).

Clients are injected (``knowledge.clients``) so each stage is testable
offline; errors in any stage degrade to an empty result list, matching the
serving engine's resilience expectations.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from ..utils.logging_utils import setup_logger
from .clients import LLMClient, SparqlClient
from .entity_linking import Text2JsonToSparqlPipeline

logger = setup_logger("kemr_torch.text2sparql")


def strip_json_fences(text: str) -> str:
    """Remove a ```` ```json ... ``` ```` fence if present (reference :39-43)."""
    text = text.strip()
    if text.startswith("```json") and text.endswith("```"):
        return text[7:-3]
    if text.startswith("```") and text.endswith("```"):
        return text[3:-3]
    return text


class Text2SparqlRetrieval:
    """End-to-end text -> artefact-UUID retrieval."""

    def __init__(
        self,
        llm_client: LLMClient,
        sparql_client: SparqlClient,
        max_results: int = 10,
        raise_errors: bool = False,
    ):
        self.llm = llm_client
        self.sparql = sparql_client
        self.pipeline = Text2JsonToSparqlPipeline(sparql_client, max_results)
        self.raise_errors = raise_errors

    def text2json(self, text_input: str) -> Dict[str, Any]:
        raw = self.llm.generate(text_input)
        return json.loads(strip_json_fences(raw))

    def json2sparql(self, json_input: Dict[str, Any]) -> str:
        _, sparql = self.pipeline.process_json_to_sparql(json_input)
        return sparql

    def run_sparql(self, sparql_query: str) -> List[str]:
        data = self.sparql.execute(sparql_query)
        rows = data.get("results", {}).get("bindings", [])
        return [r["DigitalArtefact"]["value"].split("/")[-1] for r in rows if "DigitalArtefact" in r]

    def retrieval(self, query_input: str) -> List[str]:
        """Full pipeline; empty list on any stage failure unless
        ``raise_errors``."""
        try:
            json_input = self.text2json(query_input)
            sparql_query = self.json2sparql(json_input)
            results = self.run_sparql(sparql_query)
            logger.info("text2sparql %r -> %d artefacts", query_input, len(results))
            return results
        except Exception as e:
            if self.raise_errors:
                raise
            logger.warning("text2sparql failed for %r: %s", query_input, e)
            return []
