"""Remote-service clients for the knowledge module, with fakes for tests.

The reference calls the Mistral agent and the GraphDB SPARQL endpoint
directly with no seam (``src/text2sparql/text2sparql_retrieval.py:30-58``,
``entity_linking.py:130-141``), so it cannot be tested offline. Here both
services sit behind protocols:

- :class:`LLMClient`    — natural language -> Sparnatural JSON text;
- :class:`SparqlClient` — SPARQL query -> standard JSON-results bindings;

with HTTP implementations (Mistral conversation stream; POST with
``X-API-Key``) and in-memory fakes (:class:`FakeLLMClient`,
:class:`FakeSparqlClient`) used throughout the test suite.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Protocol, Sequence

from ..utils.config import Endpoints


class LLMClient(Protocol):
    def generate(self, text: str) -> str: ...


class SparqlClient(Protocol):
    def execute(self, query: str) -> Dict[str, Any]:
        """Run a SPARQL query, returning the standard JSON results dict
        (``{"results": {"bindings": [...]}}``)."""
        ...


# ---------------------------------------------------------------------------
# HTTP implementations
# ---------------------------------------------------------------------------


class MistralAgentClient:
    """Streams a hosted Mistral agent conversation
    (reference ``text2sparql_retrieval.py:30-43``)."""

    def __init__(self, api_key: Optional[str] = None, agent_id: Optional[str] = None):
        env = Endpoints.from_env()
        self.api_key = api_key or env.mistral_api_key
        self.agent_id = agent_id or env.mistral_agent_id
        if not self.api_key or not self.agent_id:
            raise ValueError("MISTRAL_API_KEY / MISTRAL_AGENT_ID not configured")
        from mistralai import Mistral  # optional dependency, imported lazily

        self._client = Mistral(api_key=self.api_key)

    def generate(self, text: str) -> str:
        response = self._client.beta.conversations.start_stream(agent_id=self.agent_id, inputs=text)
        out = []
        for chunk in response:
            content = getattr(getattr(chunk, "data", None), "content", None)
            if isinstance(content, str):
                out.append(content)
        return "".join(out)


class HTTPSparqlClient:
    """POST application/sparql-query with API key (reference
    ``entity_linking.py:113-141``, ``text2sparql_retrieval.py:19-24``)."""

    def __init__(self, endpoint: Optional[str] = None, api_key: Optional[str] = None, timeout: float = 60.0):
        env = Endpoints.from_env()
        self.endpoint = endpoint or env.sparql_endpoint
        self.api_key = api_key or env.sparql_endpoint_key
        self.timeout = timeout
        if not self.endpoint:
            raise ValueError("SPARQL_ENDPOINT not configured")

    def execute(self, query: str) -> Dict[str, Any]:
        import requests

        headers = {
            "accept": "application/json",
            "Content-Type": "application/sparql-query",
        }
        if self.api_key:
            headers["X-API-Key"] = self.api_key
        response = requests.post(self.endpoint, headers=headers, data=query, timeout=self.timeout)
        response.raise_for_status()
        return response.json()


# ---------------------------------------------------------------------------
# Fakes
# ---------------------------------------------------------------------------


class FakeLLMClient:
    """Canned text->JSON-text mapping; records calls."""

    def __init__(self, responses: Mapping[str, str], default: Optional[str] = None):
        self.responses = dict(responses)
        self.default = default
        self.calls: List[str] = []

    def generate(self, text: str) -> str:
        self.calls.append(text)
        if text in self.responses:
            return self.responses[text]
        if self.default is not None:
            return self.default
        raise KeyError(f"FakeLLMClient has no response for {text!r}")


def bindings(rows: Sequence[Mapping[str, str]]) -> Dict[str, Any]:
    """Build a standard SPARQL JSON results dict from {var: value} rows."""
    return {
        "results": {
            "bindings": [
                {var: {"type": "uri", "value": val} for var, val in row.items()} for row in rows
            ]
        }
    }


class FakeSparqlClient:
    """Programmable endpoint: a handler callable inspects the query text and
    returns bindings; records every executed query."""

    def __init__(self, handler: Optional[Callable[[str], Dict[str, Any]]] = None):
        self.handler = handler or (lambda q: bindings([]))
        self.queries: List[str] = []
        self.fail_next = False

    def execute(self, query: str) -> Dict[str, Any]:
        self.queries.append(query)
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("injected SPARQL failure")
        return self.handler(query)


class FakeKGSparqlClient:
    """A tiny in-memory 'knowledge graph' good enough for entity-search and
    artefact queries: configured with label->URI entities and per-query
    artefact results."""

    def __init__(
        self,
        entities: Mapping[str, Sequence[str]],  # lowercase label -> URIs
        artefacts: Optional[Sequence[str]] = None,  # DigitalArtefact URIs returned for SELECTs
    ):
        self.entities = {k.lower(): list(v) for k, v in entities.items()}
        self.artefacts = list(artefacts or [])
        self.queries: List[str] = []

    def execute(self, query: str) -> Dict[str, Any]:
        self.queries.append(query)
        if "?label" in query and "?x" in query:
            rows = []
            lowered = query.lower()
            for label, uris in self.entities.items():
                if f'"{label}"' in lowered:
                    rows.extend({"x": uri, "label": label} for uri in uris)
            return {
                "results": {
                    "bindings": [
                        {
                            "x": {"type": "uri", "value": r["x"]},
                            "label": {"type": "literal", "value": r["label"]},
                        }
                        for r in rows
                    ]
                }
            }
        return bindings([{"DigitalArtefact": uri} for uri in self.artefacts])
