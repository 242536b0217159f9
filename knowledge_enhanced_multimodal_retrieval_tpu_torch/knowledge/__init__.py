from .clients import (  # noqa: F401
    FakeKGSparqlClient,
    FakeLLMClient,
    FakeSparqlClient,
    HTTPSparqlClient,
    LLMClient,
    SparqlClient,
)
from .entity_linking import (  # noqa: F401
    QueryInput,
    ReconciliationResult,
    ReconciliationService,
    SparnaturalPostProcessor,
    Text2JsonToSparqlPipeline,
    fix_dimension_query,
    fix_label_union,
)
from .json2sparql import PLACEHOLDER, SparnaturalToSparql, convert, infer_datatype  # noqa: F401
from .kg import (  # noqa: F401
    Literal,
    LocalKGSparqlClient,
    SparqlSyntaxError,
    TripleStore,
    URI,
    execute,
    parse_query,
)
from .circuit import CachedRetrieval, CircuitBreakerRetrieval  # noqa: F401
from .text2sparql import Text2SparqlRetrieval, strip_json_fences  # noqa: F401
