from .text_models import (  # noqa: F401
    HashTextEncoder,
    SentenceTransformerEncoder,
    evaluate_lm_query_target,
    evaluate_text_model,
    grouped_retrieval_metrics,
    load_text_variants,
)
