from . import fusion, metrics  # noqa: F401
from .evaluator import (  # noqa: F401
    EncodedDataset,
    encode_dataset,
    evaluate_clip_model,
    evaluate_weighted,
    evaluate_zeroshot,
    fusion_sweep,
    run_full_evaluation,
)
