from .captioning import Blip2Captioner, CaptioningPipeline, FakeCaptioner  # noqa: F401
from .metadata import build_metadata_texts, generate_metadata_descriptions  # noqa: F401
from .texts import build_hybrid_texts, combine_descriptions, random_select_content  # noqa: F401
