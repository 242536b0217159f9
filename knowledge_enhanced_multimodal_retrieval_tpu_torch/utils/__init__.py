from . import config, logging_utils  # noqa: F401
