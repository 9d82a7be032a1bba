from .. import convert  # noqa: F401
from . import checkpoint, config, logging, metrics  # noqa: F401
