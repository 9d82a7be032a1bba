from . import evaluate, test  # noqa: F401
