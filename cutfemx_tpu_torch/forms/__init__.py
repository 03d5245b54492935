from . import dsl, measure  # noqa: F401
