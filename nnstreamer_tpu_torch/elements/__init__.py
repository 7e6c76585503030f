"""Stream elements.  Importing this package registers every element
factory (≙ plugin registration)."""

from . import (  # noqa: F401
    aggregator,
    basic,
    converter,
    debug,
    decoder,
    filter,
    flow,
    generator,
    mux,
    repo,
    sparse,
    transform,
)
