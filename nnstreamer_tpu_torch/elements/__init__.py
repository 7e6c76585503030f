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
    media_src,
    mux,
    query,
    repo,
    sparse,
    transform,
)
