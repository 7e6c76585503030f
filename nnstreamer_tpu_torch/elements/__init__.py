"""Stream elements.  Importing this package registers every element
factory (≙ plugin registration)."""

from . import (  # noqa: F401
    aggregator,
    basic,
    converter,
    debug,
    decoder,
    edge,
    filter,
    flow,
    generator,
    grpc_io,
    media_src,
    mqtt,
    mux,
    query,
    repo,
    sparse,
    src_iio,
    transform,
)
