"""Core stream types: schemas, frames, events, the subplugin registry."""

from .buffer import EOS, BatchFrame, CapsEvent, Event, TensorFrame  # noqa: F401
from .types import (  # noqa: F401
    ANY,
    FORMAT_FLEXIBLE,
    FORMAT_STATIC,
    StreamSpec,
    TensorSpec,
    dtype_from_name,
    dtype_to_name,
)
