"""Pipeline runtime: elements, threaded scheduler, parser."""

from .element import (  # noqa: F401
    ELEMENT_TYPES,
    Element,
    ElementError,
    Property,
    SinkElement,
    SourceElement,
    TransformElement,
    element,
    make_element,
)
from .parser import ParseError, parse_pipeline  # noqa: F401
from .pipeline import Pipeline  # noqa: F401
