"""Textual pipeline descriptions (gst-launch dialect).

Port of ``nnstreamer_tpu/pipeline/parser.py`` for linear chains::

    appsrc name=src ! tensor_filter framework=torch-cuda model=zoo
      custom=arch:mobilenet_v2 ! tensor_decoder mode=image_labeling !
      tensor_sink name=out

``!`` links elements left to right; ``key=value`` tokens set properties on
the preceding element (``name=x`` names it); quotes protect spaces.
Branch references (``t.``) and bare caps strings are not ported yet.
"""

from __future__ import annotations

import shlex
from typing import Optional

from .. import elements as _elements  # noqa: F401 — registers element factories
from .element import ELEMENT_TYPES, Element, ElementError, make_element
from .pipeline import Pipeline


class ParseError(ValueError):
    pass


def parse_pipeline(text: str, name: str = "pipeline", fuse: Optional[bool] = None) -> Pipeline:
    """Parse a pipeline description into an (unstarted) Pipeline.

    ``fuse``: streaming-thread fusion (None = the ``NNS_FUSE`` default,
    on; False = one thread per element)."""
    try:
        tokens = shlex.split(text.replace("\n", " "))
    except ValueError as e:
        raise ParseError(f"tokenize failed: {e}") from None
    if not tokens:
        raise ParseError("empty pipeline description")

    pipe = Pipeline(name, fuse=fuse)
    current: Optional[Element] = None
    link_requested = False
    for tok in tokens:
        if tok == "!":
            if current is None or link_requested:
                raise ParseError("'!' with no preceding element")
            link_requested = True
            continue
        if "=" in tok and tok.split("=", 1)[0] not in ELEMENT_TYPES:
            if current is None or link_requested:
                raise ParseError(f"property {tok!r} with no preceding element")
            key, value = tok.split("=", 1)
            if key == "name":
                if value in pipe.elements:
                    raise ParseError(f"duplicate element name {value!r}")
                del pipe.elements[current.name]
                current.name = value
                pipe.elements[value] = current
            else:
                current.set_property(key, value)
            continue
        try:
            el = make_element(tok)
        except ElementError as e:
            raise ParseError(str(e)) from None
        base, n = el.name, 2
        while el.name in pipe.elements:  # unique auto-name within the pipeline
            el.name = f"{base}_{n}"
            n += 1
        pipe.add(el)
        if link_requested:
            current.link(el)
            link_requested = False
        elif current is not None:
            raise ParseError(f"element {tok!r} not linked: missing '!'")
        current = el
    if link_requested:
        raise ParseError("pipeline text ends with dangling '!'")
    return pipe
