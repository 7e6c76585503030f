"""Textual pipeline descriptions (gst-launch dialect).

Port of ``nnstreamer_tpu/pipeline/parser.py``::

    videotestsrc num-buffers=8 ! tensor_converter ! tee name=t
      t. ! queue ! tensor_filter framework=torch-cuda model=zoo
        custom=arch:mobilenet_v2 ! tensor_decoder mode=image_labeling ! m.
      t. ! queue ! tensor_transform mode=typecast option=float32 ! m.
      tensor_mux name=m ! tensor_sink name=out

* ``!`` links elements left to right.
* ``key=value`` tokens set properties on the preceding element
  (``name=x`` registers the element under a pipeline-wide name).
* ``x.`` starts a new chain from the named element ``x`` (``t. ! a``), or
  ends one into it (``a ! m.``); ``x`` may be named later in the text
  (a forward reference, resolved at the end).  A request-pad source
  (tee, demux, split, if) hands out its src pads in text order.
* a bare schema string (``tensors,format=...``) becomes a capsfilter.
* an element that directly follows another, with no ``!`` or ``x.``
  between them, starts a new, unlinked chain (``appsrc tensor_sink``).
* quotes protect spaces in values.
"""

from __future__ import annotations

import shlex
from typing import Dict, List, Optional

from .. import elements as _elements  # noqa: F401 — registers element factories
from .element import ELEMENT_TYPES, Element, ElementError, make_element
from .pipeline import Pipeline


def _is_caps(token: str) -> bool:
    head = token.split(",", 1)[0]
    return head in ("tensors", "other/tensors") or head.startswith("other/")


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
    named: Dict[str, Element] = {}
    deferred: List[tuple] = []  # (src element, claimed src pad, target name)
    current: Optional[Element] = None
    pending_src: Optional[Element] = None
    link_requested = False
    caps_n = 0
    branch_counts: Dict[int, int] = {}  # id(element) -> src pads handed out

    def claim_pad(src: Element) -> int:
        # request-src elements get a fresh src pad per textual branch
        if src.NUM_SRC_PADS is not None:
            return 0
        idx = branch_counts.get(id(src), 0)
        branch_counts[id(src)] = idx + 1
        return idx

    def new_node(el: Element) -> None:
        nonlocal current, pending_src, link_requested
        pipe.add(el)
        if link_requested:
            pending_src.link(el, src_pad=claim_pad(pending_src))
        pending_src = None
        link_requested = False
        current = el

    for tok in tokens:
        if tok == "!":
            if current is None or link_requested:
                raise ParseError("'!' with no preceding element")
            pending_src = current
            link_requested = True
            continue
        if tok.endswith(".") and len(tok) > 1:
            ref = tok[:-1]
            if link_requested:
                # "a ! m.": link into the named element, resolved at the
                # end (forward references); the src pad is claimed now so
                # branch order follows the text
                deferred.append((pending_src, claim_pad(pending_src), ref))
                pending_src = None
                link_requested = False
                current = None
            else:
                # "t. ! a": a new chain from the named element
                if ref not in named:
                    raise ParseError(f"reference to unknown element {ref!r}")
                current = named[ref]
            continue
        if _is_caps(tok):
            caps_n += 1
            new_node(make_element("capsfilter", name=f"capsfilter{caps_n}", caps=tok))
            continue
        if "=" in tok and tok.split("=", 1)[0] not in ELEMENT_TYPES:
            if current is None:
                raise ParseError(f"property {tok!r} with no preceding element")
            key, value = tok.split("=", 1)
            if key == "name":
                if value in named:
                    raise ParseError(f"duplicate element name {value!r}")
                del pipe.elements[current.name]
                current.name = value
                pipe.elements[value] = current
                named[value] = current
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
        new_node(el)

    if link_requested:
        raise ParseError("pipeline text ends with dangling '!'")
    for src_el, src_pad, ref in deferred:
        if ref not in named:
            raise ParseError(f"reference to unknown element {ref!r}")
        src_el.link(named[ref], src_pad=src_pad)
    return pipe
