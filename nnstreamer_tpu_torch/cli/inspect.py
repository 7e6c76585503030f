"""nns-tpu-torch-inspect: introspect the port's elements and subplugins.

Port of ``nnstreamer_tpu/cli/inspect.py`` (≙ ``gst-inspect-1.0``): list
every registered element of the port, or print one element's properties
and pads; an unknown name gets the elements whose names contain it.

CLI:
  nns-tpu-torch-inspect                 # list all elements (+ subplugin kinds)
  nns-tpu-torch-inspect tensor_filter   # one element's properties and pads
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _ensure_registered() -> None:
    """Import side-effect registration of every element/subplugin."""
    from .. import backends as _b  # noqa: F401
    from .. import converters as _c  # noqa: F401
    from .. import decoders as _d  # noqa: F401
    from .. import elements as _e  # noqa: F401


def _list_all(out) -> None:
    from ..core import registry
    from ..pipeline.element import ELEMENT_TYPES

    classes = len(set(ELEMENT_TYPES.values()))  # aliases share a class
    out.write(f"{len(ELEMENT_TYPES)} elements ({classes} classes):\n")
    for name in sorted(ELEMENT_TYPES):
        cls = ELEMENT_TYPES[name]
        doc = (cls.__doc__ or "").strip().splitlines()
        out.write(f"  {name:<24} {doc[0] if doc else ''}\n")
    for kind in registry.KINDS:
        names = sorted(registry.get_all(kind))
        if names:
            out.write(f"{len(names)} {kind} subplugins: {', '.join(names)}\n")


def _inspect_one(name: str, out) -> int:
    from ..pipeline.element import ELEMENT_TYPES, SinkElement, SourceElement

    cls = ELEMENT_TYPES.get(name)
    if cls is None:
        close = [n for n in sorted(ELEMENT_TYPES) if name in n]
        out.write(f"no element {name!r}")
        out.write(f" (did you mean: {', '.join(close)})\n" if close else "\n")
        return 1
    out.write(f"Element: {name}\n")
    if cls.__doc__:
        for line in cls.__doc__.strip().splitlines():
            out.write(f"  {line.strip()}\n")
    kind = (
        "source" if issubclass(cls, SourceElement)
        else "sink" if issubclass(cls, SinkElement)
        else "transform/filter"
    )
    out.write(f"Kind: {kind}\n")

    def pads(n):  # None = request pads, created on link (≙ Sometimes/Request)
        return "dynamic (on request)" if n is None else str(n)

    out.write(
        f"Pads: sink={pads(cls.NUM_SINK_PADS)} "
        f"src={pads(cls.NUM_SRC_PADS)}\n"
    )
    props = getattr(cls, "PROPERTIES", {})
    out.write(f"Properties ({len(props)}):\n")
    for pname, p in props.items():
        out.write(
            f"  {pname:<24} {p.type.__name__:<7} "
            f"default={p.default!r:<12} {p.doc}\n"
        )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="nns-tpu-torch-inspect",
        description="list elements or show one element's properties",
    )
    ap.add_argument("element", nargs="?", help="element name (omit to list)")
    args = ap.parse_args(argv)
    _ensure_registered()
    if args.element:
        return _inspect_one(args.element, sys.stdout)
    _list_all(sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
