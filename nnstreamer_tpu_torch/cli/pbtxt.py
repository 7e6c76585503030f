"""Pipeline text <-> pbtxt (protobuf-text) structured descriptions.

Port of ``nnstreamer_tpu/cli/pbtxt.py`` (reference:
``tools/development/parser/{parse.l,grammar.y,convert.c}``) on the port's
``pipeline/parser.py`` and ``ELEMENT_TYPES``: for the same pipeline text
the output is the JAX tool's, byte for byte, apart from framework names
(the filter's default framework here is ``torch-cuda``).

Format (one ``node`` per element, ``link`` per pad connection)::

    node {
      name: "f"
      type: "tensor_filter"
      property { key: "model" value: "zoo" }
    }
    link { src: "f" src_pad: 0 sink: "out" sink_pad: 0 }

CLI: ``python -m nnstreamer_tpu_torch.cli.pbtxt to-pbtxt "<pipeline text>"``
and ``python -m nnstreamer_tpu_torch.cli.pbtxt to-pipeline <file.pbtxt>``
(``nns-tpu-torch-pbtxt``).
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, Tuple

from ..pipeline.element import ELEMENT_TYPES, Element, make_element
from ..pipeline.parser import ParseError, parse_pipeline
from ..pipeline.pipeline import Pipeline


# ---------------------------------------------------------------------------
# Pipeline -> pbtxt
# ---------------------------------------------------------------------------
def _prop_str(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (list, tuple)):
        return ",".join(str(v) for v in value)
    return str(value)


def _changed_props(el: Element) -> List[Tuple[str, str]]:
    """Props differing from the factory defaults (fresh-instance diff)."""
    defaults = type(el)().props
    out = []
    for k, v in el.props.items():
        if k == "name":
            continue
        if k not in defaults or defaults[k] != v:
            out.append((k, _prop_str(v)))
    return out


def _q(s: str) -> str:
    """Escape a string for a pbtxt quoted value (reader-symmetric)."""
    return s.replace("\\", "\\\\").replace('"', '\\"')


def pipeline_to_pbtxt(pipe: Pipeline) -> str:
    lines: List[str] = []
    for el in pipe.elements.values():
        lines.append("node {")
        lines.append(f'  name: "{_q(el.name)}"')
        lines.append(f'  type: "{el.FACTORY_NAME}"')
        for k, v in _changed_props(el):
            lines.append("  property {")
            lines.append(f'    key: "{_q(k)}"')
            lines.append(f'    value: "{_q(v)}"')
            lines.append("  }")
        lines.append("}")
    for el in pipe.elements.values():
        for index, pad in enumerate(el.srcpads):
            for sink_el, sink_pad in pad.links:
                lines.append(
                    "link { "
                    f'src: "{el.name}" src_pad: {index} '
                    f'sink: "{sink_el.name}" sink_pad: {sink_pad}'
                    " }"
                )
    return "\n".join(lines) + "\n"


def pipeline_text_to_pbtxt(text: str) -> str:
    return pipeline_to_pbtxt(parse_pipeline(text))


# ---------------------------------------------------------------------------
# pbtxt -> Pipeline
# ---------------------------------------------------------------------------
_TOKEN = re.compile(
    r"""\s*(?:
        (?P<open>[A-Za-z_][\w-]*)\s*\{ |
        (?P<close>\}) |
        (?P<kv>[A-Za-z_][\w-]*)\s*:\s*(?P<val>"(?:[^"\\]|\\.)*"|[^\s{}]+)
    )""",
    re.VERBOSE,
)


def _parse_messages(text: str) -> List[Tuple[str, dict]]:
    """Tiny pbtxt reader: returns [(message_name, fields)] where repeated
    sub-messages collect into lists under their name."""
    pos = 0
    root: List[Tuple[str, dict]] = []
    stack: List[dict] = []
    names: List[str] = []
    while pos < len(text):
        if text[pos:].strip() == "":
            break
        m = _TOKEN.match(text, pos)
        if not m:
            raise ParseError(f"pbtxt syntax error near {text[pos:pos + 40]!r}")
        pos = m.end()
        if m.group("open"):
            stack.append({})
            names.append(m.group("open"))
        elif m.group("close"):
            if not stack:
                raise ParseError("pbtxt: unbalanced '}'")
            msg, name = stack.pop(), names.pop()
            if stack:
                stack[-1].setdefault(name, []).append(msg)
            else:
                root.append((name, msg))
        else:
            if not stack:
                raise ParseError("pbtxt: field outside a message")
            val = m.group("val")
            if val.startswith('"'):
                val = val[1:-1].replace('\\"', '"').replace("\\\\", "\\")
            stack[-1][m.group("kv")] = val
    if stack:
        raise ParseError("pbtxt: unbalanced '{'")
    return root


def pbtxt_to_pipeline(text: str, name: str = "pipeline") -> Pipeline:
    pipe = Pipeline(name)
    for kind, msg in _parse_messages(text):
        if kind == "node":
            ntype = msg.get("type")
            nname = msg.get("name")
            if not ntype or not nname:
                raise ParseError("pbtxt node needs name: and type:")
            if ntype not in ELEMENT_TYPES:
                raise ParseError(f"no such element factory {ntype!r}")
            el = make_element(ntype, name=nname)
            for prop in msg.get("property", []):
                el.set_property(prop["key"], prop["value"])
            pipe.add(el)
        elif kind == "link":
            try:
                src = pipe[msg["src"]]
                sink = pipe[msg["sink"]]
            except KeyError as e:
                raise ParseError(f"pbtxt link references unknown node {e}") from None
            src.link(
                sink,
                src_pad=int(msg.get("src_pad", 0)),
                sink_pad=int(msg.get("sink_pad", 0)),
            )
        else:
            raise ParseError(f"pbtxt: unknown message {kind!r}")
    return pipe


def pbtxt_to_pipeline_text(text: str) -> str:
    """pbtxt -> equivalent pipeline description.

    Linear sections inline with ``!``; fan-outs become ``t. ! ...`` branch
    statements and fan-ins become ``... ! m.`` feeder statements.  Statement
    order is chosen so that re-parsing reproduces the pbtxt's exact pad
    assignment: the parser claims dynamic src pads in text order and
    resolves fan-in sink pads in text order of the deferred ``! m.`` links,
    so branch statements are ordered by src_pad and feeder statements by
    sink_pad (a topological sort over both constraint sets).
    """
    import shlex

    pipe = pbtxt_to_pipeline(text)
    in_deg: Dict[str, int] = {n: 0 for n in pipe.elements}
    # el name -> [(src_pad, sink_name, sink_pad)]
    out_links: Dict[str, List[Tuple[int, str, int]]] = {n: [] for n in pipe.elements}
    for el in pipe.elements.values():
        for index, pad in enumerate(el.srcpads):
            for sink_el, sink_pad in pad.links:
                in_deg[sink_el.name] += 1
                out_links[el.name].append((index, sink_el.name, sink_pad))
        out_links[el.name].sort()
        if el.NUM_SRC_PADS not in (None, 0, 1) and any(
            sp > 0 for sp, _, _ in out_links[el.name]
        ):
            raise ParseError(
                f"{el.name}: src pad > 0 on a fixed-multi-src element is not "
                "expressible as pipeline text; use the pbtxt form directly"
            )

    def node_str(el: Element) -> str:
        parts = [el.FACTORY_NAME, f"name={el.name}"]
        for k, v in _changed_props(el):
            parts.append(f"{k}={shlex.quote(v)}")
        return " ".join(parts)

    # -- build statements ----------------------------------------------------
    # statement: dict(parts, defines=[names], needs=name|None,
    #                 feeds=(join_name, sink_pad)|None,
    #                 branch=(src_name, src_pad)|None)
    statements: List[dict] = []
    defined: set = set()
    branch_queue: List[Tuple[str, int, str, int]] = []  # src, src_pad, sink, sink_pad

    def walk(start_name: str, head_parts: List[str], needs: Optional[str],
             branch: Optional[Tuple[str, int]]) -> None:
        parts = list(head_parts)
        feeds = None
        cur = start_name
        while True:
            parts.append(node_str(pipe[cur]))
            defined.add(cur)
            links = out_links[cur]
            if len(links) == 1:
                _, sink, sink_pad = links[0]
                if in_deg[sink] == 1 and sink not in defined:
                    cur = sink
                    continue
                parts.append(f"{sink}.")
                feeds = (sink, sink_pad)
            elif len(links) > 1:
                for sp, sink, kp in links:
                    branch_queue.append((cur, sp, sink, kp))
            break
        statements.append(
            dict(parts=parts, needs=needs, feeds=feeds, branch=branch)
        )

    for el in pipe.elements.values():
        if in_deg[el.name] == 0 and el.name not in defined:
            walk(el.name, [], None, None)
    while True:
        if branch_queue:
            # fan-out branches: "t. ! <target chain>" or "t. ! m."
            src, sp, sink, kp = branch_queue.pop(0)
            if in_deg[sink] == 1 and sink not in defined:
                walk(sink, [f"{src}."], src, (src, sp))
            else:
                statements.append(
                    dict(parts=[f"{src}.", f"{sink}."], needs=src,
                         feeds=(sink, kp), branch=(src, sp))
                )
            continue
        # joins / leftover nodes get their own defining statements
        leftover = [n for n in pipe.elements if n not in defined]
        if not leftover:
            break
        walk(leftover[0], [], None, None)

    # -- order statements (Kahn over the pad-order + define-before-use DAG) --
    n = len(statements)
    after: Dict[int, set] = {i: set() for i in range(n)}  # i must come after j
    def_stmt = {
        name: i for i, st in enumerate(statements) for name in _defines(st)
    }
    for i, st in enumerate(statements):
        if st["needs"] is not None and def_stmt[st["needs"]] != i:
            after[i].add(def_stmt[st["needs"]])
    for group_key in ("feeds", "branch"):
        groups: Dict[str, List[Tuple[int, int]]] = {}
        for i, st in enumerate(statements):
            if st[group_key] is not None:
                tgt, padidx = st[group_key]
                groups.setdefault(tgt, []).append((padidx, i))
        for members in groups.values():
            members.sort()
            for (_, a), (_, b) in zip(members, members[1:]):
                after[b].add(a)
    ordered: List[int] = []
    remaining = set(range(n))
    while remaining:
        ready = sorted(i for i in remaining if not (after[i] & remaining))
        if not ready:
            raise ParseError(
                "pad-order constraints are cyclic; this graph is not "
                "expressible as pipeline text — use the pbtxt form directly"
            )
        ordered.append(ready[0])
        remaining.remove(ready[0])
    return "  ".join(" ! ".join(statements[i]["parts"]) for i in ordered)


def _defines(st: dict) -> List[str]:
    """Element names a statement defines (node_str parts carry name=...)."""
    names = []
    for part in st["parts"]:
        if part.endswith("."):
            continue
        for tok in part.split():
            if tok.startswith("name="):
                names.append(tok[5:])
    return names


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[0] not in ("to-pbtxt", "to-pipeline"):
        print(
            "usage: python -m nnstreamer_tpu_torch.cli.pbtxt to-pbtxt '<pipeline>'\n"
            "       python -m nnstreamer_tpu_torch.cli.pbtxt to-pipeline <file.pbtxt>",
            file=sys.stderr,
        )
        return 2
    if argv[0] == "to-pbtxt":
        print(pipeline_text_to_pbtxt(argv[1]), end="")
    else:
        with open(argv[1]) as f:
            print(pbtxt_to_pipeline_text(f.read()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
