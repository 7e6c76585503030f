"""nns-tpu-torch-launch: run a textual pipeline description on the port
to its end.

Port of ``nnstreamer_tpu/cli/launch.py`` (≙ ``gst-launch-1.0``)::

    python -m nnstreamer_tpu_torch.cli.launch "<pipeline>" [--timeout S] [-q] [--trace]
        [--dot FILE]

The pipeline runs as ``parse_pipeline`` builds it: filters on the card
unless their ``accelerator`` says ``cpu``.  Exit status 0 when the stream
reached every sink; an element's error or a ``--timeout`` raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="nns-tpu-torch-launch",
                                 description="run a pipeline description on the port")
    ap.add_argument("pipeline", nargs="+", help="pipeline text (joined by spaces)")
    ap.add_argument("--timeout", type=float, default=None, help="max seconds")
    ap.add_argument("-q", "--quiet", action="store_true", help="suppress bus messages")
    ap.add_argument("--trace", action="store_true",
                    help="print the per-element tracer table on exit "
                    "(proctime/framerate/interlatency/queue/bitrate; ≙ GstShark)")
    ap.add_argument("--dot", metavar="FILE", default="",
                    help="write the pipeline graph as Graphviz DOT after negotiation "
                    "(≙ GST_DEBUG_DUMP_DOT_DIR)")
    args = ap.parse_args(argv)

    from ..pipeline import parse_pipeline

    pipe = parse_pipeline(" ".join(args.pipeline))
    if not args.quiet:
        pipe.add_bus_watcher(lambda msg: print(f"[bus] {msg}", file=sys.stderr))
    tracer = pipe.enable_tracing() if args.trace else None
    t0 = time.monotonic()
    pipe.start()
    try:
        # inside the try: a bad --dot path must still stop the pipeline
        if args.dot:
            with open(args.dot, "w") as f:
                f.write(pipe.to_dot())
        pipe.wait(timeout=args.timeout)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
    finally:
        pipe.stop()
        # a failing run is exactly when the timing table matters most
        if tracer is not None:
            print("\n".join(tracer.summary_lines()), file=sys.stderr)
    if not args.quiet:
        print(f"pipeline finished in {time.monotonic() - t0:.3f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
