#!/usr/bin/env python3
"""Versions of the top1 kernel source, side by side on one NVIDIA GPU in
one process.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/torch_top1_ab.py --against OTHER.cu [MORE.cu ...] [--rounds 2]

Each ``OTHER.cu`` is another version of
``nnstreamer_tpu_torch/csrc/top1.cu`` (named by its file stem when there
are several): either one with the checkout's entry point ``nns_top1`` (a
variant), which is put behind the port's wrapper (``ops/labeling.py``),
or an earlier one
whose only entry point is ``nns_top1_f32`` (float32, contiguous rows, split
output), which is called directly through ctypes with no Python checks
(so its host ms is a lower bound of a wrapper's).  All sources are
compiled at once with the port's nvcc flags (``torch_flash_ab.build``)
into ``build/top1_ab/``.  Each version is first held against
``top1_plain`` on ``chip_smoke.top1_cases`` in float32 (the earlier entry
on the contiguous ones only): index- and value-equal, NaN positions
included.  Then all are timed at the paths' (128, 1001) float32 in
rounds ordered others, checkout, checkout, others reversed (with one
other: other, checkout, checkout, other): device ms per call
(``chip_smoke.time_ms``: CUDA events, launches queued behind a device
sleep) and host ms per call (``chip_smoke.host_ms``).

Prints one line per measurement, the card line, and last a JSON object
with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the entry point of a top1 source that predates ``nns_top1``
EARLIER_SIGNATURES = {
    "nns_top1_f32": (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p),
}


def caller(torch, lab, lib):
    """(context that puts `lib` behind the wrapper, top1 on (B, C) float32
    CUDA logits through `lib`)."""
    from nnstreamer_tpu_torch.ops import _build

    if hasattr(lib, "nns_top1"):
        return mock.patch.dict(_build._libs, {"top1": lib}), lab.top1

    def call(x):
        rows, cols = x.shape
        idx = torch.empty(rows, dtype=torch.int32, device=x.device)
        val = torch.empty(rows, dtype=torch.float32, device=x.device)
        err = lib.nns_top1_f32(x.data_ptr(), rows, cols, idx.data_ptr(), val.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "top1")
        return idx, val

    return nullcontext(), call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", required=True,
                    help="the other kernel sources (.cu)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of others, checkout, checkout, others reversed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_top1_ab.py: no CUDA device")
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke
    from torch_flash_ab import build

    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.ops import labeling as lab

    card = chip_smoke.card_line()
    print(f"card {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    others = {p.stem if len(args.against) > 1 else "other": p.resolve() for p in args.against}
    sources = {"checkout": _build.CSRC / "top1.cu", **others}
    t = time.perf_counter()
    libs = build({**lab._SIGNATURES, **EARLIER_SIGNATURES}, sources, tag="top1")
    print(f"build: {time.perf_counter() - t:.1f} s ({len(sources)} sources in parallel)")

    g = torch.Generator(device=torch.device("cuda", 0)).manual_seed(2)
    cases = chip_smoke.top1_cases(torch, torch.float32, g)
    main_logits = cases[0][1]
    result = {"card": card, "sources": {k: str(v) for k, v in sources.items()}, "checked": {},
              "device_ms": {n: [] for n in libs}, "host_ms": {n: [] for n in libs}}
    for name, lib in libs.items():
        context, call = caller(torch, lab, lib)
        checked = 0
        with context:
            for label, x in cases:
                if not (x.is_contiguous() or hasattr(lib, "nns_top1")):
                    continue
                (idx, val), (ridx, rval) = call(x), lab.top1_plain(x)
                torch.cuda.synchronize()
                if not (torch.equal(idx, ridx) and chip_smoke.same_values(val, rval)):
                    raise AssertionError(f"top1 {name} {label}: differs from the plain version")
                checked += 1
        result["checked"][name] = checked
        print(f"-- {name}: {sources[name]}: {checked} float32 cases equal to top1_plain")

    for name in ([*others, "checkout", "checkout", *reversed(others)]) * args.rounds:
        context, call = caller(torch, lab, libs[name])
        with context:
            result["device_ms"][name].append(chip_smoke.time_ms(lambda: call(main_logits)))
            result["host_ms"][name].append(chip_smoke.host_ms(torch, lambda: call(main_logits)))

    for what in ("device_ms", "host_ms"):
        print(f"top1 (128, 1001) float32 {what}: " + ", ".join(
            f"{n} {statistics.median(ts):.4f} {[round(x, 4) for x in ts]}"
            for n, ts in result[what].items()))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
