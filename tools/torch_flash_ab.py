#!/usr/bin/env python3
"""Two versions of the flash-attention kernel source, side by side on one
NVIDIA GPU in one process.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/torch_flash_ab.py --against OTHER.cu [--rounds 2]

``OTHER.cu`` is another version of ``nnstreamer_tpu_torch/csrc/flash_attention.cu``
with the same C entry point (an earlier commit's, or a variant).  Both
sources are compiled at once with the port's nvcc flags (and ``csrc/``
on the include path) into ``build/flash_ab/``.  Each library in turn is put behind the port's own
wrapper (``ops/flash_attention.py``), which then:

* passes every case of ``chip_smoke.check_flash`` (within its tolerances
  of ``flash_attention_plain``; TF32 off) and prints its timings;
* is timed in rounds ordered checkout, other, other, checkout at the two
  paths' bfloat16 shapes (ViT-B/16 (128, 197, 12, 64) non-causal, GPT-2
  small (8, 1024, 12, 64) causal, q, k, v laid out as the models' fused
  projection lays them out): device ms per call by ``chip_smoke.time_ms``
  (CUDA events, launches queued behind a device sleep), and host ms per
  call — the wrapper's own cost on the host (Python, ctypes, the entry
  point's set-up and the launch), timed while a device sleep holds the
  card so that the calls only queue.  ``scaled_dot_product_attention``'s
  host ms per call is timed the same way, for scale.

Prints one line per measurement, the card line, and last a JSON object
with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = (("ViT-B/16", (128, 197, 12, 64), False), ("GPT-2 small", (8, 1024, 12, 64), True))


def build(signatures: dict, sources: dict, tag: str = "flash") -> dict:
    """name -> loaded library of each source, all compiled at once into
    ``build/<tag>_ab/``, with ``argtypes`` set for each entry point of
    `signatures` that the library has."""
    from nnstreamer_tpu_torch.ops import _build

    out = ROOT / "build" / f"{tag}_ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        so = out / f"lib{tag}_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(src)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.nns_error_string.argtypes = [ctypes.c_int]
        lib.nns_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            if not hasattr(lib, fn):
                continue
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True, help="the other kernel source (.cu)")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of checkout, other, other, checkout")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab.py: no CUDA device")
    import chip_smoke
    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.ops import flash_attention as fa

    card = chip_smoke.card_line()
    print(f"card {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    chip_smoke.tf32_off(torch)
    sources = {"checkout": _build.CSRC / "flash_attention.cu", "other": args.against.resolve()}
    t = time.perf_counter()
    libs = build(fa._SIGNATURES, sources)
    print(f"build: {time.perf_counter() - t:.1f} s (two sources in parallel)")

    result = {"card": card, "sources": {k: str(v) for k, v in sources.items()}, "check_flash": {},
              "device_ms": {n: {s[0]: [] for s in SHAPES} for n in libs},
              "host_ms": {n: {s[0]: [] for s in SHAPES} for n in libs}}
    for name, lib in libs.items():
        with mock.patch.dict(_build._libs, {"flash_attention": lib}):
            print(f"-- {name}: {sources[name]}")
            flash = chip_smoke.check_flash(torch, fa)
        result["check_flash"][name] = {r["shape"] + " " + r["dtype"]: r["ms"] for r in flash["shapes"]}

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    inputs = {}
    for label, (b, t_, h, d), causal in SHAPES:
        x = torch.randn(b, t_, 3 * h * d, device=dev, generator=g).to(torch.bfloat16)
        inputs[label] = ([a.reshape(b, t_, h, d) for a in x.split(h * d, dim=-1)], causal)
    order = ["checkout", "other", "other", "checkout"] * args.rounds
    for name in order:
        with mock.patch.dict(_build._libs, {"flash_attention": libs[name]}):
            for label, ((q, k, v), causal) in inputs.items():
                call = partial(fa.flash_attention, q, k, v, causal=causal)
                result["device_ms"][name][label].append(chip_smoke.time_ms(call))
                result["host_ms"][name][label].append(chip_smoke.host_ms(torch, call))
    result["sdpa_host_ms"] = {}
    for label, ((q, k, v), causal) in inputs.items():
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        result["sdpa_host_ms"][label] = chip_smoke.host_ms(
            torch, partial(F.scaled_dot_product_attention, qt, kt, vt, is_causal=causal))

    for label, _, _ in SHAPES:
        for what in ("device_ms", "host_ms"):
            a, b = (result[what][n][label] for n in ("checkout", "other"))
            print(f"{label} {what}: checkout {statistics.median(a):.4f} {[round(x, 4) for x in a]}, "
                  f"other {statistics.median(b):.4f} {[round(x, 4) for x in b]}")
        print(f"{label} scaled_dot_product_attention host_ms {result['sdpa_host_ms'][label]:.4f}")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
