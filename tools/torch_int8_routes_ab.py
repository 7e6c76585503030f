#!/usr/bin/env python3
"""The int8 kernels' routes end to end on one NVIDIA GPU: what the GEMM
route of ``csrc/int8_conv.cu`` and the one-pass route of
``csrc/quantize_i8.cu`` change in a model call, and each int8 kernel's
device time in a call beside the bf16 build's.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/torch_int8_routes_ab.py [--seed 0] [--turns 2]

It builds ``chip_smoke.py``'s int8 configurations (MobileNet-v2 and
ViT-B/16 at 224, SSD-MobileNet-v2 at 300 and YOLOv5s at 640, 128 frames a
call; GPT-2 small over 8 prompts of 1024 tokens) and times one direct
call (CUDA events, ``chip_smoke.time_ms``)
with the routes ``ops/quantize.py`` picks and with the general routes
forced: the two-pass quantize, the gather product, or both (the first
int8 kernels' routes).  The settings run in turns (A B C D, D C B A, ...)
and every forced call's outputs must equal the default's bit for bit.  It
also times ``quantize_rows`` on each of MobileNet-v2's 52 activations of
one call on both routes.  Then, with ``torch.profiler``, the device time
per call of each int8 kernel (summed by kernel name) and of everything
else, beside the device time of the bf16 build of the same seed on the
same inputs.  Prints lines a model and, last, a JSON object with every
number and the card line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SETTINGS = ("default", "two_pass", "gather", "two_pass+gather")
#: kernel names of the int8 kernels (``csrc/quantize_i8.cu``,
#: ``int8_conv.cu``, ``int8_dwconv.cu``) as the profiler lists them
INT8_KERNELS = ("quantize", "absmax", "int8_")


def outputs(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def kernel_name(name: str) -> str:
    """A CUDA kernel's name without its return type, namespaces, template
    and arguments; ``int8_mma_kernel`` with its route (its first template
    argument: 0 is the GEMM route's TMA producer)."""
    name = name.replace("(anonymous namespace)::", "")
    words = name.split("<")[0].split("(")[0].split()
    base = words[-1].split("::")[-1] if words else name
    if base == "int8_mma_kernel" and "<" in name:
        base += " (gemm)" if name.split("<")[1].split(",")[0].strip() == "0" else " (gather)"
    return base


def device_ms_by_kernel(torch, fn, calls: int = 3) -> dict:
    """Device ms per ``fn()`` call by kernel name, from ``torch.profiler``
    over `calls` calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            key = kernel_name(e.name)
            ms[key] = ms.get(key, 0.0) + e.device_time_total / 1e3 / calls
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the inputs")
    ap.add_argument("--turns", type=int, default=2, help="turns over the four settings")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as c
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.ops import quantize as q

    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_routes_ab.py: no CUDA device")
    card = c.card_line()
    c.tf32_off(torch)
    rng = np.random.default_rng(args.seed)
    lm_props = c.custom_props(c.LM_CUSTOM)
    models = {
        "MobileNet-v2": (c.INT8_CUSTOM, rng.integers(0, 256, (128, 224, 224, 3), dtype=np.uint8)),
        "ViT-B/16": (f"{c.VIT_CUSTOM},quantize:int8",
                     rng.integers(0, 256, (128, 224, 224, 3), dtype=np.uint8)),
        "SSD-MobileNet-v2": (f"{c.INT8_DIRECT[0][1]},quantize:int8",
                             rng.integers(0, 256, (128, 300, 300, 3), dtype=np.uint8)),
        "YOLOv5s": (f"{c.INT8_DIRECT[1][1]},quantize:int8",
                    rng.integers(0, 256, (128, 640, 640, 3), dtype=np.uint8)),
        "GPT-2 small": (f"{c.LM_CUSTOM},quantize:int8",
                        rng.integers(0, int(lm_props["vocab"]), (8, 1024), dtype=np.int32)),
    }
    result = {"card": card}
    for name, (custom, inputs) in models.items():
        props = c.custom_props(f"{custom},seed:{args.seed}")
        module = build(props["arch"], props)[0].cuda().eval()
        x = torch.from_numpy(inputs).cuda()
        times = {s: [] for s in SETTINGS}
        with torch.inference_mode():
            want = outputs(module(x))
            for turn in range(args.turns):
                for s in SETTINGS if turn % 2 == 0 else SETTINGS[::-1]:
                    with c.forced_routes(q, "two_pass" in s, "gather" in s):
                        got = outputs(module(x))
                        if not all(torch.equal(c.bits(a), c.bits(b)) for a, b in zip(got, want)):
                            raise AssertionError(f"{name}: the {s} routes change the output")
                        times[s].append(c.time_ms(lambda: module(x), reps=7, inner=3))
        ms = {s: statistics.median(t) for s, t in times.items()}
        result[name] = {"ms_per_call": ms, "frames_or_prompts": len(inputs)}
        print(f"{name} int8 direct call, {len(inputs)} a call (ms, CUDA events, median of "
              f"{args.turns} turns): " + ", ".join(f"{s} {v:.3f}" for s, v in ms.items())
              + f"; on {card}", flush=True)
        if name == "MobileNet-v2":
            acts = []
            hooks = [m.register_forward_hook(lambda m, a, o: acts.append(a[0]))
                     for m in c.quant_layers(module)]
            with torch.inference_mode():
                module(x)
            for h in hooks:
                h.remove()
            rows = [a.permute(0, 2, 3, 1).reshape(a.shape[0], -1) for a in acts]
            sums = {}
            for two_pass in (False, True):
                with c.forced_routes(q, two_pass=two_pass):
                    sums[two_pass] = sum(c.time_ms(lambda r=r: q.quantize_rows(r), reps=7, inner=5)
                                         for r in rows)
            result[name]["quantize_sum_ms"] = {"one_pass": sums[False], "two_pass": sums[True],
                                               "activations": len(rows)}
            print(f"{name} quantize_i8 over its {len(rows)} activations of one call: one pass "
                  f"{sums[False]:.3f} ms, two passes {sums[True]:.3f} ms (sums of CUDA-event "
                  f"medians); on {card}", flush=True)
        bf16_props = {k: v for k, v in props.items() if k != "quantize"}
        bf16 = build(bf16_props["arch"], bf16_props)[0].cuda().eval()
        with torch.inference_mode():
            by_kernel = device_ms_by_kernel(torch, lambda: module(x))
            bf16_ms = sum(device_ms_by_kernel(torch, lambda: bf16(x)).values())
        int8 = {k: v for k, v in by_kernel.items() if k.startswith(INT8_KERNELS)}
        total = sum(by_kernel.values())
        result[name]["device_ms_per_call"] = {"int8_kernels": int8, "other": total - sum(
            int8.values()), "total": total, "bf16_build_total": bf16_ms}
        print(f"{name} device ms per call (torch.profiler, default routes): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(int8.items())) + f", other kernels "
            f"{total - sum(int8.values()):.3f}, total {total:.3f}; the bf16 build {bf16_ms:.3f}; "
            f"on {card}", flush=True)
        del module, bf16, x, want
        torch.cuda.empty_cache()
    print(json.dumps({"int8_routes": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
