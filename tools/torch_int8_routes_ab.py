#!/usr/bin/env python3
"""The int8 kernels' routes end to end on one NVIDIA GPU: what the GEMM
route of ``csrc/int8_conv.cu`` and the one-pass route of
``csrc/quantize_i8.cu`` change in a model call.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/torch_int8_routes_ab.py [--seed 0] [--turns 2]

It builds ``chip_smoke.py``'s int8 configurations (MobileNet-v2 and
ViT-B/16 at 224, 128 frames a call; GPT-2 small over 8 prompts of 1024
tokens) and times one direct call (CUDA events, ``chip_smoke.time_ms``)
with the routes ``ops/quantize.py`` picks and with the general routes
forced: the two-pass quantize, the gather product, or both (the first
int8 kernels' routes).  The settings run in turns (A B C D, D C B A, ...)
and every forced call's outputs must equal the default's bit for bit.  It
also times ``quantize_rows`` on each of MobileNet-v2's 52 activations of
one call on both routes.  Prints a line a model and, last, a JSON object
with every number and the card line.
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
            want = module(x)
            for turn in range(args.turns):
                for s in SETTINGS if turn % 2 == 0 else SETTINGS[::-1]:
                    with c.forced_routes(q, "two_pass" in s, "gather" in s):
                        if not torch.equal(c.bits(module(x)), c.bits(want)):
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
        del module, x, want
        torch.cuda.empty_cache()
    print(json.dumps({"int8_routes": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
