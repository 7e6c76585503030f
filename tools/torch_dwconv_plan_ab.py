#!/usr/bin/env python3
"""How ``csrc/int8_dwconv.cu`` tiles its work, A/B on one NVIDIA GPU:
the plan ``ops/quantize.py`` ships against the other tilings considered,
at every depthwise layer of one MobileNet-v2 (224) and one
SSD-MobileNet-v2 (300) call, 128 frames each.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/torch_dwconv_plan_ab.py [--seed 0]

The arms:

* ``shipped``: ``ops/quantize.py``'s ``int8_dwconv_plan``, a cost search
  over (channels, rows, columns) of an item that counts the halo, idle
  threads, tiles past the image and past C, and the blocks idle in the
  last wave at the call's batch on this card's SMs;
* ``search``: the same search with every wave whole (asked for 2 frames
  on one SM, which makes its last-wave factor 1): what the batch and the
  SM count add;
* ``fixed``: C rounded up to 16 channels an item (at most 128), whole
  output rows (as few column bands as a box side of 256 allows), as many
  rows as two boxes fit beside the weights in ``DWCONV_SMEM_BYTES``, the
  bands balanced.

Each layer runs on random int8 input with each arm's plan (the wrapper's
plan function swapped for the arm's), every output checked bit for bit
against the plain int32 accumulator, then timed in two turns (arms in
order, then reversed; CUDA events, ``chip_smoke.time_ms``), the mean of
the two medians kept.  Prints a line a model and, last, a JSON object
with every layer's plans and times and the card line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FRAMES = 128


def fixed_plan(q, h: int, w: int, c: int, kh: int, kw: int, stride: int, x_align: int):
    """The ``fixed`` arm."""
    pix = q.DWCONV_PIX
    ho, wo = -(-h // stride), -(-w // stride)
    chunk = 16 if c % 16 == 0 and x_align == 0 else next(
        v for v in (8, 4, 1) if c % v == 0 and x_align % v == 0)
    tile_c = min(-(-c // 16) * 16, 128)
    cap = ((q.DWCONV_BOX_MAX - kw) // stride + 1) // pix * pix  # output columns a box holds
    tile_w = wo if -(-wo // pix) * pix <= cap else -(-(-(-wo // -(-wo // cap))) // pix) * pix
    in_cols = (-(-tile_w // pix) * pix - 1) * stride + kw
    boxes = q.DWCONV_SMEM_BYTES - 256 - q.dwconv_weight_bytes(c, kh, kw, tile_c)
    most = min(ho, (min(q.DWCONV_BOX_MAX, boxes // (2 * in_cols * tile_c)) - kh) // stride + 1)
    rows = -(-ho // -(-ho // most))
    return q.DwconvPlan(chunk, tile_c, rows, tile_w, (rows - 1) * stride + kh, in_cols)


def depthwise_shapes(torch, np, c, seed: int) -> list:
    """(model, h, w, c, k, stride, layer) of every depthwise layer of one
    call of MobileNet-v2 and SSD-MobileNet-v2 (``chip_smoke``'s int8
    builds), from forward hooks on one frame."""
    from nnstreamer_tpu_torch.models import build

    shapes = []
    for name, custom, size in c.INT8_LAYER_MODELS:
        if name not in ("MobileNet-v2", "SSD-MobileNet-v2"):
            continue
        props = c.custom_props(f"{custom},seed:{seed}")
        module = build(props["arch"], props)[0].cuda().eval()
        frame = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, (1, size, size, 3), dtype=np.uint8)).cuda()
        for layer, (_, ch, h, w) in c.int8_layer_inputs(torch, module, frame):
            if getattr(layer, "groups", 1) > 1:
                shapes.append((name, h, w, ch, layer.kernel_size[0], layer.stride[0], layer))
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as c
    from nnstreamer_tpu_torch.ops import quantize as q

    if not torch.cuda.is_available():
        print("torch_dwconv_plan_ab: no CUDA device", file=sys.stderr)
        return 1
    card = c.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(args.seed + 11)
    shipped = q.int8_dwconv_plan
    arms = {
        "shipped": lambda h, w, ch, kh, kw, s, al: shipped(FRAMES, h, w, ch, kh, kw, s, al, sms),
        "search": lambda h, w, ch, kh, kw, s, al: shipped(2, h, w, ch, kh, kw, s, al, 1),
        "fixed": lambda *shape: fixed_plan(q, *shape),
    }
    rows, n = [], FRAMES
    for model, h, w, ch, k, s, layer in depthwise_shapes(torch, np, c, args.seed):
        xq = torch.randint(-127, 128, (n, h, w, ch), dtype=torch.int8, device=dev, generator=g)
        sx = torch.rand(n, device=dev, generator=g)
        wq, sw = layer.qweight()
        want = q.conv_i8_plain(xq, sx, wq, sw, s, ch, torch.int32)
        plans = {a: f(h, w, ch, k, k, s, 0) for a, f in arms.items()}
        times = {a: [] for a in arms}
        for turn in (list(arms), list(arms)[::-1]):
            for a in turn:
                q.int8_dwconv_plan = lambda *_, p=plans[a]: p
                try:
                    if not times[a] and not torch.equal(q.conv_i8(xq, sx, wq, sw, s, ch,
                                                                  torch.int32), want):
                        raise AssertionError(f"{model} {(h, w, ch, k, s)} {a} {plans[a]}: "
                                             "not bit-equal to the plain accumulator")
                    times[a].append(c.time_ms(lambda: q.conv_i8(xq, sx, wq, sw, s, ch),
                                              reps=7, inner=5))
                finally:
                    q.int8_dwconv_plan = shipped
        del xq, want
        rows.append({"model": model, "shape": [n, h, w, ch, k, s],
                     "plans": {a: p._asdict() for a, p in plans.items()},
                     "ms": {a: sum(t) / len(t) for a, t in times.items()}})
    result = {"card": card, "frames": n, "models": {}}
    for model in dict.fromkeys(r["model"] for r in rows):
        mine = [r for r in rows if r["model"] == model]
        sums = {a: sum(r["ms"][a] for r in mine) for a in arms}
        result["models"][model] = {"layers": len(mine), "ms": sums}
        print(f"{model}: {len(mine)} depthwise layers over {n} frames (bf16 out), sums of "
              f"per-layer ms: " + ", ".join(f"{a} {v:.4f}" for a, v in sums.items())
              + f" (CUDA events); on {card}", flush=True)
    result["rows"] = rows
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
