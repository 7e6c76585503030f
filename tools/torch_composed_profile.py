#!/usr/bin/env python3
"""Where path e1's time goes: ``chip_smoke.py``'s composed MobileNet-v2
pipeline built up one stage at a time, each stage run on the same seeded
``videotestsrc`` frames, frames/s after the first 128 frames at the last
sink (host clock).  Run from the root of a checkout on a machine with one
CUDA card::

    python3 tools/torch_composed_profile.py [--frames 1024] [--turns 2]

Stages (each adds to the one before):

1. ``videotestsrc`` alone into a sink (drawing the random frames);
2. ``tensor_converter ! tee`` into two queued sinks (fan-out);
3. the preprocessing branch's two ``tensor_transform`` elements;
4. ``tensor_mux ! tensor_demux`` joining the branches (the labeling
   branch an ``identity``);
5. the full path e1 (the labeling branch runs the MobileNet-v2 filter and
   the decoder).

Also times the preprocessing branch's numpy work alone per frame.  Prints
one line per stage and a ``{"composed_profile": ...}`` JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SRC = ("videotestsrc name=src num-buffers={n} width=224 height=224 pattern=random seed=0 ")
PRE = ("tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
       "tensor_transform mode=clamp option=-1:1")
STAGES = {
    "source": SRC + "! tensor_sink name=last max-stored=1",
    "fan-out": SRC + "! tensor_converter ! tee name=t  t. ! queue ! tensor_sink max-stored=1  "
                     "t. ! queue ! tensor_sink name=last max-stored=1",
    "pre-branch": SRC + "! tensor_converter ! tee name=t  t. ! queue ! tensor_sink "
                        f"max-stored=1  t. ! queue ! {PRE} ! tensor_sink name=last max-stored=1",
    "mux-demux": SRC + "! tensor_converter ! tee name=t  t. ! queue ! identity ! m.  "
                       f"t. ! queue ! {PRE} ! m.  tensor_mux name=m ! tensor_demux name=d  "
                       "d. ! tensor_sink max-stored=1  d. ! tensor_sink name=last max-stored=1",
}


def run(text: str, n: int) -> float:
    """frames/s after the first 128 frames at the sink named ``last``."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(text)
    arrived = []
    pipe["last"].connect_new_data(lambda f: arrived.append(time.perf_counter()))
    pipe.start()
    try:
        pipe.wait(timeout=600)
    finally:
        pipe.stop()
    if len(arrived) != n:
        raise AssertionError(f"{len(arrived)} of {n} frames reached the last sink")
    return (n - 128) / (arrived[-1] - arrived[127])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_composed_profile.py: no CUDA device")
    card = chip_smoke.card_line()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    labels = work / "labels.txt"
    labels.write_text("\n".join(f"class{i}" for i in range(1001)))
    stages = {k: v.format(n=args.frames) for k, v in STAGES.items()}
    stages["path e1"] = chip_smoke.COMPOSED_E1.format(
        frames=args.frames, size=224, seed=0, custom="arch:mobilenet_v2,dtype:bfloat16",
        labels=labels).replace("tensor_sink name=pre", "tensor_sink name=last")
    fps = {k: [] for k in stages}
    for _ in range(args.turns):
        for name, text in stages.items():
            fps[name].append(run(text, args.frames))
    x = np.random.default_rng(0).integers(0, 256, (224, 224, 3), dtype=np.uint8)
    per_frame = []
    for _ in range(7):
        t = time.perf_counter()
        for _ in range(100):
            np.clip((x.astype(np.float32) + -127.5) / 127.5, -1.0, 1.0)
        per_frame.append((time.perf_counter() - t) * 10)
    pre_ms = statistics.median(per_frame)
    for name, v in fps.items():
        print(f"{name}: {statistics.median(v):.1f} frames/s after the first 128 frames "
              f"(runs {', '.join(f'{x:.1f}' for x in v)}); on {card}")
    print(f"preprocessing numpy work alone: {pre_ms:.4f} ms per 224x224x3 frame; on {card}")
    print(json.dumps({"composed_profile": {k: statistics.median(v) for k, v in fps.items()}
                      | {"pre_ms_per_frame": pre_ms, "card": card}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
