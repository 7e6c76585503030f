#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/torch_port_profile.py [--frames 2048] [--seed 0] [--custom arch:...]

It builds a full-width image-labeling pipeline of ``chip_smoke.py`` —
MobileNet-v2 by default (224x224, width 1.0, 1001 classes, bf16, seeded
random weights), or the zoo model that ``--custom`` names (the filter's
``custom=`` string, e.g. ``chip_smoke.VIT_CUSTOM`` for ViT-B/16) — warms
it up with one micro-batch, and then measures in turn:

* pipeline: frames/s through ``parse_pipeline`` (appsrc -> tensor_filter
  -> tensor_decoder -> tensor_sink, max-batch=128), under
  ``torch.profiler``: the device's busy share of the window and the
  kernels by device time;
* host loop: the same per-batch work with no pipeline threads or queues —
  ``np.stack`` of 128 frames, copy to the card, model, top1, copy back;
* its parts: ``np.stack`` alone, the host-to-card copy alone (host
  clock, synchronized), and the model + top1 on a batch already on the
  card (CUDA events).

Prints one line per measurement and, last, a JSON object with them all.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BATCH = 128


def host_ms(fn, reps: int = 10) -> float:
    import torch

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times[1:]) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--custom", default="arch:mobilenet_v2,dtype:bfloat16",
                    help="the filter's custom= string: a zoo model taking 224x224 uint8 frames")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.ops import top1
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_profile.py: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    images = rng.integers(0, 256, (args.frames + BATCH, 224, 224, 3), dtype=np.uint8)
    frames = [images[i] for i in range(len(images))]
    out = {"card": card, "custom": args.custom}

    # -- pipeline, steady state under the profiler ---------------------------
    pipe = parse_pipeline(
        "appsrc name=src max-buffers=256 ! tensor_filter name=f framework=torch-cuda model=zoo "
        f"custom={args.custom},seed:{args.seed} max-batch={BATCH} "
        "batch-timeout=20 ! tensor_decoder mode=image_labeling ! tensor_sink name=out max-stored=1")
    arrived = [0]
    done = {BATCH: threading.Event(), len(frames): threading.Event()}

    def on_frame(_):
        arrived[0] += 1
        if arrived[0] in done:
            done[arrived[0]].set()

    pipe["out"].connect_new_data(on_frame)
    pipe.start()
    try:
        for f in frames[:BATCH]:  # warm-up micro-batch: the card's lazy set-up
            pipe["src"].push(f)
        if not done[BATCH].wait(300):
            raise RuntimeError("warm-up batch did not arrive")
        invokes0 = pipe["f"].invokes
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for f in frames[BATCH:]:
                pipe["src"].push(f)
            if not done[len(frames)].wait(600):
                raise RuntimeError("pipeline did not deliver every frame")
            wall = time.perf_counter() - t
        batches = pipe["f"].invokes - invokes0
        pipe["src"].end_of_stream()
        pipe.wait(timeout=60)
    finally:
        pipe.stop()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())  # one stream: kernels do not overlap
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out["pipeline_fps"] = args.frames / wall
    out["pipeline_batches"] = batches
    out["device_busy_share"] = busy_us / (wall * 1e6)
    out["device_ms_per_batch"] = busy_us / 1e3 / max(batches, 1)
    out["top_kernels_ms"] = {k: v / 1e3 for k, v in top}
    print(f"pipeline: {out['pipeline_fps']:.1f} frames/s over {args.frames} frames in {batches} "
          f"micro-batches; device busy {100 * out['device_busy_share']:.1f}% of the window, "
          f"{out['device_ms_per_batch']:.2f} ms of kernels per micro-batch (torch.profiler)")
    for name, ms in out["top_kernels_ms"].items():
        print(f"  {ms:9.3f} ms  {name[:100]}")

    # -- the same work without the pipeline, and its parts --------------------
    props = dict(item.split(":", 1) for item in args.custom.split(","))
    module, _, _ = build(props.pop("arch"), dict(props, seed=str(args.seed)))
    module = module.cuda().eval()

    def step(k):
        x = torch.from_numpy(np.stack(frames[k:k + BATCH])).cuda()
        idx, val = top1(module(x))
        return torch.stack([idx.float(), val], -1).cpu()

    with torch.inference_mode():
        step(0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k in range(BATCH, len(frames), BATCH):
            step(k)
        out["host_loop_fps"] = args.frames / (time.perf_counter() - t)
        out["stack_ms"] = host_ms(lambda: np.stack(frames[:BATCH]))
        batch = np.stack(frames[:BATCH])
        out["h2d_ms"] = host_ms(lambda: torch.from_numpy(batch).cuda())
        x = torch.from_numpy(batch).cuda()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(21):
            start.record()
            top1(module(x))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out["model_top1_ms"] = statistics.median(times[1:])
    print(f"host loop (stack, copy, model, top1, copy back; no pipeline): "
          f"{out['host_loop_fps']:.1f} frames/s")
    print(f"per {BATCH}-frame batch: np.stack {out['stack_ms']:.2f} ms, host-to-card copy "
          f"{out['h2d_ms']:.2f} ms (host clock), model + top1 on the card "
          f"{out['model_top1_ms']:.2f} ms (CUDA events, includes launch gaps); on {card}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
