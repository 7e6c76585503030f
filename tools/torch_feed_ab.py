#!/usr/bin/env python3
"""The filter's asynchronous feed on the PyTorch port's main path, on one
NVIDIA GPU: how the ingest lane should stack a micro-batch.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/torch_feed_ab.py [--frames 2048] [--seed 0] [--turns 2]

It drives ``chip_smoke.py``'s path a (MobileNet-v2 image labeling,
224x224, 1001 classes, bf16, seeded random weights, max-batch=128) in
three modes, in turns (A B C, C B A, ...), each a fresh pipeline whose
labels must equal the first run's:

* ``sync``: ``ingest-lane=off dispatch-depth=1``, the synchronous filter;
* ``lane-numpy``: the defaults, the lane stacking with
  ``np.stack(rows, out=pinned)`` (the interpreter lock is released and
  re-taken once per row);
* ``lane-torch``: the defaults, the lane stacking with ONE
  ``torch.stack(rows, out=pinned)`` (released once, but the copy runs on
  torch's intra-op thread pool).

Before the turns it times both stacking calls alone (no pipeline running)
and with ``torch.set_num_threads(1)``.  Prints each run's line from
``chip_smoke.run_labeling_path`` (frames/s overall and after the first
micro-batch, latency, the lane's stacking ms per batch, the card's busy
share over a steady window) and, last, a JSON object with every number.
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


def stack_numpy(rows, out) -> None:
    import numpy as np

    np.stack(rows, out=out)


def stack_torch(rows, out) -> None:
    import torch

    torch.stack([torch.from_numpy(r) for r in rows], out=torch.from_numpy(out))


def alone_ms(fn, rows, out, reps: int = 9) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn(rows, out)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=2, help="A B C / C B A rounds")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_feed_ab.py: no CUDA device")
    import chip_smoke as cs
    from nnstreamer_tpu_torch.core import feed
    from nnstreamer_tpu_torch.core.buffer import DeviceBufferPool
    from nnstreamer_tpu_torch.ops import flash_attention as fa
    from nnstreamer_tpu_torch.ops import labeling as lab
    from nnstreamer_tpu_torch.ops import preprocess as pre

    card = cs.card_line()
    print(f"card {card}; torch {torch.__version__}, {torch.get_num_threads()} intra-op threads")
    rows = list(np.random.default_rng(args.seed).integers(0, 256, (128, 224, 224, 3),
                                                          dtype=np.uint8))
    buf = DeviceBufferPool(1).acquire((128, 224, 224, 3), np.uint8, placement=("dev", "cuda", 0))
    alone = {"np_stack_pinned": alone_ms(stack_numpy, rows, buf),
             "torch_stack_pinned": alone_ms(stack_torch, rows, buf)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    alone["torch_stack_pinned_1_thread"] = alone_ms(stack_torch, rows, buf)
    torch.set_num_threads(threads)
    print("stacking one 128-frame batch with no pipeline running, host ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in alone.items()) + f"; on {card}")

    counters = cs.Counters({"normalize_u8": (pre, "LAUNCHES"), "top1": (lab, "LAUNCHES"),
                            "flash_attention": (fa, "LAUNCHES"),
                            "flash_attention_tensor_cores": (fa, "LAUNCHES_TENSOR_CORES")})
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    labels = work / "labels.txt"
    labels.write_text("\n".join(f"class{i}" for i in range(1001)))
    path = ("MobileNet-v2", "arch:mobilenet_v2,dtype:bfloat16", {"normalize_u8": 1, "top1": 1},
            args.frames, args.seed, card, labels)
    modes = {"sync": (cs.SYNC_FEED, feed._stack_into),
             "lane-numpy": ("", stack_numpy), "lane-torch": ("", stack_torch)}
    # a warm-up run pays the process's cuDNN set-up and the kernels' build
    want = cs.run_labeling_path(torch, np, lab, counters, *path)["labels"]
    runs = {m: [] for m in modes}
    order = list(modes)
    for turn in range(args.turns):
        for mode in (order if turn % 2 == 0 else order[::-1]):
            extra, stack = modes[mode]
            feed._stack_into = stack
            r = cs.run_labeling_path(torch, np, lab, counters, *path, extra=extra, busy=True)
            if not np.array_equal(r["labels"], want):
                raise AssertionError(f"{mode}: labels differ from the warm-up run's")
            if extra == "":
                cs.check_feed(mode, r["feed"], r["batches"], window=False)
            runs[mode].append({k: r[k] for k in ("fps", "fps_steady", "latency_ms_p50",
                                                 "latency_ms_p99")}
                              | {k: r["feed"][k] for k in ("stack_ms_per_batch", "busy_share")})
    summary = {}
    for mode, rs in runs.items():
        summary[mode] = {k: statistics.median(x[k] for x in rs) for k in rs[0]
                         if all(x[k] is not None for x in rs)}
        print(f"{mode}, median of {len(rs)} runs: "
              + ", ".join(f"{k} {v:.4g}" for k, v in summary[mode].items()) + f"; on {card}")
    print(json.dumps({"card": card, "stack_alone_ms": alone, "median": summary, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
