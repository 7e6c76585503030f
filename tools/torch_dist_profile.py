#!/usr/bin/env python3
"""Where path n1's time goes on one NVIDIA GPU: camera frames over the raw-TCP
edge into MobileNet-v2, labels out over MQTT QoS 1, everything in one process.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/torch_dist_profile.py [--frames 1024] [--seed 0] [--turns 2]
                                        [--intervals 0.005,0.0005] [--cpu]

It runs ``chip_smoke.run_n1`` (its checks included: every label once, equal
to the direct call, the launch counts and the device-to-host copies) once
per interpreter switch interval (``sys.setswitchinterval``), in turns (A B,
B A, ...), and prints each run's frames/s after the first micro-batch,
push-to-listener p50/p99 and the per-stage p50s (push to the server's
edgesrc, the server to mqttsink's publish, the MQTT leg).  The interval
is the time a thread that holds the interpreter lock keeps it while
another waits: the sender, the server's pipeline, the broker and the
listener share one interpreter, so a shorter interval tests whether their
hand-offs bound the path.  With ``--cpu``, every 20 ms a thread reads the
CPU clock of every other thread (``pthread_getcpuclockid``), and each run
prints the process's CPU seconds against its wall seconds and the 20
threads that used the most CPU (threads of one name summed; a thread's
time after its last reading is missed): which parts of the path burn the
host.  Last, a JSON object with every number and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@contextmanager
def thread_cpu(enabled: bool):
    """CPU seconds by thread name used while the block runs (empty when not
    ``enabled``), read every 20 ms from each live thread's CPU clock."""
    first, last, stop = {}, {}, threading.Event()

    def read():
        for t in threading.enumerate():
            try:
                cpu = time.clock_gettime(time.pthread_getcpuclockid(t.ident))
            except (OSError, TypeError):  # the thread just ended
                continue
            first.setdefault(t.ident, (t.name, cpu))
            last[t.ident] = (t.name, cpu)

    def poll():
        while not stop.wait(0.02):
            read()

    t = threading.Thread(target=poll, name="dist-profile-cpu", daemon=True)
    by_name: Counter = Counter()
    if enabled:
        read()
        t.start()
    try:
        yield by_name
    finally:
        stop.set()
        if enabled:
            t.join(timeout=5)
            read()
            for ident, (name, cpu) in last.items():
                by_name[name] += cpu - first[ident][1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--intervals", default="0.005,0.0005",
                    help="comma-separated switch intervals, seconds")
    ap.add_argument("--cpu", action="store_true",
                    help="read every thread's CPU clock during each run")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as c
    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.ops import labeling as lab

    if not torch.cuda.is_available():
        raise SystemExit("torch_dist_profile.py: no CUDA device")
    card = c.card_line()
    c.tf32_off(torch)
    _build.build(["normalize_u8", "top1"])
    counters, work = c.kernel_counters(), c.work_dir()
    labels = work / "labels.txt"
    rng = np.random.default_rng(args.seed + 21)
    images = rng.integers(0, 256, (args.frames, 224, 224, 3), dtype=np.uint8)
    intervals = [float(x) for x in args.intervals.split(",")]
    default = sys.getswitchinterval()
    runs = []
    for turn in range(args.turns):
        for interval in intervals if turn % 2 == 0 else intervals[::-1]:
            sys.setswitchinterval(interval)
            try:
                with thread_cpu(args.cpu) as cpu:
                    t0, p0 = time.perf_counter(), time.process_time()
                    r = c.run_n1(torch, np, lab, counters, args.seed, images, labels, work)
                    wall, proc = time.perf_counter() - t0, time.process_time() - p0
            finally:
                sys.setswitchinterval(default)
            row = {"interval_s": interval, "turn": turn, "fps_steady": r["fps_steady"],
                   "latency_ms_p50": r["latency_ms_p50"], "latency_ms_p99": r["latency_ms_p99"],
                   "mqtt_leg_ms_p50": r["mqtt_leg_ms_p50"], "stage_ms_p50": r["stage_ms_p50"],
                   "batches": r["batches"], "mqtt_frames_fps": r["b"]["fps"],
                   "seconds": wall, "cpu_seconds": proc}
            if cpu:
                row["thread_cpu_s"] = [[name, round(v, 4)] for name, v in cpu.most_common(20)]
            runs.append(row)
            print(f"switch interval {interval} s (turn {turn}): {r['fps_steady']:.1f} frames/s "
                  f"after the first micro-batch, push-to-listener p50 "
                  f"{r['latency_ms_p50']:.2f} ms p99 {r['latency_ms_p99']:.2f} ms, stage p50s "
                  f"{r['stage_ms_p50']}, {r['batches']} micro-batches; n1b "
                  f"{r['b']['fps']:.1f} frames/s; on {card}", flush=True)
            if cpu:
                print(f"  run_n1 {wall:.2f} s wall, {proc:.2f} s of process CPU; the threads "
                      "using the most:")
                for name, v in row["thread_cpu_s"]:
                    print(f"  {v:8.3f} s  {name}")
            torch.cuda.empty_cache()
    print(json.dumps({"dist_profile": runs, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
