#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nnstreamer_tpu_torch``) on
one NVIDIA GPU.  Run from the root of a checkout::

    python3 chip_smoke.py [--frames 2048] [--seed 0]

Phases (any failure exits non-zero before the result lines are printed):

1. device: a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA kernel of the main path from ``csrc/`` with
   nvcc (one process per source, in parallel) and prints the seconds.
3. kernels: calls each kernel's wrapper on the card at the main path's
   shapes and at awkward ones (ragged lengths, unaligned starts, ties,
   -inf and NaN rows) and holds it against its plain PyTorch version:
   bit-equal for ``normalize_u8``, index- and value-equal (NaN positions
   included) for ``top1``.  Times each with CUDA events (median of 25
   runs of 10 launches each, queued behind a device sleep so host launch
   overhead is not counted) beside its plain version, the one PyTorch
   call computing the same function where there is one, and the least
   time the card could take (the larger of bytes over memory bandwidth and
   operations over peak rate, H100 SXM data sheet).
4. main path: the MobileNet-v2 image-labeling pipeline at full width
   (224x224, width 1.0, 1001 classes, bf16, random weights from a seed)
   through ``parse_pipeline`` with ``framework=torch-cuda``, ``--frames``
   seeded uint8 frames pushed one by one.  Every frame must come back
   with a label index in [0, 1001); both kernels' launch counters, zeroed
   just before, must have moved at least once per micro-batch; the labels
   must equal those of the same model called directly on the frames in
   batches of 128 followed by ``top1_plain``.  Prints frames/s, the
   end-to-end frame latency and the per-batch model latency.
5. summary: one ``{"kernels": [...]}`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside the
# tensor cores (the kernels here do scalar float32 work)
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median device time of one ``fn()`` call, from CUDA events around
    `inner` back-to-back calls queued behind a device sleep."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues every launch first
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t):
    import torch

    return t.view({torch.float32: torch.int32}.get(t.dtype, torch.int16))


def check_normalize(torch, pre) -> dict:
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    main = torch.randint(0, 256, (128, 224, 224, 3), dtype=torch.uint8, device=dev, generator=g)
    flat = torch.randint(0, 256, (1_000_003 + 64,), dtype=torch.uint8, device=dev, generator=g)
    cases = [(main, torch.bfloat16), (main, torch.float32), (flat[:1_000_003], torch.float16)]
    # unaligned starts: vector stores (output 16-byte aligned at the first
    # aligned input byte) and element stores (it is not)
    for offset in (1, 3, 8, 12):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((flat[offset:offset + 999_999], dtype))
    cases.append((flat[5:5 + 7], torch.bfloat16))  # shorter than one vector
    err = 0.0
    for x, dtype in cases:
        got, want = pre.normalize_u8(x, dtype=dtype), pre.normalize_u8_plain(x, dtype=dtype)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(bits(got), bits(want)):
            diff = (got.float() - want.float()).abs().max().item()
            raise AssertionError(
                f"normalize_u8 {tuple(x.shape)}@{x.storage_offset()} -> {dtype}: "
                f"not bit-equal to the plain version (max abs diff {diff})")
        err = max(err, (got.float() - want.float()).abs().max().item())
    n = main.numel()
    kernel = time_ms(lambda: pre.normalize_u8(main))
    plain = time_ms(lambda: pre.normalize_u8_plain(main))
    bound, by = bound_ms(n * (1 + 2), 2 * n)  # uint8 in, bf16 out; a multiply and an add
    print(f"normalize_u8 {tuple(main.shape)} uint8->bf16: {len(cases)} cases bit-equal; "
          f"kernel {kernel:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"name": "normalize_u8", "route": "cuda",
            "source": "nnstreamer_tpu_torch/csrc/normalize_u8.cu",
            "replaces": "nnstreamer_tpu/ops/preprocess.py:36",
            "max_abs_err": err, "ms": kernel, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "match": True}


def check_top1(torch, lab) -> dict:
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    main = torch.randn(128, 1001, device=dev, generator=g)
    main[1, [7, 500, 1000]] = 40.0  # ties: the first index wins
    main[2, :] = 3.0  # a whole row tied
    main[3, :] = float("-inf")  # all -inf: index 0
    main[4, [9, 900]] = float("nan")  # NaN is the maximum: the first NaN wins
    main[5, 1000] = float("inf")  # the ragged tail (1001 = 31 * 32 + 9)
    cases = [main, torch.randn(1, 1, device=dev, generator=g),
             torch.randn(37, 31, device=dev, generator=g),
             torch.randn(300, 4097, device=dev, generator=g)]
    err = 0.0
    for x in cases:
        (idx, val), (ridx, rval) = lab.top1(x), lab.top1_plain(x)
        torch.cuda.synchronize()
        nan = torch.isnan(rval)
        if not (torch.equal(idx, ridx) and torch.equal(torch.isnan(val), nan)
                and torch.equal(val[~nan], rval[~nan])):
            raise AssertionError(f"top1 {tuple(x.shape)}: differs from the plain version")
        finite = ~nan & torch.isfinite(rval)
        err = max(err, (val[finite] - rval[finite]).abs().max().item() if finite.any() else 0.0)
    rows, cols = main.shape
    kernel = time_ms(lambda: lab.top1(main))
    plain = time_ms(lambda: lab.top1_plain(main))
    library = time_ms(lambda: torch.max(main, dim=1))
    bound, by = bound_ms(rows * cols * 4 + rows * 8, rows * cols)  # one compare per element
    print(f"top1 {tuple(main.shape)} float32: {len(cases)} cases equal (ties, -inf, NaN); "
          f"kernel {kernel:.4f} ms, plain {plain:.4f} ms, torch.max {library:.4f} ms, "
          f"bound {bound:.5f} ms ({by})")
    return {"name": "top1", "route": "cuda", "source": "nnstreamer_tpu_torch/csrc/top1.cu",
            "replaces": "nnstreamer_tpu/ops/labeling.py:29",
            "max_abs_err": err, "ms": kernel, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": library, "match": True}


def run_main_path(torch, np, pre, lab, frames: int, seed: int, card: str) -> dict:
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    labels = work / "labels.txt"
    labels.write_text("\n".join(f"class{i}" for i in range(1001)))
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (frames, 224, 224, 3), dtype=np.uint8)

    pre.LAUNCHES = lab.LAUNCHES = 0
    pipe = parse_pipeline(
        "appsrc name=src ! tensor_filter name=f framework=torch-cuda model=zoo "
        f"custom=arch:mobilenet_v2,dtype:bfloat16,seed:{seed} max-batch=128 batch-timeout=20 "
        f"! tensor_decoder mode=image_labeling option1={labels} ! tensor_sink name=out")
    arrived = {}
    pipe["out"].connect_new_data(lambda f: arrived.__setitem__(int(f.pts), time.perf_counter()))
    pipe.start()
    try:
        pushed = []
        t0 = time.perf_counter()
        for i in range(frames):
            pushed.append(time.perf_counter())
            pipe["src"].push(images[i], pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=600)
        wall = time.perf_counter() - t0
        launches = {"normalize_u8": pre.LAUNCHES, "top1": lab.LAUNCHES}
        batches = pipe["f"].invokes
        module = pipe["f"].backend._module
        out = pipe["out"].frames
        if len(out) != frames or [f.pts for f in out] != list(range(frames)):
            raise AssertionError(f"{len(out)} of {frames} frames came back, or out of order")
        got = np.array([f.meta["label_index"] for f in out])
        if not ((got >= 0) & (got < 1001)).all() or out[0].meta["label"] != f"class{got[0]}":
            raise AssertionError("a label index outside [0, 1001)")
        for name, n in launches.items():
            if n < batches:
                raise AssertionError(f"{name}: {n} launches for {batches} micro-batches")
        # reference: the same module called directly, batches of 128, then
        # top1_plain; bf16 convolutions and the float32 classifier (TF32 off)
        want, batch_s = [], []
        with torch.inference_mode():
            for k in range(0, frames, 128):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits = module(torch.from_numpy(images[k:k + 128]).cuda())
                want.append(lab.top1_plain(logits)[0].cpu().numpy())
                batch_s.append(time.perf_counter() - t)
        want = np.concatenate(want)
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            raise AssertionError(
                f"{len(bad)} pipeline labels differ from the direct call (first frames {bad[:8]})")
    finally:
        pipe.stop()
    lat = sorted(arrived[i] - pushed[i] for i in range(frames))
    fps = frames / wall
    # steady state: from the first micro-batch's arrival (it carries the
    # card's lazy set-up: cuDNN handles, kernel selection) to the last
    first = min(127, frames - 1)
    span = max(arrived.values()) - arrived[first]
    steady = (frames - first - 1) / span if span > 0 else float("nan")
    p50, p99 = lat[len(lat) // 2] * 1e3, lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    batch_ms = statistics.median(batch_s[1:] or batch_s) * 1e3
    print(f"main path: {frames} frames in {batches} micro-batches, labels equal to the direct "
          f"call; launches {launches}")
    print(f"main path: {fps:.1f} frames/s overall, {steady:.1f} frames/s after the first "
          f"micro-batch; frame latency (push to sink) p50 {p50:.2f} ms p99 {p99:.2f} ms; "
          f"direct model call per 128-frame batch (copy in, model, top1, copy out) "
          f"{batch_ms:.2f} ms (host clock, synchronized); on {card}")
    return {"launches": launches, "batches": batches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2048, help="frames pushed through the pipeline")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the frames")
    args = ap.parse_args()

    if not (ROOT / "nnstreamer_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: run from a checkout (nnstreamer_tpu_torch/ not found)")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; card {card}")
    # float32 references compare exactly only without TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for convolutions and matmuls (float32 comparisons)")

    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.ops import labeling as lab
    from nnstreamer_tpu_torch.ops import preprocess as pre

    t = time.perf_counter()
    _build.build(["normalize_u8", "top1"])
    print(f"build: {time.perf_counter() - t:.1f} s (nvcc, sm_90a, both kernels in parallel)")

    kernels = [check_normalize(torch, pre), check_top1(torch, lab)]
    run = run_main_path(torch, np, pre, lab, args.frames, args.seed, card)
    for k in kernels:
        k["launches"] = run["launches"][k["name"]]
        k["launches_per_microbatch"] = k["launches"] / run["batches"]

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
