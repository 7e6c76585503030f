#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nnstreamer_tpu_torch``) on
one NVIDIA GPU.  Run from the root of a checkout::

    python3 chip_smoke.py [--frames 2048] [--vit-frames 1024] [--prompts 16] [--seed 0]

Phases (any failure exits non-zero before the result lines are printed):

1. device: a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA kernel of the paths from ``csrc/``
   with nvcc (one process per source, all started together) and prints
   the seconds.
3. kernels: calls each kernel's wrapper on the card at the paths' shapes
   and at awkward ones and holds it against its plain PyTorch version:
   bit-equal for ``normalize_u8`` (ragged lengths, unaligned starts),
   index- and value-equal for ``top1`` and ``top1_packed`` (float32,
   bfloat16 and float16; ties, -inf and NaN rows, a row stride of 1024
   for 1001 columns, rows starting at element offsets 1 and 3), and for
   ``flash_attention`` within atol = rtol = 2e-5 in float32, 1e-2 for
   bfloat16 outputs (compared in float32: about one bf16 ulp), 1e-4 for
   the lse, on both routes (bfloat16 on the tensor cores, float32 on the
   CUDA cores): ViT-B/16 and GPT-2-small shapes as the models lay q, k, v
   out, ragged T (causal T = 1000), T = 1, D of 8, 32, 40, 96 and 128,
   Tq < Tk with a ragged Tk of 300, Tq > Tk, (B, H, T, D) storage read as
   (B, T, H, D), odd token strides on the float32 route; and bfloat16
   views the kernel cannot read (a base off by one element, a token
   stride of H*D + 4) must raise without a launch.  Times each with CUDA
   events (median of 25 runs of 10 launches each, queued behind a device
   sleep so host launch overhead is not counted) beside its plain version,
   the one PyTorch call computing the same function where there is one
   (``torch.max``, ``scaled_dot_product_attention``), and the least time
   the card could take (the larger of bytes over memory bandwidth and
   operations over the peak rate of their type, H100 SXM data sheet);
   flash attention in bfloat16 at both paths' shapes and in float32 at
   ViT-B/16's.  ``top1`` is also timed packed, as the three-launch
   composition it replaces in the decoder's device half (split kernel,
   ``.to``, ``torch.stack``), in bfloat16, and beside an empty launch
   (the launch floor); the host ms per ``device_fn`` call of both
   compositions (100 calls queued behind a device sleep, median of 7);
   and ``torch.profiler`` must see exactly one kernel in one
   ``device_fn`` call.
4. paths, each driven through ``parse_pipeline`` with
   ``framework=torch-cuda`` at full width with random weights from
   ``--seed``, with the filter's asynchronous feed at its defaults
   (``ingest-lane=auto dispatch-depth=4``: the lane must stage every
   micro-batch and, where outputs go to the host through the dispatch
   window, the window must reap every invoke; a synchronous fallback fails
   the run), every launch counter set to 0 just before and read just
   after; each kernel of the path must have launched (at least once per
   micro-batch; flash attention once per layer per micro-batch, every one
   of them on the bfloat16 tensor-core route; ``top1`` exactly once per
   micro-batch), and the
   outputs must equal those of the same module called directly on the
   same inputs in the pipeline's own micro-batch sizes (so both see the
   same shapes), followed by the plain ``top1``:
   a. MobileNet-v2 image labeling (224x224, 1001 classes, bf16),
      ``--frames`` uint8 frames pushed one by one; then again with
      ``ingest-lane=off dispatch-depth=1`` (the synchronous filter), whose
      labels must equal the defaults'; each mode's card busy share over a
      steady window (a second pipeline, ``torch.profiler``);
   e. the same MobileNet-v2 composed with NNStreamer's stream elements
      (run right after path a):
      1. host frames, timed: ``videotestsrc`` (--frames/2 random 224x224
         frames from --seed) ``! tensor_converter ! tee``, one branch
         ``queue ! tensor_filter ! tensor_decoder``, the other ``queue !
         tensor_transform`` (typecast, add -127.5, div 127.5) ``!
         tensor_transform`` (clamp -1:1), joined by ``tensor_mux`` and parted
         by ``tensor_demux``: labels equal to the direct call in the same
         micro-batch sizes, every preprocessed tensor bit-equal to numpy's
         ``clip((x.astype(float32) + -127.5) / 127.5, -1, 1)``, frame i of
         both branches paired, ``normalize_u8`` and ``top1`` exactly once
         per micro-batch (the filter derives its schema without a model
         call); frames/s and latency beside path a's;
      2. card frames, not timed: 256 of the frames pushed through
         ``appsrc`` as CUDA tensors into a ``tee`` feeding every
         ``tensor_transform`` mode, an ``apply=`` subset behind a
         ``tensor_mux``, ``tensor_merge ! tensor_split ! tensor_aggregator``,
         ``tensor_if`` (channel means near 64 and 128 against 100),
         ``tensor_crop`` against a second source of fixed regions, and the
         MobileNet filter (batch-through, its micro-batches kept whole at one
         sink and split into card rows by the scheduler for a
         ``tensor_transform`` and by a ``split-batches`` sink): every output
         reaching a sink must be a CUDA tensor, each transform's torch route must have run on
         every frame, and the outputs must equal those of the same pipeline
         fed the same frames as numpy arrays (``stand`` within rtol and atol
         1e-5, the rest bit for bit; tensor_if decisions and labels exact).
   b. ViT-B/16 image labeling (224x224, patch 16, 768 wide, 12 heads, 12
      layers, MLP 3072, 1001 classes, bf16, ``attn:flash``),
      ``--vit-frames`` frames; plus, on 8 frames, a float32 copy of the
      module with attention by the kernel against the same copy with
      attention by ``flash_attention_plain`` (TF32 off), within 1e-4;
   c. GPT-2-small scoring (vocab 50257, 768 wide, 12 heads, 12 layers,
      MLP 3072, 1024 tokens, bf16, ``attn:flash``): ``--prompts`` prompts
      of 1024 tokens, full-sequence logits; the per-position argmax of
      every returned (1024, 50257) frame must equal the direct call's,
      and the synchronous mode's; before it, the host ms of one logits
      batch to the host (pageable ``.cpu()``, pinned allocation fresh and
      cached, the copy into pinned memory).
   d. GPT-2-small generation (the same model, seed and custom; the
      KV-cache path computes attention densely in float32, as the JAX
      package's decode does, so no kernel may launch on it):
      1. ``generate:32`` through the filter (``max-batch=8``), 8 prompts of
         128 tokens pushed one by one, equal to the direct call, staged by
         the lane and reaped by the window;
      2. float32: KV-cache greedy tokens (2 prompts of 128, 16 new) equal
         to re-running the full forward (``attn:xla``) per token up to the
         first step whose top-2 logit margin is under 1e-3;
      3. 32 prompts of seeded lengths 64-448 pushed at once through
         ``tensor_generator slots=16 max-new=64 chunk=16
         prefill-chunk=128``, every stream's chunk meta well-formed, the
         first 8 also through ``slots=0``; tokens/s of both, time to first
         chunk and chunk interval p50/p99, the decode step's wall, device
         and host ms, busy share and host synchronizations per call
         (``torch.profiler``), KV-cache bytes and ``max_memory_allocated``;
         then, in bf16, one prompt alone in ``slots=16`` and the same prompt
         among 15 others: its tokens must be equal (neighbour independence);
      4. float32: 8 prompts through ``slots=4`` equal to one-shot B = 1
         under the same margin rule;
      5. threefry bits and uniforms of a (16, 50257) draw bit-equal on the
         card and the CPU; with temperature 0.8, top_k 40, gen_seed 1, a
         single slotted occupant equal to one-shot B = 1 up to a top-2
         margin of logits/T + gumbel under 1e-3 (4 prompts).
   f. the vision families with their decoders' device halves fused into
      the filter (``normalize_u8`` bit-exact beforehand also at YOLOv5s's
      scale 1/255 and bias 0 and at the 300 and 257 shapes, and timed at
      (128, 640, 640, 3); ``batched_nms`` alone timed at (128, 128) and
      (128, 300)): SSD-MobileNet-v2 300 (91 classes, ``mobilenet-ssd``
      with ``write_box_priors``), YOLOv5s 640 (80 classes, ``yolov5``),
      PoseNet 257 (17 keypoints, ``heatmap-offset``) and DeepLab 257 (21
      classes, ``tflite-deeplab``), bf16, ``VISION_FRAMES`` (384) frames
      each pushed one by one at ``max-batch=128``; the box decoders' score
      threshold sits midway between two candidate scores, about 20 a
      frame over it on the first 16 frames.  Each must be fused, leave the
      filter as the small fused tensors on the card (bytes a frame
      printed beside the raw head's), launch ``normalize_u8`` exactly once
      per micro-batch and nothing else, reach the sink equal to the same
      module called directly in the first micro-batch's size; that
      micro-batch's device half on the card must equal the same half on
      the CPU fed the raw head copied from the card (keep pattern,
      classes, class grids and argmaxes exact, floats within a few float32
      ulps) except where a near-tie (a score within 1e-6 of a threshold
      or of its neighbour in the sort, an IoU within 1e-6 of ``iou_thr``,
      top-2 values within 1e-6), which is counted, may change the result:
      the tied pixel or keypoint, or the tied box candidates and those the
      NMS lets a flipped keep reach; 4 frames through
      ``device-fused=never`` must equal the fused run within the
      tolerances of JAX ``tests/test_device_fusion.py:188-196`` under the
      same rule; and a float32 build on the card (TF32 off) must equal the
      same build on the CPU on 2 frames (rtol 1e-4, atol 1e-4 of the
      output's largest magnitude, which is printed with the count of
      elements outside a fixed 1e-4).
   Prints frames/s or sequences/s and tokens/s, latencies, the direct
   per-batch time and the feed's counters (lane staged and stacking ms per
   batch, window reaped, dispatch_waits and dwell, staging pool reuse rate)
   beside the card line.
5. summary: a ``{"feed_ab": {...}}`` JSON line (paths a and c in both
   modes), a ``{"generation": {...}}`` JSON line (path d's numbers), a
   ``{"composed": {...}}`` JSON line (path e's numbers), a
   ``{"vision": {...}}`` JSON line (path f's numbers), one
   ``{"kernels": [...]}`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 bandwidth, the float32 rate outside the tensor
# cores, the dense bf16 tensor-core rate
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

VIT_CUSTOM = ("arch:vit,size:224,patch:16,d_model:768,heads:12,layers:12,d_ff:3072,"
              "classes:1001,attn:flash,dtype:bfloat16")
LM_CUSTOM = ("arch:transformer,vocab:50257,d_model:768,heads:12,layers:12,d_ff:3072,seq:1024,"
             "attn:flash,dtype:bfloat16")


def custom_props(custom: str) -> dict:
    """``k1:v1,k2:v2`` as a dict."""
    return dict(item.split(":", 1) for item in custom.split(","))


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


def host_ms(torch, fn, calls: int = 100, reps: int = 7) -> float:
    """Median host time of one ``fn()`` call while the card sleeps (~100
    ms per rep, far longer than the calls take to queue): what a call costs
    the host (Python, allocation, ctypes, the launches)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(200_000_000)
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) / calls * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def cuda_kernels(torch, fn) -> list:
    """Names of the CUDA kernels one ``fn()`` call runs, from
    ``torch.profiler`` (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a process's first profile may record no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        if names:
            break
    return names


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
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
    # path f's shapes: SSD 300, PoseNet and DeepLab 257 ([-1, 1]), YOLOv5s
    # 640 at scale 1/255 and bias 0
    yolo = torch.randint(0, 256, (128, 640, 640, 3), dtype=torch.uint8, device=dev, generator=g)
    for shape in ((8, 300, 300, 3), (8, 257, 257, 3)):
        cases.append((main.reshape(-1)[:torch.Size(shape).numel()].reshape(shape), torch.bfloat16))
    scaled = [(yolo, torch.bfloat16), (yolo[:4], torch.float32)]
    err = 0.0
    for (x, dtype), scale, bias in ([(c, 2.0 / 255.0, -1.0) for c in cases]
                                    + [(c, 1.0 / 255.0, 0.0) for c in scaled]):
        got = pre.normalize_u8(x, scale, bias, dtype=dtype)
        want = pre.normalize_u8_plain(x, scale, bias, dtype=dtype)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(bits(got), bits(want)):
            diff = (got.float() - want.float()).abs().max().item()
            raise AssertionError(
                f"normalize_u8 {tuple(x.shape)}@{x.storage_offset()} -> {dtype} (scale {scale}, "
                f"bias {bias}): not bit-equal to the plain version (max abs diff {diff})")
        err = max(err, (got.float() - want.float()).abs().max().item())
    n = main.numel()
    kernel = time_ms(lambda: pre.normalize_u8(main))
    plain = time_ms(lambda: pre.normalize_u8_plain(main))
    bound, by = bound_ms(n * (1 + 2), 2 * n)  # uint8 in, bf16 out; a multiply and an add
    ny = yolo.numel()
    yolo_ms = time_ms(lambda: pre.normalize_u8(yolo, 1.0 / 255.0, 0.0))
    yolo_plain = time_ms(lambda: pre.normalize_u8_plain(yolo, 1.0 / 255.0, 0.0))
    yolo_bound, yolo_by = bound_ms(ny * (1 + 2), 2 * ny)
    print(f"normalize_u8 {tuple(main.shape)} uint8->bf16: {len(cases) + len(scaled)} cases "
          f"bit-equal; kernel {kernel:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by}); "
          f"{tuple(yolo.shape)} at scale 1/255, bias 0: kernel {yolo_ms:.4f} ms, plain "
          f"{yolo_plain:.4f} ms, bound {yolo_bound:.4f} ms ({yolo_by})")
    return {"name": "normalize_u8", "route": "cuda",
            "source": "nnstreamer_tpu_torch/csrc/normalize_u8.cu",
            "replaces": "nnstreamer_tpu/ops/preprocess.py:36",
            "max_abs_err": err, "ms": kernel, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "match": True,
            "yolov5s_640": {"shape": list(yolo.shape), "ms": yolo_ms, "plain_ms": yolo_plain,
                            "bound_ms": yolo_bound, "bound_by": yolo_by}}


def same_values(a, b) -> bool:
    """Equal shapes and values, NaN where the other has NaN."""
    import torch

    nan = torch.isnan(b)
    return (a.shape == b.shape and torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan], b[~nan]))


def top1_cases(torch, dtype, g) -> list:
    """(label, logits) pairs in `dtype` on the card: the paths' (128, 1001)
    with planted ties, -inf and NaN rows, small and long rows, and strided
    and misaligned views of it whose neighbours outside the view are +inf
    (a kernel reading past its row would pick them)."""
    dev = torch.device("cuda", 0)
    main = torch.randn(128, 1001, device=dev, generator=g)
    main[1, [7, 500, 1000]] = 40.0  # ties: the first index wins
    main[2, :] = 3.0  # a whole row tied
    main[3, :] = float("-inf")  # all -inf: index 0
    main[4, [9, 900]] = float("nan")  # NaN is the maximum: the first NaN wins
    main[5, 1000] = float("inf")  # the ragged tail
    main = main.to(dtype)
    wide = torch.full((128, 1024), float("inf"), device=dev, dtype=dtype)
    wide[:, :1001] = main
    cases = [("(128, 1001)", main), ("[:, :1001] of (128, 1024)", wide[:, :1001])]
    for offset in (1, 3):  # row r starts at element offset + 1001 * r
        flat = torch.full((128 * 1001 + 8,), float("inf"), device=dev, dtype=dtype)
        view = flat[offset:offset + 128 * 1001].view(128, 1001)
        view.copy_(main)
        cases.append((f"(128, 1001) at element offset {offset}", view))
    for shape in ((1, 1), (37, 31), (300, 4097)):
        cases.append((str(shape), torch.randn(*shape, device=dev, generator=g).to(dtype)))
    return cases


def check_top1(torch, lab) -> dict:
    from nnstreamer_tpu_torch.decoders.image_label import ImageLabeling

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    n = err = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for label, x in top1_cases(torch, dtype, g):
            (idx, val), (ridx, rval) = lab.top1(x), lab.top1_plain(x)
            packed, rpacked = lab.top1_packed(x), lab.top1_packed_plain(x)
            torch.cuda.synchronize()
            if not (torch.equal(idx, ridx) and same_values(val, rval)):
                raise AssertionError(f"top1 {label} {dtype}: differs from the plain version")
            if not same_values(packed, rpacked):
                raise AssertionError(f"top1_packed {label} {dtype}: differs from the plain version")
            finite = torch.isfinite(rval)
            err = max(err, (val[finite] - rval[finite]).abs().max().item() if finite.any() else 0.0)
            n += 1
    main = top1_cases(torch, torch.float32, g)[0][1]
    main_bf16 = main.to(torch.bfloat16)
    rows, cols = main.shape

    decoder = ImageLabeling()

    def three_launches(outs):  # the device half as three launches: split kernel, .to, stack
        idx, score = lab.top1(outs[0])
        return [torch.stack([idx.to(torch.float32), score], dim=-1)]

    one = cuda_kernels(torch, lambda: decoder.device_fn([main]))
    three = cuda_kernels(torch, lambda: three_launches([main]))
    if len(one) != 1 or "top1" not in one[0] or len(three) != 3:
        raise AssertionError(f"device_fn ran kernels {one} (want only top1's), the "
                             f"three-launch composition {three} (want 3)")
    t = {"ms": time_ms(lambda: lab.top1(main)),
         "packed_ms": time_ms(lambda: lab.top1_packed(main)),
         "three_launch_ms": time_ms(lambda: three_launches([main])),
         "library_ms": time_ms(lambda: torch.max(main, dim=1)),
         "plain_ms": time_ms(lambda: lab.top1_plain(main)),
         "packed_plain_ms": time_ms(lambda: lab.top1_packed_plain(main)),
         "launch_floor_ms": time_ms(lambda: torch.cuda._sleep(0)),
         "bf16_ms": time_ms(lambda: lab.top1(main_bf16)),
         "host_ms_device_fn": host_ms(torch, lambda: decoder.device_fn([main])),
         "host_ms_three_launch": host_ms(torch, lambda: three_launches([main]))}
    bound, by = bound_ms(rows * cols * 4 + rows * 8, rows * cols)  # one compare per element
    bf16_bound, _ = bound_ms(rows * cols * 2 + rows * 8, rows * cols)
    print(f"top1: {n} cases (float32, bfloat16, float16; ties, -inf, NaN, strided and "
          f"misaligned rows) index- and value-equal to the plain versions, split and packed")
    print(f"top1 {tuple(main.shape)} float32: kernel {t['ms']:.4f} ms, packed {t['packed_ms']:.4f} "
          f"ms, three-launch composition {t['three_launch_ms']:.4f} ms, torch.max "
          f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, packed plain "
          f"{t['packed_plain_ms']:.4f} ms, empty launch {t['launch_floor_ms']:.4f} ms, bound "
          f"{bound:.5f} ms ({by}); bfloat16 kernel {t['bf16_ms']:.4f} ms (bound {bf16_bound:.5f})")
    print(f"top1 device half: device_fn runs {len(one)} kernel ({one[0]}), the three-launch "
          f"composition {len(three)}; host ms per call {t['host_ms_device_fn']:.4f} against "
          f"{t['host_ms_three_launch']:.4f}")
    return {"name": "top1", "route": "cuda", "source": "nnstreamer_tpu_torch/csrc/top1.cu",
            "replaces": "nnstreamer_tpu/ops/labeling.py:29", "max_abs_err": err, **t,
            "bound_ms": bound, "bound_by": by, "bf16_bound_ms": bf16_bound, "cases": n,
            "device_fn_kernels": len(one), "three_launch_kernels": len(three), "match": True}


def tf32_off(torch) -> None:
    """float32 references compare exactly only without TF32: turn it off
    for convolutions and matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for convolutions and matmuls (float32 comparisons)")


def check_flash(torch, fa) -> dict:
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {f32: 2e-5, bf16: 1e-2}

    def qkv(b, tq, h, d, dtype, tk=None, layout="plain"):
        if layout == "fused":  # the models' layout: (B, T, H, D) views of one qkv projection
            x = torch.randn(b, tq, 3 * h * d, device=dev, generator=g).to(dtype)
            return [a.reshape(b, tq, h, d) for a in x.split(h * d, dim=-1)]
        ts = (tq, tk or tq, tk or tq)
        if layout == "bhtd":  # (B, H, T, D) storage: head stride T*D, token stride D
            return [torch.randn(b, h, t, d, device=dev, generator=g).to(dtype).transpose(1, 2)
                    for t in ts]
        if layout == "odd":  # token stride H*D + 4: not a multiple of 8
            return [torch.randn(b, t, h * d + 4, device=dev, generator=g).to(dtype)[..., :h * d]
                    .reshape(b, t, h, d) for t in ts]
        return [torch.randn(b, t, h, d, device=dev, generator=g).to(dtype) for t in ts]

    # (label, shape (B, Tq, H, D), Tk, dtype, causal, how q/k/v are laid out)
    cases = [
        ("ViT-B/16", (128, 197, 12, 64), None, bf16, False, "fused"),
        ("GPT-2 small", (8, 1024, 12, 64), None, bf16, True, "fused"),
        ("f32 ragged", (2, 100, 2, 64), None, f32, False, "plain"),
        ("f32 ragged", (2, 100, 2, 64), None, f32, True, "fused"),
        ("T=1", (2, 1, 2, 64), None, f32, True, "plain"),
        ("T=1", (2, 1, 2, 64), None, bf16, False, "fused"),
        ("D=32", (2, 77, 3, 32), None, f32, True, "plain"),
        ("D=32", (2, 77, 3, 32), None, bf16, False, "fused"),
        ("D=128", (2, 130, 2, 128), None, f32, False, "fused"),
        ("D=128", (2, 130, 2, 128), None, bf16, True, "plain"),
        ("lse Tq!=Tk", (2, 128, 2, 64), 320, f32, False, "plain"),
        ("lse Tq!=Tk", (2, 128, 2, 64), 320, bf16, False, "plain"),
        ("lse T=197", (2, 197, 2, 64), None, f32, True, "fused"),
        ("lse T=197", (2, 197, 2, 64), None, bf16, True, "plain"),
        # the tensor-core route's padded contraction (D to 64 or 128)
        ("D=8", (2, 77, 3, 8), None, bf16, False, "plain"),
        ("D=8", (2, 77, 3, 8), None, bf16, True, "fused"),
        ("D=40", (2, 130, 2, 40), None, bf16, True, "fused"),
        ("D=40", (2, 130, 2, 40), None, bf16, False, "plain"),
        ("D=128", (2, 130, 2, 128), None, bf16, False, "fused"),
        ("D=96", (2, 130, 2, 96), None, bf16, True, "fused"),
        ("causal T=1000", (2, 1000, 2, 64), None, bf16, True, "fused"),
        ("lse ragged Tk=300", (2, 128, 2, 64), 300, bf16, False, "plain"),
        ("lse ragged Tk=300", (2, 197, 3, 64), 300, bf16, False, "bhtd"),
        ("lse Tq>Tk", (2, 300, 2, 64), 70, bf16, False, "plain"),
        ("(B,H,T,D) storage", (2, 200, 3, 64), None, bf16, True, "bhtd"),
        ("odd token stride", (2, 100, 2, 64), None, f32, False, "odd"),
    ]
    err = lse_err = 0.0
    for label, (b, tq, h, d), tk, dtype, causal, layout in cases:
        q, k, v = qkv(b, tq, h, d, dtype, tk, layout)
        want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal, with_lse=True)
        outs = [fa.flash_attention(q, k, v, causal=causal)]
        if label.startswith("lse"):
            out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
            outs.append(out)
            torch.cuda.synchronize()
            e = (lse - want_lse).abs().max().item()
            if lse.shape != want_lse.shape or not e <= 1e-4:
                raise AssertionError(f"flash_attention_lse {label} {dtype}: lse off by {e}")
            lse_err = max(lse_err, e)
        torch.cuda.synchronize()
        for got in outs:
            if got.shape != want.shape or got.dtype != dtype or not torch.allclose(
                    got.float(), want.float(), atol=tol[dtype], rtol=tol[dtype]):
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"flash_attention {label} {(b, tq, h, d)} {dtype} "
                                     f"causal={causal}: off the plain version by {diff}")
            err = max(err, (got.float() - want.float()).abs().max().item())
    # what the bfloat16 kernel's TMA reads cannot take raises, never falls back
    refused = 0
    flat = torch.randn(2 * 64 * 2 * 64 + 8, device=dev, generator=g).to(bf16)
    bad_views = {"16-byte aligned": flat[1:1 + 2 * 64 * 2 * 64].view(2, 64, 2, 64),
                 "multiples of 8": qkv(2, 64, 2, 64, bf16, layout="odd")[0]}
    for match, bad in bad_views.items():
        ok = torch.randn(2, 64, 2, 64, device=dev, generator=g).to(bf16)
        before = fa.LAUNCHES
        try:
            fa.flash_attention(bad, ok, ok, causal=False)
        except ValueError as e:
            if match not in str(e) or fa.LAUNCHES != before:
                raise AssertionError(f"flash_attention on a misaligned view: {e}") from e
            refused += 1
        else:
            raise AssertionError(f"flash_attention took a view that is not {match}")
    print(f"flash_attention: {len(cases)} cases within tolerance of the plain version "
          f"(f32 atol=rtol=2e-5, bf16 1e-2, lse 1e-4); max abs err {err:.3g}, lse {lse_err:.3g}; "
          f"{refused} misaligned bf16 views refused")

    shapes = []
    for label, shape, causal, dtype in (("ViT-B/16", (128, 197, 12, 64), False, bf16),
                                        ("GPT-2 small", (8, 1024, 12, 64), True, bf16),
                                        ("ViT-B/16", (128, 197, 12, 64), False, f32)):
        b, t, h, d = shape
        q, k, v = qkv(b, t, h, d, dtype, layout="fused")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kernel = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal))
        library = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
        ops = 4 * b * h * t * t * d / (2 if causal else 1)
        route = fa.route(dtype)
        rate = BF16_OPS_PER_S if route == "tensor_cores" else FP32_OPS_PER_S
        nbytes = 4 * b * t * h * d * q.element_size()  # q, k, v in; out
        bound, by = bound_ms(nbytes, ops, rate)
        name = str(dtype).replace("torch.", "")
        print(f"flash_attention {label} {shape} {name} causal={causal} ({route}): "
              f"kernel_ms {kernel:.4f}, plain_ms {plain:.4f}, library_ms {library:.4f} "
              f"(scaled_dot_product_attention), bound_ms {bound:.4f} ({by})")
        shapes.append({"shape": label, "dtype": name, "causal": causal, "route": route,
                       "ms": kernel, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                       "library_ms": library})
    main = shapes[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "nnstreamer_tpu_torch/csrc/flash_attention.cu",
            "replaces": "nnstreamer_tpu/ops/flash_attention.py:148",
            "max_abs_err": err, "lse_max_abs_err": lse_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"], "match": True,
            "shapes": shapes}


class Counters:
    """Every kernel wrapper's launch count, zeroed and read around a path:
    name -> (module, attribute)."""

    def __init__(self, counts: dict):
        self.counts = counts

    def zero(self) -> None:
        for mod, attr in self.counts.values():
            setattr(mod, attr, 0)

    def read(self) -> dict:
        return {name: getattr(mod, attr) for name, (mod, attr) in self.counts.items()}


@contextmanager
def recording_io(pipe, name: str, keep: bool = False):
    """Record the size of every micro-batch the filter `name` hands its
    backend, in order, and (shape, dtype, device type) of each output;
    with `keep`, the outputs themselves, copied to the host."""
    backend = pipe[name].backend
    inner, sizes, outs, kept = backend.invoke_batch, [], [], []

    def invoke_batch(inputs):
        sizes.append(int(inputs[0].shape[0]))
        res = inner(inputs)
        outs.append([(tuple(o.shape), o.dtype, o.device.type) for o in res])
        if keep:
            kept.append([o.cpu() for o in res])
        return res

    backend.invoke_batch = invoke_batch
    try:
        yield sizes, outs, kept
    finally:
        del backend.invoke_batch


@contextmanager
def recording_batches(pipe, name: str):
    """Record the size of every micro-batch the filter `name` hands its
    backend, in order."""
    with recording_io(pipe, name) as (sizes, _, _):
        yield sizes


def feed_stats(filt) -> dict:
    """The filter's asynchronous feed over one run: the lane's staged
    micro-batches and stacking ms per batch, the window's reaped invokes,
    full-window waits and dwell p50, and the staging pool's reuse rate in
    this run."""
    lane, win = filt._lane, filt._inflight
    staged = lane.staged if lane is not None else 0
    pool = lane.pool if lane is not None else None
    dwell = win.dwell.percentiles_us()
    return {"lane": lane is not None, "staged": staged,
            "stack_ms_per_batch": lane.stack_s * 1e3 / staged if staged else None,
            "reaped": win.reaped, "dispatch_waits": win.dispatch_waits,
            "dwell_p50_ms": dwell["p50"] / 1e3 if dwell else None,
            "pool_reuse_rate": pool.reuse_rate if pool is not None else None}


def feed_line(stats: dict) -> str:
    def num(v, fmt):
        return "none" if v is None else format(v, fmt)

    return (f"lane staged {stats['staged']} micro-batches, stacking "
            f"{num(stats['stack_ms_per_batch'], '.3f')} ms per batch; window reaped "
            f"{stats['reaped']}, dispatch_waits {stats['dispatch_waits']}, dwell p50 "
            f"{num(stats['dwell_p50_ms'], '.3f')} ms; staging pool reuse_rate "
            f"{num(stats['pool_reuse_rate'], '.3f')}")


def check_feed(name: str, stats: dict, batches: int, window: bool) -> None:
    """With the defaults on, no micro-batch may take the synchronous route:
    the lane staged every one and (where outputs go to the host through
    the window) the window reaped every invoke."""
    if not stats["lane"] or stats["staged"] != batches:
        raise AssertionError(f"{name}: the ingest lane staged {stats['staged']} of {batches} "
                             "micro-batches (the defaults must stage every one)")
    if window and stats["reaped"] != batches:
        raise AssertionError(f"{name}: the dispatch window reaped {stats['reaped']} of "
                             f"{batches} invokes (the defaults must park every one)")


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def busy_share(torch, np, text: str, images, warm: int) -> float:
    """The card's busy share over a steady window: ``text``'s pipeline
    takes `warm` frames first, then the rest of `images` under
    ``torch.profiler`` (device activity only); the union of the kernels'
    and copies' device intervals over the host wall of that window.  None
    when the profiler saw no device activity."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(text)
    seen, marks = [0], {warm: threading.Event(), len(images): threading.Event()}

    def on_frame(_):
        seen[0] += 1
        if seen[0] in marks:
            marks[seen[0]].set()

    pipe["out"].connect_new_data(on_frame)
    pipe.start()
    try:
        for i in range(warm):
            pipe["src"].push(images[i])
        if not marks[warm].wait(300):
            raise AssertionError("busy share: the warm-up frames did not arrive")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for i in range(warm, len(images)):
                pipe["src"].push(images[i])
            if not marks[len(images)].wait(300):
                raise AssertionError("busy share: the frames did not arrive")
            wall = time.perf_counter() - t
        pipe["src"].end_of_stream()
        pipe.wait(timeout=60)
    finally:
        pipe.stop()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type.name == "CUDA"]
    return union_us(spans) / (wall * 1e6) if spans else None


def logits_copy_ms(torch, shape) -> dict:
    """Host ms (synchronized, median of 3) to bring one float32 logits batch
    of `shape` to the host: ``.cpu()`` into fresh pageable memory; a fresh
    pinned allocation (host cache emptied first), a pinned allocation the
    caching host allocator hands back, and the ``non_blocking`` copy into
    pinned memory."""
    x = torch.empty(shape, dtype=torch.float32, device="cuda").normal_()
    empty = getattr(torch._C, "_host_emptyCache", None)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    res = {"pageable": [], "pinned_fresh": [], "pinned_cached": [], "pinned_copy": []}
    for _ in range(3):
        res["pageable"].append(timed(lambda: x.cpu())[1])
        if empty is not None:
            empty()
            res["pinned_fresh"].append(timed(lambda: torch.empty(shape, pin_memory=True))[1])
        host = torch.empty(shape, pin_memory=True)
        res["pinned_copy"].append(timed(lambda: host.copy_(x, non_blocking=True))[1])
        del host
        res["pinned_cached"].append(timed(lambda: torch.empty(shape, pin_memory=True))[1])
    del x
    if empty is not None:
        empty()
    return {k: statistics.median(v) if v else None for k, v in res.items()}


#: the filter's feed off: the synchronous filter
SYNC_FEED = "ingest-lane=off dispatch-depth=1"


def feed_turns(run, name: str, want, key: str, window: bool, keys: tuple) -> dict:
    """The feed's A/B of one path, in turns (synchronous, defaults,
    defaults, synchronous; each a fresh pipeline after the path's counted
    run): every run's `key` outputs must equal `want` (the counted run's),
    and each defaults run must have staged (and, with `window`, reaped)
    every micro-batch.  Returns each mode's runs' `keys`, latencies and
    feed counters, and prints each mode's medians."""
    import numpy as np

    runs = {"defaults": [], SYNC_FEED: []}
    for mode in (SYNC_FEED, "defaults", "defaults", SYNC_FEED):
        r = run("" if mode == "defaults" else mode, not runs[mode])
        if not np.array_equal(r.pop(key), want):
            raise AssertionError(f"{name}: {key} of the {mode} run differ from the counted run's")
        if mode == "defaults":
            check_feed(name, r["feed"], r["batches"], window=window)
        runs[mode].append({**{k: r.get(k, r["feed"].get(k)) for k in keys},
                           "latency_ms_p50": r["latency_ms_p50"],
                           "latency_ms_p99": r["latency_ms_p99"], **r["feed"]})
    for mode, rs in runs.items():
        med = {k: statistics.median(x[k] for x in rs if x[k] is not None)
               for k in keys + ("latency_ms_p50", "latency_ms_p99")
               if any(x[k] is not None for x in rs)}
        print(f"{name} feed A/B [{mode}], median of {len(rs)} runs: "
              + ", ".join(f"{k} {v:.4g}" for k, v in med.items()))
    return runs


def direct_batches(torch, module, inputs, sizes):
    """The module called directly on `inputs` (host numpy) in the given
    micro-batch sizes, each padded to a power of two by repeating its last
    row as the backend pads it; yields (first row, n, outputs of the n
    rows, host clock before the copy in)."""
    k = 0
    with torch.inference_mode():
        for n in sizes:
            torch.cuda.synchronize()
            t = time.perf_counter()
            x = torch.from_numpy(inputs[k:k + n]).to("cuda")
            bucket = 1 << (n - 1).bit_length()
            if bucket != n:
                x = torch.cat([x, x[-1:].expand((bucket - n,) + tuple(x.shape[1:]))])
            out = module(x)
            out = [o[:n] for o in out] if isinstance(out, (list, tuple)) else out[:n]
            yield k, n, out, t
            k += n


def labeling_text(custom: str, seed: int, labels, extra: str = "", sink: str = "") -> str:
    return (f"appsrc name=src ! tensor_filter name=f framework=torch-cuda model=zoo "
            f"custom={custom},seed:{seed} max-batch=128 batch-timeout=20 {extra} "
            f"! tensor_decoder mode=image_labeling option1={labels} ! tensor_sink name=out {sink}")


def run_labeling_path(torch, np, lab, counters, name, custom, kernels_per_batch, frames, seed,
                      card, labels, extra: str = "", busy: bool = False) -> dict:
    """One image-labeling path: `frames` seeded 224x224 frames pushed one by
    one, the filter's feed set by `extra` (the defaults when empty); checks
    labels, launches and the direct call; returns the path's launches,
    micro-batches, labels, feed statistics and module.  With `busy`, a
    second pipeline of the same configuration measures the card's busy
    share over a steady window."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (frames, 224, 224, 3), dtype=np.uint8)
    text = labeling_text(custom, seed, labels, extra)
    pipe = parse_pipeline(text)
    arrived = {}
    pipe["out"].connect_new_data(lambda f: arrived.__setitem__(int(f.pts), time.perf_counter()))
    counters.zero()
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            pushed = []
            t0 = time.perf_counter()
            for i in range(frames):
                pushed.append(time.perf_counter())
                pipe["src"].push(images[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
            wall = time.perf_counter() - t0
        launches = counters.read()
        batches = len(sizes)
        feed = feed_stats(pipe["f"])
        module = pipe["f"].backend._module
        out = pipe["out"].frames
        if len(out) != frames or [f.pts for f in out] != list(range(frames)):
            raise AssertionError(f"{name}: {len(out)} of {frames} frames came back, or out of order")
        got = np.array([f.meta["label_index"] for f in out])
        if not ((got >= 0) & (got < 1001)).all() or out[0].meta["label"] != f"class{got[0]}":
            raise AssertionError(f"{name}: a label index outside [0, 1001)")
        for kernel, per_batch in kernels_per_batch.items():
            if launches[kernel] < per_batch * batches:
                raise AssertionError(f"{name}: {kernel} launched {launches[kernel]} times for "
                                     f"{batches} micro-batches (want >= {per_batch} each)")
        if launches["top1"] != batches:  # the decoder's device half: one launch per micro-batch
            raise AssertionError(f"{name}: top1 launched {launches['top1']} times for {batches} "
                                 f"micro-batches (want exactly one each)")
        # reference: the same module called directly, then top1_plain; bf16
        # compute, float32 head (TF32 off)
        want, batch_s = [], []
        for _, _, logits, t in direct_batches(torch, module, images, sizes):
            want.append(lab.top1_plain(logits)[0].cpu().numpy())
            batch_s.append(time.perf_counter() - t)
        want = np.concatenate(want)
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            raise AssertionError(f"{name}: {len(bad)} pipeline labels differ from the direct "
                                 f"call (first frames {bad[:8]})")
    finally:
        pipe.stop()
    lat = sorted(arrived[i] - pushed[i] for i in range(frames))
    # steady state: from the first micro-batch's arrival (it carries the
    # card's lazy set-up: cuDNN handles, kernel selection) to the last
    first = sizes[0] - 1
    span = max(arrived.values()) - arrived[first]
    steady = (frames - first - 1) / span if span > 0 else float("nan")
    p50, p99 = lat[len(lat) // 2] * 1e3, lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    batch_ms = statistics.median(batch_s[1:] or batch_s) * 1e3
    share = busy_share(torch, np, labeling_text(custom, seed, labels, extra, "max-stored=1"),
                       images[:min(frames, 1152)], 128) if busy else None
    feed["busy_share"] = share
    mode = f" [{extra}]" if extra else " [defaults]"
    print(f"{name} path{mode}: {frames} frames in {batches} micro-batches (sizes "
          f"{sorted(set(sizes))}), labels equal to the direct call; launches {launches}")
    print(f"{name} path{mode}: {frames / wall:.1f} frames/s overall, {steady:.1f} frames/s after "
          f"the first micro-batch; frame latency (push to sink) p50 {p50:.2f} ms p99 {p99:.2f} "
          f"ms; direct model call per {max(sizes)}-frame batch (copy in, model, top1, copy out) "
          f"{batch_ms:.2f} ms (host clock, synchronized); on {card}")
    busy_text = "not measured" if share is None else f"{share:.1%}"
    print(f"{name} path{mode}: {feed_line(feed)}"
          + (f"; card busy {busy_text} over a steady window of {min(frames, 1152) - 128} frames "
             "(torch.profiler, device activity)" if busy else "") + f"; on {card}")
    return {"launches": launches, "batches": batches, "module": module, "images": images,
            "labels": got, "feed": feed, "fps": frames / wall, "fps_steady": steady,
            "latency_ms_p50": p50, "latency_ms_p99": p99}


def check_vit_float32(torch, module, images) -> float:
    """A float32 copy of the ViT on 8 frames: attention by the kernel
    against attention by flash_attention_plain (TF32 off)."""
    from nnstreamer_tpu_torch.models import build, transformer
    from nnstreamer_tpu_torch.ops import flash_attention as fa

    copy, _, _ = build("vit", custom_props(VIT_CUSTOM) | {"dtype": "float32"})
    copy.load_state_dict(module.state_dict())
    copy = copy.cuda().eval()
    x = torch.from_numpy(images[:8]).cuda()
    with torch.inference_mode():
        got = copy(x)
        with mock.patch.object(transformer, "flash_attention", fa.flash_attention_plain):
            want = copy(x)
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not torch.isfinite(got).all() or not err <= 1e-4:
        raise AssertionError(f"ViT float32: kernel attention off the plain one by {err}")
    print(f"ViT path: float32 copy on 8 frames, attention by the kernel vs by the plain version: "
          f"max abs logit difference {err:.3g} (limit 1e-4)")
    return err


COMPOSED_E1 = (
    "videotestsrc name=src num-buffers={frames} width={size} height={size} pattern=random "
    "seed={seed} ! tensor_converter ! tee name=t "
    "t. ! queue ! tensor_filter name=f framework=torch-cuda model=zoo custom={custom},seed:{seed} "
    "max-batch=128 batch-timeout=1000 ! tensor_decoder mode=image_labeling "
    "option1={labels} ! m. "
    "t. ! queue ! tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 "
    "! tensor_transform mode=clamp option=-1:1 ! m. "
    "tensor_mux name=m ! tensor_demux name=d  d. ! tensor_sink name=labels  "
    "d. ! tensor_sink name=pre")

# phase e2: every element on card frames; (sink, element options) per tee branch
COMPOSED_E2_TRANSFORMS = [
    ("typecast", "mode=typecast option=float32"),
    ("add", "mode=arithmetic option=add:-127.5"),
    ("sub", "mode=arithmetic option=typecast:float32,sub:0.25"),
    ("mul", "mode=arithmetic option=mul:0.5|2|3"),
    ("div", "mode=arithmetic option=typecast:float32,div:3.3"),
    ("clamp", "mode=clamp option=30:200"),
    ("transpose", "mode=transpose option=1:0:2"),
    ("dimchg", "mode=dimchg option=0:2"),
    ("stand", "mode=stand option=default"),
]


def composed_e2_text(custom: str, seed: int, size: int) -> str:
    """Phase e2's pipeline: a tee of every frame into each transform mode,
    an ``apply=`` subset behind a mux, merge -> split -> aggregator,
    tensor_if, tensor_crop against a second source of regions, and the
    MobileNet filter (batch-through: its logits stay where it computed
    them) into a tee: one sink takes each micro-batch whole, a
    tensor_transform gets its rows from the scheduler's split, and a
    split-batches sink splits it itself; every sink keeps what it gets
    where it lives."""
    sink = "to-host=false"
    seg = size * 100 // 224  # the merged frame is 2*size wide: split it 100 + 348 at 224
    parts = ["appsrc name=src ! tee name=t"]
    for name, opts in COMPOSED_E2_TRANSFORMS:
        parts.append(f"t. ! queue ! tensor_transform name=x_{name} {opts} ! "
                     f"tensor_sink name={name} {sink}")
    parts += [
        "t. ! queue ! mx.  t. ! queue ! mx.  tensor_mux name=mx ! tensor_transform name=x_apply "
        f"mode=arithmetic option=typecast:float32,mul:2 apply=1 ! tensor_sink name=apply {sink}",
        "t. ! queue ! mg.  t. ! queue ! tensor_transform name=x_flip mode=transpose option=0:2:1 "
        "! mg.  tensor_merge name=mg option=1 ! tensor_split name=sp "
        f"tensorseg={seg},{2 * size - seg} option=1 "
        f"sp. ! tensor_aggregator frames-out=2 frames-dim=3 ! tensor_sink name=aggregator {sink} "
        f"sp. ! tensor_sink name=split {sink}",
        "t. ! queue ! tensor_if compared-value=tensor_average_value compared-value-option=0 "
        "supplied-value=100 operator=gt then=passthrough else=fill_values else-option=7 ! "
        f"tensor_sink name=if {sink}",
        "t. ! queue ! c.  appsrc name=regions ! c.  tensor_crop name=c ! "
        f"tensor_sink name=crop {sink}",
        "t. ! queue ! tensor_filter name=f framework=torch-cuda model=zoo "
        f"custom={custom},seed:{seed} "
        "max-batch=128 batch-timeout=10000 batch-through=true ! tee name=ft "
        f"ft. ! tensor_sink name=filter {sink} split-batches=false "
        "ft. ! tensor_transform name=x_logits mode=arithmetic option=mul:2 ! "
        f"tensor_sink name=logits {sink} "
        f"ft. ! tensor_sink name=rows {sink}",
    ]
    return "  ".join(parts)


COMPOSED_E2_SINKS = ([n for n, _ in COMPOSED_E2_TRANSFORMS]
                     + ["apply", "aggregator", "split", "if", "crop", "filter", "logits", "rows"])
CROP_REGIONS = [[10, 20, 64, 48], [150, 150, 100, 100], [0, 0, 224, 1]]


def run_composed_path(torch, np, lab, counters, seed: int, card: str, labels, frames: int,
                      e2_frames: int = 256, custom: str = "arch:mobilenet_v2,dtype:bfloat16",
                      size: int = 224, beside=None) -> dict:
    """Path e: MobileNet-v2 labeling composed with NNStreamer's stream
    elements.  e1 (host frames, timed): videotestsrc -> converter -> tee;
    one branch labels (queue, filter, decoder), the other preprocesses
    (queue, arithmetic, clamp); mux -> demux -> two sinks.  Labels must
    equal the direct call in the same micro-batch sizes, every ``pre``
    tensor numpy's clip((x.astype(float32) - 127.5) / 127.5, -1, 1) bit for
    bit, frame i of both branches paired (pts i/30), normalize_u8 and top1
    exactly one launch per micro-batch.  e2 (card frames, not timed): the same
    frames pushed as card tensors through every stream element (phase e2's
    graph); every output reaching a sink must be a card tensor, and equal
    what the same pipeline makes of the frames pushed as numpy arrays."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    text = COMPOSED_E1.format(frames=frames, size=size, seed=seed, custom=custom, labels=labels)
    pipe = parse_pipeline(text)
    made, arrived = {}, {}
    source = pipe["src"].frames

    def timed_frames():
        for f in source():
            made[f.pts] = time.perf_counter()
            yield f

    pipe["src"].frames = timed_frames
    pipe["labels"].connect_new_data(lambda f: arrived.__setitem__(f.pts, time.perf_counter()))
    # the source declares a static schema, so the filter derives its fused
    # output schema at negotiation; that runs no model call and launches
    # nothing, so every launch counted here belongs to a micro-batch
    counters.zero()
    t0 = time.perf_counter()
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            pipe.wait(timeout=600)
        wall = time.perf_counter() - t0
        launches = counters.read()
        module = pipe["f"].backend._module
        got_labels, got_pre = pipe["labels"].frames, pipe["pre"].frames
    finally:
        pipe.stop()
    batches = len(sizes)
    dt = 1 / 30
    if (len(got_labels) != frames or len(got_pre) != frames
            or [f.pts for f in got_labels] != [i * dt for i in range(frames)]
            or [f.pts for f in got_pre] != [i * dt for i in range(frames)]):
        raise AssertionError(f"composed path: {len(got_labels)} label and {len(got_pre)} pre "
                             f"frames of {frames}, or not paired frame i with frame i in order")
    rng = np.random.default_rng(seed)
    images = np.stack([rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                       for _ in range(frames)])
    got = np.array([f.meta["label_index"] for f in got_labels])
    idx = np.array([int(f.tensors[0][0]) for f in got_labels])
    want = np.concatenate([lab.top1_plain(logits)[0].cpu().numpy()
                           for _, _, logits, _ in direct_batches(torch, module, images, sizes)])
    if not np.array_equal(got, want) or not np.array_equal(idx, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(f"composed path: {len(bad)} labels differ from the direct call "
                             f"(first frames {bad[:8]})")
    for i, f in enumerate(got_pre):
        ref = np.clip((images[i].astype(np.float32) + -127.5) / 127.5, -1, 1)
        if f.tensors[0].dtype != ref.dtype or not np.array_equal(f.tensors[0], ref):
            raise AssertionError(f"composed path: pre of frame {i} differs from numpy's clip")
    if launches["normalize_u8"] != batches or launches["top1"] != batches:
        raise AssertionError(f"composed path: launches {launches} for {batches} micro-batches "
                             "(want normalize_u8 and top1 exactly once each per micro-batch)")
    lat = sorted(arrived[i * dt] - made[i * dt] for i in range(frames))
    first = sizes[0] - 1
    span = max(arrived.values()) - arrived[first * dt]
    steady = (frames - first - 1) / span if span > 0 else float("nan")
    p50, p99 = lat[len(lat) // 2] * 1e3, lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    print(f"composed path e1: {frames} videotestsrc frames through converter, tee, two queued "
          f"branches, mux and demux in {batches} micro-batches (sizes {sorted(set(sizes))}); "
          f"labels equal to the direct call, pre bit-equal to numpy's clip, frame i paired with "
          f"frame i; launches {launches}")
    a = ("" if beside is None else
         f" (path a in this run: {beside['fps_steady']:.1f} frames/s after the first "
         f"micro-batch, p50 {beside['latency_ms_p50']:.2f} ms, "
         f"p99 {beside['latency_ms_p99']:.2f} ms)")
    print(f"composed path e1: {frames / wall:.1f} frames/s overall, {steady:.1f} frames/s after "
          f"the first micro-batch; frame latency (source to labels sink) p50 {p50:.2f} ms p99 "
          f"{p99:.2f} ms{a}; on {card}")
    e2 = run_composed_e2(torch, np, counters, images[:e2_frames], custom, seed)
    return {"launches": launches, "batches": batches, "fps": frames / wall,
            "fps_steady": steady, "latency_ms_p50": p50, "latency_ms_p99": p99, "e2": e2}


def run_composed_e2(torch, np, counters, images, custom: str, seed: int) -> dict:
    """Phase e2 (see ``composed_e2_text``): `images` pushed as card tensors,
    then as numpy arrays, through the same pipeline; outputs compared.  The
    filter's outputs are card tensors in both runs: its rows are checked
    within the card run (each row sink against the whole micro-batches,
    the transformed rows against twice the rows), the rest across runs."""
    from nnstreamer_tpu_torch.ops import labeling as lab
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    n = len(images)
    # even frames darkened, so tensor_if sees means near 64 and 128 against 100
    frames = [x // 2 if i % 2 == 0 else x for i, x in enumerate(images)]
    regions = np.array(CROP_REGIONS, np.int32)

    def run(on_card: bool):
        pipe = parse_pipeline(composed_e2_text(custom, seed, images.shape[1]))
        off_card = []

        def check(sink):
            def cb(f):
                for t in f.tensors:
                    if not (isinstance(t, torch.Tensor) and t.device.type == "cuda"):
                        off_card.append(sink)
            return cb

        if on_card:
            for s in COMPOSED_E2_SINKS:
                pipe[s].connect_new_data(check(s))
        counters.zero()
        pipe.start()
        try:
            with recording_batches(pipe, "f") as sizes:
                for i, x in enumerate(frames):
                    pipe["src"].push(torch.from_numpy(x).cuda() if on_card else x, pts=float(i))
                    pipe["regions"].push(regions, pts=float(i))
                pipe["src"].end_of_stream()
                pipe["regions"].end_of_stream()
                pipe.wait(timeout=600)
            launches = counters.read()
            applied = {name: pipe[f"x_{name}"].torch_applied
                       for name in [m for m, _ in COMPOSED_E2_TRANSFORMS] + ["apply", "logits"]}
            out = {s: pipe[s].frames for s in COMPOSED_E2_SINKS}
            module = pipe["f"].backend._module
        finally:
            pipe.stop()
        return out, off_card, applied, launches, sizes, module

    card, off_card, applied, launches, sizes, module = run(True)
    host, _, host_applied, _, host_sizes, _ = run(False)
    if off_card:
        raise AssertionError(f"composed e2: outputs off the card at sinks {sorted(set(off_card))}")
    if (any(v != n for v in applied.values()) or host_applied.pop("logits") != n
            or any(host_applied.values())):
        raise AssertionError(f"composed e2: torch-route applications {applied} on card frames, "
                             f"{host_applied} on host frames (want {n} each on card frames; "
                             f"on host frames {n} on the filter's card rows and 0 elsewhere)")

    def arrays(f):
        return [t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                for t in f.tensors]

    def labels_of(frames_):
        return np.concatenate([lab.top1_plain(f.tensors[0])[0].cpu().numpy() for f in frames_])

    rows = torch.cat([f.tensors[0] for f in card["filter"]])
    if (len(card["rows"]) != n or len(card["logits"]) != n
            or not torch.equal(torch.stack([f.tensors[0] for f in card["rows"]]), rows)
            or not torch.equal(torch.stack([f.tensors[0] for f in card["logits"]]), rows * 2)):
        raise AssertionError(f"composed e2: {len(card['rows'])} rows and {len(card['logits'])} "
                             f"transformed rows of {n}, or not the filter's micro-batches' rows")
    for s in COMPOSED_E2_SINKS:
        if s in ("filter", "logits", "rows"):
            continue
        if len(card[s]) != len(host[s]):
            raise AssertionError(f"composed e2 {s}: {len(card[s])} frames on the card route, "
                                 f"{len(host[s])} on the host route")
        for k, (a, b) in enumerate(zip(card[s], host[s])):
            for x, y in zip(arrays(a), arrays(b)):
                same = (x.dtype == y.dtype and x.shape == y.shape
                        and (np.allclose(x, y, rtol=1e-5, atol=1e-5) if s == "stand"
                             else np.array_equal(x, y)))
                if not same:
                    raise AssertionError(
                        f"composed e2 {s}: frame {k} differs between the card and host routes "
                        f"({x.dtype}{x.shape} vs {y.dtype}{y.shape})")
    ifs = [bool((f.tensors[0] == 7).all()) for f in card["if"]]
    if ifs != [i % 2 == 0 for i in range(n)]:
        raise AssertionError("composed e2: tensor_if decisions are not the frames' own")
    got = labels_of(card["filter"])
    want = np.concatenate([lab.top1_plain(logits)[0].cpu().numpy() for _, _, logits, _ in
                           direct_batches(torch, module, np.stack(frames), sizes)])
    if sizes != host_sizes or not np.array_equal(got, labels_of(host["filter"])) \
            or not np.array_equal(got, want):
        raise AssertionError(f"composed e2: filter labels differ (micro-batches {sizes} on the "
                             f"card route, {host_sizes} on the host route)")
    if launches["normalize_u8"] != len(sizes):
        raise AssertionError(f"composed e2: normalize_u8 launched {launches['normalize_u8']} "
                             f"times for {len(sizes)} micro-batches")
    print(f"composed path e2: {n} card frames through tee, {len(COMPOSED_E2_TRANSFORMS)} "
          f"tensor_transform modes and an apply= subset, mux, merge, split, aggregator, "
          f"tensor_if, tensor_crop and the MobileNet filter (micro-batches {sizes}; kept whole, "
          f"split for a tensor_transform and by a sink): every output "
          f"a card tensor ({sum(len(v) for v in card.values())} frames at {len(card)} sinks), "
          f"torch-route applications {applied}, equal to the host route (stand within rtol 1e-5, "
          f"atol 1e-5; the rest bit for bit), tensor_if decisions and labels exact; launches "
          f"{launches}")
    return {"frames": n, "sinks": len(card), "microbatches": sizes, "launches": launches}


def run_lm_path(torch, np, counters, prompts: int, seed: int, card: str, extra: str = "") -> dict:
    """GPT-2-small scoring: `prompts` seeded prompts of 1024 tokens through
    appsrc ! tensor_filter ! tensor_sink, the filter's feed set by `extra`
    (the defaults when empty); checks every frame's per-position argmax
    against the direct call and the flash launches; returns the argmaxes,
    launches, invokes and feed statistics."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    props = custom_props(LM_CUSTOM)
    seq, vocab, layers = int(props["seq"]), int(props["vocab"]), int(props["layers"])
    tokens = np.random.default_rng(seed).integers(0, vocab, (prompts, seq), dtype=np.int32)
    # batch-timeout: every mode sees the same full micro-batches
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_filter name=f framework=torch-cuda model=zoo "
        f"custom={LM_CUSTOM},seed:{seed} max-batch=8 batch-timeout=1000 {extra} "
        "! tensor_sink name=out")
    arrived = {}
    pipe["out"].connect_new_data(lambda f: arrived.__setitem__(int(f.pts), time.perf_counter()))
    counters.zero()
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            pushed = []
            t0 = time.perf_counter()
            for i in range(prompts):
                pushed.append(time.perf_counter())
                pipe["src"].push(tokens[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
            wall = time.perf_counter() - t0
        launches = counters.read()
        feed = feed_stats(pipe["f"])
        out = pipe["out"].frames
        if len(out) != prompts or [f.pts for f in out] != list(range(prompts)):
            raise AssertionError(f"LM: {len(out)} of {prompts} frames came back, or out of order")
        got = []
        for f in out:
            logits = f.tensors[0]
            if logits.shape != (seq, vocab) or logits.dtype != np.float32 or not np.isfinite(
                    logits).all():
                raise AssertionError(f"LM: a frame of {logits.shape} {logits.dtype}, or not finite")
            got.append(logits.argmax(-1))
        got = np.stack(got)
        del out, logits
        pipe["out"].frames.clear()
        for kernel in ("flash_attention", "flash_attention_tensor_cores"):
            if launches[kernel] < layers * len(sizes):
                raise AssertionError(f"LM: {kernel} launched {launches[kernel]} times for "
                                     f"{len(sizes)} invokes of {layers} layers")
        module = pipe["f"].backend._module
        want, batch_s = [], []
        for _, n, logits, t in direct_batches(torch, module, tokens, sizes):
            want.append(logits.argmax(-1).cpu().numpy())
            batch_s.append((time.perf_counter() - t, n))
        want = np.concatenate(want)
        if not np.array_equal(got, want):
            bad = np.argwhere(got != want)
            raise AssertionError(f"LM: {len(bad)} argmax positions differ from the direct call "
                                 f"(first (prompt, position) {bad[:4].tolist()})")
    finally:
        pipe.stop()
        empty = getattr(torch._C, "_host_emptyCache", None)
        if empty is not None:
            empty()  # the pinned logits the frames held
    full = [s for s, n in batch_s if n == max(sizes)]
    batch_ms = statistics.median(full[1:] or full) * 1e3
    # steady state: from the first invoke's last frame (it carries the
    # card's lazy set-up) to the last; not measured when the window released
    # the invokes together (less than one direct call apart)
    first = sizes[0] - 1
    span = max(arrived.values()) - arrived[first]
    steady = (prompts - first - 1) / span if span * 1e3 >= batch_ms else None
    lat = sorted(arrived[i] - pushed[i] for i in range(prompts))
    p50, p99 = lat[len(lat) // 2] * 1e3, lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    outside = wall * 1e3 / len(sizes) - batch_ms
    mode = f" [{extra}]" if extra else " [defaults]"
    print(f"LM path{mode}: {prompts} prompts of {seq} tokens in {len(sizes)} invokes (sizes "
          f"{sizes}), per-position argmax equal to the direct call; launches {launches}")
    print(f"LM path{mode}: {prompts / wall:.2f} sequences/s, {prompts * seq / wall:.1f} tokens/s "
          f"(push to last logits frame at the sink, logits copied to the host), "
          + ("not measured" if steady is None else f"{steady:.2f}")
          + " sequences/s after the first invoke; latency (push to sink) p50 "
          f"{p50:.1f} ms p99 {p99:.1f} ms; direct model call per {max(sizes)}-prompt batch "
          f"{batch_ms:.2f} ms (host clock, synchronized), time outside the model "
          f"{outside:.1f} ms per invoke (wall / invokes - direct call); on {card}")
    print(f"LM path{mode}: {feed_line(feed)}; on {card}")
    return {"launches": launches, "batches": len(sizes), "argmax": got, "feed": feed,
            "sps": prompts / wall, "sps_steady": steady, "latency_ms_p50": p50,
            "latency_ms_p99": p99, "outside_ms_per_invoke": outside}


def top2_margin(z):
    """Per row of z (B, V): the largest value less the second largest."""
    top = z.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def agree_until_tie(got, want, margins, limit: float = 1e-3) -> int:
    """Tokens (n,) must be equal at every step before the first whose
    reference top-2 margin is under `limit`; returns that step (n when no
    margin is)."""
    import numpy as np

    low = np.flatnonzero(np.asarray(margins) < limit)
    first = int(low[0]) if low.size else len(want)
    if not np.array_equal(np.asarray(got)[:first], np.asarray(want)[:first]):
        bad = int(np.flatnonzero(np.asarray(got)[:first] != np.asarray(want)[:first])[0])
        raise AssertionError(f"tokens differ at step {bad}, before the first near-tie step "
                             f"{first} (margin {margins[bad]:.3g} there)")
    return first


def full_forward_margins(torch, lm, tokens, tp: int):
    """Top-2 logit margins of the full forward (no cache) of tokens (1, T),
    for the steps after the prompt."""
    with torch.inference_mode():
        return top2_margin(lm(tokens)[0, tp - 1:-1]).cpu().numpy()


def stream_tokens(frames, n_tokens: int):
    """One stream's chunk frames, checked: chunk indices 0.., one final (the
    last), each tokens_done the running sum; returns the tokens."""
    import numpy as np

    frames = sorted(frames, key=lambda f: f.meta["chunk_index"])
    meta = [(f.meta["chunk_index"], f.meta["final"], f.meta["tokens_done"]) for f in frames]
    sizes = [f.tensors[0].shape[1] for f in frames]
    if ([m[0] for m in meta] != list(range(len(frames))) or [m[1] for m in meta]
            != [False] * (len(frames) - 1) + [True]
            or [m[2] for m in meta] != list(np.cumsum(sizes)) or sum(sizes) != n_tokens):
        raise AssertionError(f"generation: chunk meta {meta} with sizes {sizes} is not one "
                             f"stream of {n_tokens} tokens")
    return np.concatenate([f.tensors[0] for f in frames], axis=1)[0]


def run_generator(np, custom: str, prompts, max_new: int, chunk: int, slots: int,
                  prefill_chunk: int = 128, keep=None):
    """`prompts` pushed at once through appsrc ! tensor_generator !
    tensor_sink; returns the tokens per prompt, the push clock per prompt,
    the arrival clock of every chunk by prompt, the wall seconds and
    whatever `keep(pipe)` returned before the pipeline stopped."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_generator name=g custom={custom} max-new={max_new} "
        f"chunk={chunk} slots={slots} prefill-chunk={prefill_chunk} ! tensor_sink name=out")
    arrived = {}
    pipe["out"].connect_new_data(
        lambda f: arrived.setdefault(int(f.pts), []).append(time.perf_counter()))
    pipe.start()
    try:
        pushed = []
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            pushed.append(time.perf_counter())
            pipe["src"].push(p, pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=600)
        wall = max(max(v) for v in arrived.values()) - t0
        kept = keep(pipe) if keep is not None else None
    finally:
        pipe.stop()
    by = {}
    for f in pipe["out"].frames:
        by.setdefault(int(f.pts), []).append(f)
    if sorted(by) != list(range(len(prompts))):
        raise AssertionError(f"generation: streams {sorted(by)} came back for {len(prompts)} "
                             "prompts")
    toks = [stream_tokens(by[i], max_new) for i in range(len(prompts))]
    return toks, pushed, arrived, wall, kept


def check_neighbours(np, custom: str, rng, vocab: int) -> None:
    """ROADMAP C2: at a fixed width (slots=16), a greedy stream's tokens do
    not depend on its neighbours: one 200-token prompt alone against the
    same prompt eighth among 15 others of 64-448 tokens, 64 new tokens."""
    mine = rng.integers(0, vocab, 200, dtype=np.int32)
    others = [rng.integers(0, vocab, int(n), dtype=np.int32) for n in rng.integers(64, 449, 15)]
    alone, *_ = run_generator(np, custom, [mine], 64, 16, 16)
    among, *_ = run_generator(np, custom, others[:7] + [mine] + others[7:], 64, 16, 16)
    if not np.array_equal(alone[0], among[7]):
        first = int(np.flatnonzero(alone[0] != among[7])[0])
        raise AssertionError(f"C2: a stream's tokens in slots=16 depend on its neighbours (alone "
                             f"and eighth among 15 others differ from token {first} of 64)")
    print(f"generation path: slots=16 ({custom_props(custom).get('dtype')}), a 200-token prompt "
          "alone and eighth among 15 others of 64-448 tokens: its 64 greedy tokens are equal "
          "(ROADMAP C2)")


def pct(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(len(v) * q))]


def decode_step_profile(torch, model, k: int = 16, scans: int = 4) -> dict:
    """A slot model's decode call of k tokens with every slot active, as
    the engine makes it (the call, then its tokens to the host): wall ms
    per token step (host clock, synchronized), device ms per step (the
    profiler's kernel time), busy share, host ms to issue one step while
    the card sleeps, and the host synchronizations per call."""
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache()
    s = model.slots
    dev = model.device
    tok = torch.zeros(s, dtype=torch.int32, device=dev)
    gen = torch.ones(s, dtype=torch.int32, device=dev)
    active = torch.ones(s, dtype=torch.int32, device=dev)

    def scan():
        out = model.decode_fn(k)(cache, tok, gen, active)
        return out[3].cpu()

    scan()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(scans):
        scan()
    wall = (time.perf_counter() - t) / (scans * k) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(scans):
            scan()
    events = prof.events()
    kernel_us = sum(e.device_time_total for e in events if e.device_type.name == "CUDA")
    syncs = [e for e in events if e.device_type.name == "CPU"
             and e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]
    where = Counter(f"{e.name} in {e.cpu_parent.name if e.cpu_parent else '-'}" for e in syncs)
    host = host_ms(torch, lambda: model.decode_fn(1)(cache, tok, gen, active), calls=1)
    if int(cache.pos.max()) >= model.cfg.max_seq:
        raise AssertionError("decode profile ran past max_seq")
    device = kernel_us / 1e3 / (scans * k)
    return {"wall_ms_per_step": wall, "device_ms_per_step": device,
            "busy_share": device / wall if wall else float("nan"),
            "host_ms_per_step": host, "syncs_per_call": len(syncs) / scans,
            "syncs": dict(where)}


def run_generation_path(torch, np, counters, seed: int, card: str) -> dict:
    """GPT-2-small generation (path d): one-shot ``generate:<N>`` through the
    filter, cache against no cache, the slotted throughput run with the
    unslotted path beside it, slotted against one-shot in float32, and the
    sampling checks.  Flash attention must launch 0 times."""
    from nnstreamer_tpu_torch.models import transformer as tr
    from nnstreamer_tpu_torch.ops import threefry as tf
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    props = custom_props(LM_CUSTOM) | {"seed": str(seed)}
    props.pop("arch")
    custom = f"{LM_CUSTOM},seed:{seed}"
    vocab = int(props["vocab"])
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 4)
    counters.zero()
    t_path = time.perf_counter()
    laps = []

    def lap(name):
        laps.append((name, round(time.perf_counter() - t_path - sum(t for _, t in laps), 1)))

    # 1. one-shot generate:<N> through the filter against the direct call
    prompts = rng.integers(0, vocab, (8, 128), dtype=np.int32)
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_filter name=f framework=torch-cuda model=zoo "
        f"custom={custom},generate:32 max-batch=8 batch-timeout=1000 ! tensor_sink name=out")
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            for i in range(8):
                pipe["src"].push(prompts[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
        check_feed("generate:32", feed_stats(pipe["f"]), len(sizes), window=True)
        module = pipe["f"].backend._module
        got = np.stack([f.tensors[0] for f in pipe["out"].frames])
        want = np.concatenate([out.cpu().numpy() for _, _, out, _ in
                               direct_batches(torch, module, prompts, sizes)])
    finally:
        pipe.stop()
    if got.shape != (8, 160) or got.dtype != np.int32 or not np.array_equal(got, want):
        raise AssertionError(f"generate:32 through the filter: {got.shape} {got.dtype}, "
                             "or tokens not those of the direct call")
    if not np.array_equal(got[:, :128], prompts) or not ((got >= 0) & (got < vocab)).all():
        raise AssertionError("generate:32: the prompt is not echoed or a token is out of range")
    del module
    lap("one-shot")
    print(f"generation path: generate:32 through tensor_filter, 8 prompts of 128 tokens in "
          f"micro-batches {sizes}, staged by the ingest lane and reaped by the dispatch "
          f"window: tokens equal to the direct call")

    # 2. float32: the KV-cache generation against the full forward per token
    f32_props = props | {"dtype": "float32", "attn": "xla"}
    lm32 = tr.lm_from_props(f32_props, dev)
    prompts2 = torch.from_numpy(rng.integers(0, vocab, (2, 128), dtype=np.int32)).to(dev)
    cached = tr.make_generate(lm32, 16)(prompts2)[:, 128:].cpu().numpy()
    first_tie = []
    for b in range(2):
        seq = prompts2[b:b + 1].clone()
        ref, margins = [], []
        with torch.inference_mode():
            for _ in range(16):
                last = lm32(seq)[:, -1]
                ref.append(int(last.argmax(-1)))
                margins.append(float(top2_margin(last)[0]))
                seq = torch.cat([seq, last.argmax(-1, keepdim=True).to(seq.dtype)], dim=1)
        first_tie.append(agree_until_tie(cached[b], ref, margins))
    lap("cache vs full forward")
    print(f"generation path: float32 KV-cache tokens equal to the full forward per token up "
          f"to the first step with a top-2 margin under 1e-3: steps {first_tie} of 16")

    # 3. throughput: 32 prompts of 64-448 tokens at once through slots=16,
    # the first 8 also through slots=0
    lengths = rng.integers(64, 449, 32)
    prompts3 = [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lengths]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def keep(pipe):
        eng = pipe["g"]._engine
        return {"model": eng.model, "kv_bytes": eng._cache.nbytes, "snapshot": eng.snapshot()}

    toks16, pushed, arrived, wall16, kept = run_generator(np, custom, prompts3, 64, 16, 16,
                                                          keep=keep)
    peak = torch.cuda.max_memory_allocated()
    lap("slots=16")
    step = decode_step_profile(torch, kept.pop("model"))
    lap("decode step profile")
    toks0, pushed0, arrived0, wall0, _ = run_generator(np, custom, prompts3[:8], 64, 16, 0)
    lap("slots=0")
    same = sum(np.array_equal(a, b) for a, b in zip(toks0, toks16[:8]))
    ttft = [(arrived[i][0] - pushed[i]) * 1e3 for i in range(32)]
    gaps = [(b - a) * 1e3 for i in range(32) for a, b in zip(arrived[i], arrived[i][1:])]
    tput = {"slots16_tokens_per_s": 32 * 64 / wall16, "slots0_tokens_per_s": 8 * 64 / wall0,
            "ttft_ms_p50": pct(ttft, 0.5), "ttft_ms_p99": pct(ttft, 0.99),
            "chunk_interval_ms_p50": pct(gaps, 0.5), "chunk_interval_ms_p99": pct(gaps, 0.99),
            "kv_cache_bytes": kept["kv_bytes"], "max_memory_allocated": peak,
            "slots0_streams_equal": same, **step, **kept["snapshot"]}
    print(f"generation path: slots=16 max-new=64 chunk=16 prefill-chunk=128, 32 prompts of "
          f"{int(lengths.min())}-{int(lengths.max())} tokens: chunk meta well-formed; "
          f"{tput['slots16_tokens_per_s']:.1f} tokens/s (slots=0, first 8 prompts: "
          f"{tput['slots0_tokens_per_s']:.1f}; {same} of 8 streams token for token equal to "
          f"slots=16); time to first chunk p50 {tput['ttft_ms_p50']:.1f} ms p99 "
          f"{tput['ttft_ms_p99']:.1f} ms; chunk interval p50 {tput['chunk_interval_ms_p50']:.1f}"
          f" ms p99 {tput['chunk_interval_ms_p99']:.1f} ms; on {card}")
    print(f"generation path: decode step (16 slots, calls of 16): wall {step['wall_ms_per_step']:.3f}"
          f" ms, device {step['device_ms_per_step']:.3f} ms (busy {step['busy_share']:.1%}), "
          f"host {step['host_ms_per_step']:.3f} ms to issue one step; "
          f"{step['syncs_per_call']:g} host synchronizations per call ({step['syncs']}); KV cache "
          f"{kept['kv_bytes'] / 2**20:.1f} MiB, max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"engine {kept['snapshot']}")

    # 3b. neighbour independence in bf16 (ROADMAP C2)
    check_neighbours(np, custom, rng, vocab)
    lap("neighbours")

    # 4. float32: slots=4 streams against one-shot B = 1 per prompt
    lengths4 = rng.integers(64, 257, 8)
    prompts4 = [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lengths4]
    custom32 = ",".join(f"{k}:{v}" for k, v in f32_props.items())
    toks4, *_ = run_generator(np, custom32, prompts4, 32, 8, 4, prefill_chunk=64)
    ties = []
    for p, got4 in zip(prompts4, toks4):
        x = torch.from_numpy(p[None]).to(dev)
        one = tr.make_generate(lm32, 32)(x)
        margins = full_forward_margins(torch, lm32, one, len(p))
        ties.append(agree_until_tie(got4, one[0, len(p):].cpu().numpy(), margins))
    lap("slots=4 vs one-shot")
    print(f"generation path: float32 slots=4, 8 prompts: tokens equal to one-shot B = 1 up to "
          f"the first top-2 margin under 1e-3 (steps {ties} of 32)")

    # 5. sampling: threefry bits on the card and the CPU; a single slotted
    # occupant against one-shot B = 1
    key = tf.fold_in(tf.prng_key(1), 7)
    on_card, on_cpu = tf.uniform(key, (16, vocab), device=dev), tf.uniform(key, (16, vocab))
    if not torch.equal(bits(on_card).cpu(), bits(on_cpu)) or not torch.equal(
            tf.random_bits(key, (16, vocab), dev).cpu(), tf.random_bits(key, (16, vocab))):
        raise AssertionError("threefry: a (16, 50257) draw differs between the card and the CPU")
    temp, top_k, gen_seed = 0.8, 40, 1
    slot_model = tr.SlotModel(lm32, 4, temp, top_k, gen_seed)
    sampled_ties = []
    for p in [rng.integers(0, vocab, int(n), dtype=np.int32) for n in rng.integers(64, 257, 4)]:
        x = torch.from_numpy(p[None]).to(dev)
        one = tr.make_generate(lm32, 24, temp, top_k, gen_seed)(x)[0, len(p):].cpu().numpy()
        margins = sampled_margins(torch, tr, tf, lm32, x, one, temp, top_k, gen_seed)
        got5 = single_occupant(torch, slot_model, x, 24, slot=2)
        sampled_ties.append(agree_until_tie(got5, one, margins))
    lap("sampling")
    launches = counters.read()
    if any(launches.values()):
        raise AssertionError(f"generation path: kernels launched {launches} (want none: the "
                             "decode path reaches no kernel)")
    print(f"generation path: threefry (16, {vocab}) bits and uniforms bit-equal on the card and "
          f"the CPU; temperature {temp} top_k {top_k} gen_seed {gen_seed}: a single slotted "
          f"occupant equal to one-shot B = 1 up to the first top-2 margin of logits/T + gumbel "
          f"under 1e-3 (steps {sampled_ties} of 24); launches {launches}; "
          f"{time.perf_counter() - t_path:.1f} s ({laps})")
    return {"launches": launches, "batches": len(sizes), "generation": tput}


def sampled_margins(torch, tr, tf, lm, x, toks, temp, top_k, seed):
    """One-shot sampling's top-2 margin of logits/T + gumbel per step, the
    tokens `toks` fed back (the same cache path as ``make_generate``)."""
    key0 = tf.prng_key(seed)
    margins = []
    with torch.inference_mode():
        cache = tr.KVCache.zeros(lm.cfg, 1, x.device)
        logits = lm(x, cache)[:, -1]
        for i, t in enumerate(toks):
            scaled = logits.float() / torch.full((), temp, device=x.device)
            kth = scaled.topk(top_k, dim=-1).values[:, -1:]
            scaled = torch.where(scaled >= kth, scaled, -1e30)
            z = scaled + tf.gumbel(key0 if i == 0 else tf.fold_in(key0, i), scaled.shape,
                                   x.device)
            margins.append(float(top2_margin(z)[0]))
            logits = lm(torch.tensor([[int(t)]], device=x.device), cache)[:, -1]
    return margins


def single_occupant(torch, model, x, n: int, slot: int):
    """The tokens of one stream alone in `slot` of a slot model: prefill,
    token 1, then decode calls of 5, 8 and the rest."""
    cache = model.reset_slot(model.init_cache(), slot)
    cache, logits = model.prefill_fn(x.shape[1])(cache, x, slot)
    first = model.pick_first(logits)
    tok, gen, active = (torch.zeros(model.slots, dtype=torch.int32, device=x.device)
                        for _ in range(3))
    tok[slot], gen[slot], active[slot] = int(first[0]), 1, 1
    out = [first]
    for k in (5, 8, n - 14):
        cache, tok, gen, toks = model.decode_fn(k)(cache, tok, gen, active)
        out.append(toks[slot])
    return torch.cat(out).cpu().numpy()


# path f: the vision families at their published widths, bf16, with the
# decoders' device halves fused into the filter: (key, name, zoo custom,
# input size, decoder mode, decoder options; {labels}, {priors} and {thr}
# are filled in by the path)
VISION = (
    ("ssd_mobilenet_v2", "SSD-MobileNet-v2", "arch:ssd_mobilenet_v2,classes:91,dtype:bfloat16", 300,
     "bounding_boxes", {1: "mobilenet-ssd", 2: "{labels}", 3: "{priors}:{thr}", 5: "300:300"}),
    ("yolov5s", "YOLOv5s", "arch:yolov5s,size:640,classes:80,dtype:bfloat16", 640,
     "bounding_boxes", {1: "yolov5", 2: "{labels}", 3: "0:{thr}:0.45", 5: "640:640"}),
    ("posenet", "PoseNet", "arch:posenet,size:257,keypoints:17,dtype:bfloat16", 257,
     "pose_estimation", {1: "640:480", 2: "257:257", 4: "heatmap-offset"}),
    ("deeplab", "DeepLab", "arch:deeplab,size:257,classes:21,dtype:bfloat16", 257,
     "image_segment", {1: "tflite-deeplab"}),
)
#: frames through each family of path f: three micro-batches of 128
VISION_FRAMES = 384
#: a near-tie: a score within this of a threshold or of its neighbour in
#: the sort, an IoU within it of ``iou_thr``, or top-2 values within it
TIE = 1e-6


def vision_decoder(mode: str, options: dict):
    """A decoder subplugin of `mode` set to `options` ({n: optionN})."""
    import nnstreamer_tpu_torch.decoders  # noqa: F401 — registers the decoder modes
    from nnstreamer_tpu_torch.core import registry

    dec = registry.get(registry.KIND_DECODER, mode)()
    dec.set_options([options.get(i, "") for i in range(1, 10)])
    return dec


def box_ties(torch, dec, raw) -> tuple:
    """Near-ties of the box decoders' device half on `raw`, as the CPU
    computes it: a candidate score within TIE of the threshold, neighbours
    within TIE in the top-k sort, or an IoU within TIE of ``iou_thr``
    between two top-k candidates (class-offset boxes, as the NMS sees
    them).  Returns (near-ties per frame (B,), loose (B, K): the top-k rows
    a near-tie may change, and [boxes, scores, classes]: the loose
    candidates as device-half rows, scores before the NMS, 0 elsewhere).
    Loose are every row from the first tied score on when a score is tied
    to the threshold (one candidate in or out shifts them), both rows of a
    tied pair in the sort, the later row of a tied IoU, and, as a flipped
    keep spreads through the NMS, every later row whose IoU with a loose
    row exceeds ``iou_thr`` - TIE."""
    from nnstreamer_tpu_torch.ops.nms import _iou_matrix

    if dec.mode in ("mobilenet-ssd", "tflite-ssd"):
        boxes, scores, classes = dec._device_ssd(raw)
        thr, iou = dec.ssd_thr, dec.ssd_iou
    else:
        scaled, thr, iou = dec._yolo_options()
        boxes, scores, classes = dec._device_yolo(raw, scaled)
    at_thr = (scores - thr).abs() < TIE
    ties = at_thr.sum(1)
    s = torch.where(scores >= thr, scores, 0.0)
    k = min(dec.FUSED_TOPK, s.shape[1])
    top, idx = torch.sort(s, dim=1, descending=True, stable=True)
    top, idx = top[:, :k + 1], idx[:, :k]
    pair = ((top[:, :-1] - top[:, 1:]).abs() < TIE) & (top[:, 1:] > 0)
    ties += pair.sum(1)
    top = top[:, :k]
    loose = torch.arange(k) >= (scores >= thr + TIE).sum(1, keepdim=True)
    loose &= at_thr.any(1, keepdim=True)
    loose[:, :pair.shape[1]] |= pair
    loose[:, 1:] |= pair[:, :k - 1]
    tb = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    tc = classes.gather(1, idx)
    island = float(4 * max(*dec.in_wh, *dec.out_wh))
    m = _iou_matrix(tb + tc[..., None] * island)
    pos = top > 0
    pos = (pos[:, :, None] & pos[:, None, :]).triu(1)
    near = ((m - iou).abs() < TIE) & pos
    ties += near.sum((1, 2))
    loose |= near.any(1)
    over = (m > iou - TIE) & pos
    while True:
        spread = loose | (over & loose[:, :, None]).any(1)
        if torch.equal(spread, loose):
            break
        loose = spread
    rows = [torch.cat([tb, boxes], 1),
            torch.cat([torch.where(loose, top, 0.0), torch.where(at_thr, scores, 0.0)], 1),
            torch.cat([tc, classes], 1)]
    return ties, loose, rows


def top2_ties(torch, x, dim: int) -> "torch.Tensor":
    """Positions whose two largest values along `dim` are within TIE."""
    top = x.float().topk(2, dim=dim).values
    return (top.select(dim, 0) - top.select(dim, 1)) < TIE


def device_half_check(torch, dec, raw, scale: float) -> dict:
    """The fused device half on the card against the same half on the CPU,
    fed the raw head copied from the card: the keep pattern, classes,
    class grids and argmax positions equal, floats within a few float32
    ulps, except where a near-tie may change the result (the tied pixel or
    keypoint; the loose rows of ``box_ties``).  Near-ties are counted.
    Returns the counts."""
    cpu_raw = [r.float().cpu() for r in raw]
    card = [t.cpu() for t in dec.device_fn(raw, device=raw[0].device)]
    host = dec.device_fn(cpu_raw, device=torch.device("cpu"))
    B = raw[0].shape[0]
    if dec.NAME == "bounding_boxes":  # per top-k row
        ties, loose, _ = box_ties(torch, dec, cpu_raw)
        eq = ((card[1] > 0) == (host[1] > 0)) & (card[2] == host[2])
        eq &= torch.isclose(card[1], host[1], rtol=0, atol=TIE)
        eq &= torch.isclose(card[0], host[0], rtol=0, atol=4e-6 * scale).all(2)
        kept = int((card[1] > 0).sum())
    elif dec.NAME == "pose_estimation":  # per keypoint
        heat = cpu_raw[0]
        loose = top2_ties(torch, heat.reshape(B, -1, heat.shape[-1]), 1)
        ties = loose.sum(1)
        eq = torch.isclose(card[0], host[0], rtol=TIE, atol=TIE).all(2)
        kept = int(card[0].shape[1]) * B
    else:  # per pixel
        loose = top2_ties(torch, cpu_raw[0], -1)
        ties = loose.flatten(1).sum(1)
        eq = card[0] == host[0]
        kept = int((card[0] > 0).sum())
    bad = [b for b in range(B) if (~eq[b] & ~loose[b]).any()]
    if bad:
        raise AssertionError(f"{dec.NAME}: the device half on the card differs from the CPU's "
                             f"on frames {bad[:8]} where no near-tie reaches")
    return {"frames": B, "near_ties": int(ties.sum()),
            "frames_with_near_ties": int((ties > 0).sum()),
            "frames_differing": int((~eq).flatten(1).any(1).sum()), "loose": int(loose.sum()),
            "kept": kept}


def same_box(g, w) -> bool:
    """Two boxes of a meta list are one detection: class and label equal,
    coordinates within 0.1 px (JAX ``tests/test_device_fusion.py:188-196``)."""
    return (g["class"] == w["class"] and g["label"] == w["label"]
            and all(abs(g[k] - w[k]) <= 0.1 for k in "xywh"))


def match_boxes(got, want, loose=()) -> bool:
    """One frame's boxes meta, fused against host, whatever their order:
    once the boxes that are one detection with a box of `loose` are
    dropped from both sides, one-to-one by ``same_box`` with scores within
    rel 1e-4 (JAX ``tests/test_device_fusion.py:188-196``)."""
    got, left = ([b for b in side if not any(same_box(b, x) for x in loose)]
                 for side in (got, want))
    if len(got) != len(left):
        return False
    for g in got:
        for j, w in enumerate(left):
            if same_box(g, w) and abs(g["score"] - w["score"]) <= 1e-4 * abs(w["score"]):
                del left[j]
                break
        else:
            return False
    return True


def unfused_check(torch, np, text, images, dec) -> dict:
    """`images` (a small micro-batch) through ``text(extra)`` fused
    (`extra` empty) and with ``device-fused=never``: the host decode
    against the fused result, with the tolerances of JAX
    ``tests/test_device_fusion.py:188-196`` (boxes one-to-one; keypoints
    within 0.1 px and scores rel 1e-4; class grids equal), except where a
    near-tie in the raw head may change the result, as in
    ``device_half_check`` (the loose box rows, rendered by the decoder's
    host finish, are dropped from both sides)."""
    from nnstreamer_tpu_torch.core.buffer import TensorFrame
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    runs, raws = {}, None
    for extra in ("", "device-fused=never"):
        pipe = parse_pipeline(text(extra))
        pipe.start()
        try:
            if pipe["d"]._fused is not (extra == ""):
                raise AssertionError(f"{dec.NAME}: device-fused={extra or 'auto'} gave fused "
                                     f"{pipe['d']._fused}")
            with recording_io(pipe, "f", keep=bool(extra)) as (_, _, kept):
                for i, x in enumerate(images):
                    pipe["src"].push(x, pts=float(i))
                pipe["src"].end_of_stream()
                pipe.wait(timeout=300)
            runs[extra] = list(pipe["out"].frames)
            raws = kept or raws
        finally:
            pipe.stop()
    fused, host = runs[""], runs["device-fused=never"]
    n = len(images)
    if len(fused) != n or len(host) != n:
        raise AssertionError(f"{dec.NAME}: {len(fused)} fused and {len(host)} host frames of {n}")
    raw = [torch.cat([k[i] for k in raws]) for i in range(len(raws[0]))]
    if dec.NAME == "bounding_boxes":
        ties, _, rows = box_ties(torch, dec, raw)
        loose = [dec.decode_fused(TensorFrame([r[i] for r in rows], pts=0.0), None).meta["boxes"]
                 for i in range(n)]
        same = [match_boxes(f.meta["boxes"], h.meta["boxes"]) for f, h in zip(fused, host)]
        ok = [match_boxes(f.meta["boxes"], h.meta["boxes"], lo)
              for f, h, lo in zip(fused, host, loose)]
    else:
        if dec.NAME == "pose_estimation":  # per keypoint
            tied = top2_ties(torch, raw[0].reshape(n, -1, raw[0].shape[-1]), 1).numpy()
            eq = [np.all(np.abs(np.array(f.meta["keypoints"]) - np.array(h.meta["keypoints"]))
                         <= np.array([0.1, 0.1, 1e-4]), axis=-1) for f, h in zip(fused, host)]
        else:  # per pixel of the class grid's overlay
            tied = top2_ties(torch, raw[0], -1).numpy()
            eq = [np.all(f.tensors[0] == h.tensors[0], axis=-1) for f, h in zip(fused, host)]
        ties = tied.reshape(n, -1).sum(1)
        same = [bool(e.all()) for e in eq]
        ok = [bool((e | t).all()) for e, t in zip(eq, tied)]
    bad = [i for i, good in enumerate(ok) if not good]
    if bad:
        raise AssertionError(f"{dec.NAME}: the unfused host decode differs from the fused one "
                             f"on frames {bad} where no near-tie reaches")
    if dec.NAME == "bounding_boxes" and not any(f.meta["boxes"] for f in fused):
        raise AssertionError(f"{dec.NAME}: no box in the unfused-against-fused check")
    return {"frames": n, "equal": int(sum(same)), "near_ties": int(ties.sum())}


def float32_check(torch, custom: str, images) -> dict:
    """The family built in float32 (same seed) on the card, TF32 off,
    against the same build on the CPU: every output within rtol = 1e-4 and
    atol = 1e-4 of its largest magnitude (the CPU tests' 1e-4 at their
    outputs' scale of about 1: He-normal random weights drive these outputs
    to 10-30, and float32 sums in another order differ in proportion).
    Returns, over all outputs, the largest difference, the largest output
    magnitude, and the elements outside a fixed rtol = atol = 1e-4 of how
    many."""
    from nnstreamer_tpu_torch.models import build

    module, _, _ = build(custom_props(custom)["arch"], custom_props(custom) | {"dtype": "float32"})
    module.eval()
    x = torch.from_numpy(images)
    with torch.inference_mode():
        want = module(x)
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        got = module.cuda()(x.cuda())
        got = list(got) if isinstance(got, (list, tuple)) else [got]
    out = {"max_abs_diff": 0.0, "max_abs_output": 0.0, "outside_1e-4": 0, "elements": 0}
    for g, w in zip(got, want):
        g = g.cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"float32 {custom}: card output {tuple(g.shape)} against "
                                 f"{tuple(w.shape)}, or not finite")
        d = (g - w).abs()
        scale = max(1.0, w.abs().max().item())
        out["max_abs_diff"] = max(out["max_abs_diff"], d.max().item())
        out["max_abs_output"] = max(out["max_abs_output"], w.abs().max().item())
        out["outside_1e-4"] += int((d > 1e-4 + 1e-4 * w.abs()).sum())
        out["elements"] += w.numel()
        if not torch.allclose(g, w, rtol=1e-4, atol=1e-4 * scale):
            raise AssertionError(f"float32 {custom}: card against CPU off by {d.max().item()} "
                                 f"at an output scale of {scale}")
    return out


def time_nms(torch, np) -> dict:
    """``batched_nms`` alone on the card: host ms per synchronized call
    (median of 10, after 3 warm-up calls) at (128, 128) candidates, as the
    box decoders' device half runs it, and at (128, 300), YOLOv5's ``nms:1``."""
    from nnstreamer_tpu_torch.ops.nms import batched_nms

    out = {}
    rng = np.random.default_rng(0)
    for n in (128, 300):
        xy = rng.uniform(0, 600, (128, n, 2)).astype(np.float32)
        boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 80, (128, n, 2))
                                                 .astype(np.float32)], -1)).cuda()
        scores = torch.from_numpy(rng.uniform(0, 1, (128, n)).astype(np.float32)).cuda()
        times = []
        for i in range(13):
            torch.cuda.synchronize()
            t = time.perf_counter()
            batched_nms(boxes, scores, 0.45)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[f"128x{n}"] = statistics.median(times[3:])
    return out


def vision_text(custom: str, mode: str, opts: dict, batch: int, extra: str = "") -> str:
    """Path f's pipeline: `extra` goes to the decoder (``device-fused=``)
    or, as ``max-stored=``, to the sink."""
    sink = extra if extra.startswith("max-stored") else ""
    dec = "" if sink else extra
    return (f"appsrc name=src ! tensor_filter name=f framework=torch-cuda model=zoo "
            f"custom={custom} max-batch={batch} batch-timeout=20 ! tensor_decoder name=d "
            f"mode={mode} " + " ".join(f"option{k}={v}" for k, v in opts.items())
            + f" {dec} ! tensor_sink name=out {sink}")


def run_vision_path(torch, np, counters, fam, seed: int, card: str, work) -> dict:
    """One family of path f: VISION_FRAMES seeded uint8 frames pushed one
    by one through ``appsrc ! tensor_filter (zoo, max-batch=128) !
    tensor_decoder ! tensor_sink`` at the defaults of the filter's feed,
    the decoder's device half fused.  Checks the fusion, the bytes per frame leaving the
    filter (the fused tensors, on the card), one ``normalize_u8`` launch per
    micro-batch, the sink against the same module called directly in the
    first micro-batch's size, the device half on the card against the CPU,
    the unfused host decode against the fused one (4 frames) and a float32
    build on the card against the CPU (2 frames)."""
    from nnstreamer_tpu_torch.core.buffer import TensorFrame
    from nnstreamer_tpu_torch.core.types import FORMAT_STATIC, StreamSpec, TensorSpec
    from nnstreamer_tpu_torch.models import build, ssd_mobilenet
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    _, name, custom, size, mode, options = fam
    custom = f"{custom},seed:{seed}"
    frames = VISION_FRAMES
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8)
    module, _, out_spec = build(custom_props(custom)["arch"], custom_props(custom))
    module = module.cuda().eval()
    fill = {"labels": work / "labels.txt", "priors": work / "priors.txt", "thr": ""}
    ssd_mobilenet.write_box_priors(str(fill["priors"]))
    if mode == "bounding_boxes":
        # random weights put most candidates over the decoders' default
        # thresholds: set it midway between two candidate scores, about 20
        # per frame over it on the first 16 frames (a trained detector's
        # count), so the unfused check holds every candidate the fused
        # top-128 holds
        probe = vision_decoder(mode, {k: v.format(**fill) for k, v in options.items()})
        with torch.inference_mode():
            raw = module(torch.from_numpy(images[:16]).cuda())
            raw = list(raw) if isinstance(raw, (list, tuple)) else [raw]
            s = (probe._device_ssd(raw)[1] if probe.mode in ("mobilenet-ssd", "tflite-ssd")
                 else probe._device_yolo(raw, 0.0)[1]).double().flatten().sort(descending=True)
        fill["thr"] = repr(float((s.values[319] + s.values[320]) / 2))
    opts = {k: v.format(**fill) for k, v in options.items()}
    dec = vision_decoder(mode, opts)
    text = vision_text(custom, mode, opts, 128, "max-stored=1")
    pipe = parse_pipeline(text)
    arrived, metas = {}, {}

    def on_frame(f):
        arrived[int(f.pts)] = time.perf_counter()
        if f.pts < 128:  # the first micro-batch is held against the direct call
            metas[int(f.pts)] = (f.meta, f.tensors[0])

    pipe["out"].connect_new_data(on_frame)
    counters.zero()
    pipe.start()
    try:
        fused = pipe["d"]._fused
        with recording_io(pipe, "f") as (sizes, outs, _):
            pushed = []
            t0 = time.perf_counter()
            for i in range(frames):
                pushed.append(time.perf_counter())
                pipe["src"].push(images[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
            wall = time.perf_counter() - t0
        launches = counters.read()
        feed = feed_stats(pipe["f"])
        # the filter's output schema of one frame, fused device half included
        schema = pipe["f"].backend.set_input_info(StreamSpec(
            (TensorSpec((size, size, 3), np.uint8),), FORMAT_STATIC))
    finally:
        pipe.stop()
    batches = len(sizes)
    if not fused:
        raise AssertionError(f"{name}: the decoder's device half was not fused into the filter")
    if sorted(arrived) != list(range(frames)):
        raise AssertionError(f"{name}: {len(arrived)} of {frames} frames reached the sink")
    if launches["normalize_u8"] != batches or launches["top1"] or launches["flash_attention"]:
        raise AssertionError(f"{name}: launches {launches} for {batches} micro-batches (want "
                             "normalize_u8 exactly once per micro-batch, no other kernel)")
    check_feed(name, feed, batches, window=False)
    raw_bytes = sum(int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize for t in out_spec.tensors)
    fused_bytes = sum(int(np.prod(t.shape)) * np.dtype(t.dtype).itemsize for t in schema.tensors)
    per_frame = {sum(int(np.prod(shape[1:])) * torch.empty((), dtype=dt).element_size()
                     for shape, dt, _ in b) for b in outs}
    devices = {d for b in outs for _, _, d in b}
    if per_frame != {fused_bytes} or devices != {"cuda"} or fused_bytes >= raw_bytes:
        raise AssertionError(f"{name}: the filter's outputs are {per_frame} bytes a frame on "
                             f"{devices} (want the fused {fused_bytes} on cuda; raw head "
                             f"{raw_bytes})")
    # the same module called directly in the first micro-batch's size; its
    # device half on the card, then against the CPU's on the same raw head
    direct_ms = []
    with torch.inference_mode():
        for _ in range(3):  # the last two are timed: copy in, model, device half, copy out
            _, n, raw, t = next(direct_batches(torch, module, images, sizes[:1]))
            raw = list(raw) if isinstance(raw, (list, tuple)) else [raw]
            direct = [o.cpu() for o in dec.device_fn(raw, device=raw[0].device)]
            direct_ms.append((time.perf_counter() - t) * 1e3)
        halves = device_half_check(torch, dec, raw, float(size))
    del raw
    t = time.perf_counter()
    finished = [dec.decode_fused(TensorFrame([d[i] for d in direct], pts=float(i)), None)
                for i in range(n)]
    finish_ms = (time.perf_counter() - t) * 1e3 / n
    for i, want in enumerate(finished):
        meta, tensor = metas[i]
        if meta != want.meta or not np.array_equal(tensor, want.tensors[0]):
            raise AssertionError(f"{name}: sink frame {i} differs from the direct call's")
    unfused = unfused_check(torch, np, lambda extra: vision_text(custom, mode, opts, 4, extra),
                            images[:4], dec)
    f32 = float32_check(torch, custom, images[:2])
    lat = sorted(arrived[i] - pushed[i] for i in range(frames))
    first = sizes[0] - 1
    span = max(arrived.values()) - arrived[first]
    steady = (frames - first - 1) / span if span > 0 else float("nan")
    p50, p99 = lat[len(lat) // 2] * 1e3, lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    print(f"{name} path f: {frames} frames in {batches} micro-batches "
          f"(sizes {sorted(set(sizes))}), "
          f"decoder {mode} fused; launches {launches}; to the host {fused_bytes} bytes a frame "
          f"(raw head {raw_bytes}); sink equal to the direct call; device half card vs CPU on "
          f"{halves['frames']} frames: {halves['frames_differing']} differ, near-ties "
          f"{halves['near_ties']} in {halves['frames_with_near_ties']} frames ({halves['loose']} "
          f"items they may change); unfused vs fused "
          f"{unfused['equal']} of {unfused['frames']} equal (near-ties {unfused['near_ties']}); "
          f"float32 card vs CPU max abs diff {f32['max_abs_diff']:.3g} at outputs up to "
          f"{f32['max_abs_output']:.3g}, {f32['outside_1e-4']} of {f32['elements']} outside a "
          f"fixed rtol = atol = 1e-4"
          + (f"; score threshold {fill['thr']}" if fill["thr"] else ""))
    batch_ms = statistics.median(direct_ms[1:])
    print(f"{name} path f: {frames / wall:.1f} frames/s overall, {steady:.1f} frames/s after the "
          f"first micro-batch; frame latency (push to sink) p50 {p50:.2f} ms p99 {p99:.2f} ms; "
          f"direct call per {n}-frame batch (copy in, model, device half, copy out) "
          f"{batch_ms:.2f} ms (host clock, synchronized); the decoder's host finish "
          f"{finish_ms:.3f} ms a frame; {feed_line(feed)}; on {card}")
    return {"launches": launches, "batches": batches, "fps": frames / wall, "fps_steady": steady,
            "latency_ms_p50": p50, "latency_ms_p99": p99, "direct_batch_ms": batch_ms,
            "host_finish_ms_per_frame": finish_ms, "bytes_per_frame": fused_bytes,
            "raw_bytes_per_frame": raw_bytes, "device_half": halves, "unfused": unfused,
            "float32": f32, "threshold": fill["thr"] or None}


def run_vision(torch, np, counters, seed: int, card: str, work) -> tuple:
    """Path f: ``batched_nms`` timed alone, then every family of VISION.
    Returns ({family: its launches and micro-batches}, {family: its
    numbers, "nms_ms": ..., "card": card})."""
    t0 = time.perf_counter()
    vision = {"nms_ms": time_nms(torch, np)}
    print("batched_nms alone, host ms per synchronized call: " + ", ".join(
        f"({k.replace('x', ', ')}) {v:.3f}" for k, v in vision["nms_ms"].items()) + f"; on {card}")
    paths = {}
    for fam in VISION:
        torch.cuda.empty_cache()
        r = run_vision_path(torch, np, counters, fam, seed, card, work)
        paths[fam[0]] = {k: r.pop(k) for k in ("launches", "batches")}
        vision[fam[0]] = r
    vision["seconds"] = time.perf_counter() - t0
    print(f"path f: {vision['seconds']:.1f} s")
    vision["card"] = card
    return paths, vision


def kernel_counters() -> Counters:
    """Every kernel wrapper's launch counter."""
    from nnstreamer_tpu_torch.ops import flash_attention as fa
    from nnstreamer_tpu_torch.ops import labeling as lab
    from nnstreamer_tpu_torch.ops import preprocess as pre

    return Counters({"normalize_u8": (pre, "LAUNCHES"), "top1": (lab, "LAUNCHES"),
                     "flash_attention": (fa, "LAUNCHES"),
                     "flash_attention_tensor_cores": (fa, "LAUNCHES_TENSOR_CORES")})


def work_dir() -> Path:
    """``build/chip_smoke`` of the checkout, with a 1001-line labels file."""
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    (work / "labels.txt").write_text("\n".join(f"class{i}" for i in range(1001)))
    return work


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2048, help="frames through MobileNet-v2")
    ap.add_argument("--vit-frames", type=int, default=1024, help="frames through ViT-B/16")
    ap.add_argument("--prompts", type=int, default=16, help="1024-token prompts through GPT-2 small")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the inputs")
    args = ap.parse_args()

    if not (ROOT / "nnstreamer_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: run from a checkout (nnstreamer_tpu_torch/ not found)")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")
    t_start = time.perf_counter()
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; card {card}")
    tf32_off(torch)

    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.ops import flash_attention as fa
    from nnstreamer_tpu_torch.ops import labeling as lab
    from nnstreamer_tpu_torch.ops import preprocess as pre

    t = time.perf_counter()
    _build.build(["normalize_u8", "top1", "flash_attention"])
    print(f"build: {time.perf_counter() - t:.1f} s (nvcc, sm_90a, three kernels in parallel)")

    kernels = [check_normalize(torch, pre), check_top1(torch, lab), check_flash(torch, fa)]
    counters = kernel_counters()
    work = work_dir()
    labels = work / "labels.txt"

    paths = {}
    mobilenet = ("MobileNet-v2", "arch:mobilenet_v2,dtype:bfloat16",
                 {"normalize_u8": 1, "top1": 1}, args.frames, args.seed, card, labels)
    # the path's counted run (it pays the process's first cuDNN set-up),
    # then the feed's A/B in turns
    paths["mobilenet_v2"] = run_labeling_path(torch, np, lab, counters, *mobilenet)
    check_feed("MobileNet-v2", paths["mobilenet_v2"]["feed"], paths["mobilenet_v2"]["batches"],
               window=False)
    feed_ab = {"mobilenet_v2": feed_turns(
        lambda extra, busy: run_labeling_path(torch, np, lab, counters, *mobilenet,
                                              extra=extra, busy=busy),
        "MobileNet-v2", paths["mobilenet_v2"]["labels"], "labels", window=False,
        keys=("fps", "fps_steady", "busy_share"))}
    paths["composed_mobilenet_v2"] = run_composed_path(
        torch, np, lab, counters, args.seed, card, labels, frames=args.frames // 2,
        beside=paths["mobilenet_v2"])
    vit_layers = int(custom_props(VIT_CUSTOM)["layers"])
    paths["vit"] = run_labeling_path(
        torch, np, lab, counters, "ViT-B/16", VIT_CUSTOM,
        {"flash_attention": vit_layers, "flash_attention_tensor_cores": vit_layers, "top1": 1},
        args.vit_frames, args.seed, card, labels)
    check_feed("ViT-B/16", paths["vit"]["feed"], paths["vit"]["batches"], window=False)
    check_vit_float32(torch, paths["vit"].pop("module"), paths["vit"].pop("images"))
    for p in paths.values():
        p.pop("module", None)
        p.pop("images", None)
    torch.cuda.empty_cache()
    lm_shape = (8, int(custom_props(LM_CUSTOM)["seq"]), int(custom_props(LM_CUSTOM)["vocab"]))
    copy_ms = logits_copy_ms(torch, lm_shape)
    print(f"LM logits batch {lm_shape} float32 to the host, host ms: .cpu() into pageable memory "
          f"{copy_ms['pageable']:.1f}; pinned allocation fresh "
          + ("not measured" if copy_ms["pinned_fresh"] is None else f"{copy_ms['pinned_fresh']:.1f}")
          + f", from the caching host allocator {copy_ms['pinned_cached']:.3f}; non_blocking copy "
          f"into pinned memory {copy_ms['pinned_copy']:.1f}; on {card}")
    torch.cuda.empty_cache()
    paths["gpt2_small"] = run_lm_path(torch, np, counters, args.prompts, args.seed, card)
    check_feed("LM", paths["gpt2_small"]["feed"], paths["gpt2_small"]["batches"], window=True)
    torch.cuda.empty_cache()
    feed_ab["gpt2_small"] = feed_turns(
        lambda extra, busy: run_lm_path(torch, np, counters, args.prompts, args.seed, card,
                                        extra=extra),
        "LM", paths["gpt2_small"].pop("argmax"), "argmax", window=True,
        keys=("sps", "sps_steady", "outside_ms_per_invoke"))
    feed_ab["gpt2_small"]["logits_copy_ms"] = copy_ms
    feed_ab["card"] = card
    torch.cuda.empty_cache()
    paths["gpt2_small_generation"] = run_generation_path(torch, np, counters, args.seed, card)
    vision_paths, vision = run_vision(torch, np, counters, args.seed, card, work)
    paths.update(vision_paths)
    print(json.dumps({"feed_ab": feed_ab}))
    for p in paths.values():
        for k in ("labels", "feed"):
            p.pop(k, None)
    print(json.dumps({"generation": paths["gpt2_small_generation"].pop("generation")}))
    composed = paths["composed_mobilenet_v2"]
    print(json.dumps({"composed": {k: composed.pop(k) for k in (
        "fps", "fps_steady", "latency_ms_p50", "latency_ms_p99", "e2")} | {"card": card}}))
    print(json.dumps({"vision": vision}))

    for k in kernels:
        by_path = {name: p["launches"][k["name"]] for name, p in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        k["microbatches_by_path"] = {name: p["batches"] for name, p in paths.items()
                                     if by_path[name]}
        k["kernel_ms"] = k["ms"]
    kernels[2]["launches_tensor_cores_by_path"] = {
        name: p["launches"]["flash_attention_tensor_cores"] for name, p in paths.items()}
    flash = kernels[2]["launches_by_path"]
    print("flash_attention launches per model call: " + ", ".join(
        f"{name} {flash[name]} in {paths[name]['batches']} = {flash[name] / paths[name]['batches']:g}"
        for name in ("vit", "gpt2_small")))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
