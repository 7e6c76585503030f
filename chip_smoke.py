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
   ``device_fn`` call.  The three int8 kernels are held to their plain
   versions in path h (h2), on the inputs the path gives them.
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
   g. media, audio and text in and out, every input written by the script
      from ``--seed`` under ``build/chip_smoke``, each path's checks raising
      on failure:
      1. ``MEDIA_FRAMES`` (1024) 224x224 frames as an I420 ``.y4m`` through
         ``videofilesrc ! tensor_converter`` into MobileNet-v2 (bf16) whose
         weights, a zoo build of another seed saved with ``torch.save``, the
         filter loads from a model repository (``model=model://mobilenet_v2``,
         ``NNS_TPU_MODEL_REPO``): labels equal to the direct call on the
         port reader's RGB frames in the same micro-batch sizes,
         ``normalize_u8`` and ``top1`` exactly once per micro-batch;
         frames/s and latency (emission to sink) beside path a's;
      2. ``MEDIA_FRAMES`` seeded 1 s clips at 16 kHz mono int16 in one
         ``.wav`` through ``audiofilesrc samples-per-buffer=16000 !
         tensor_converter`` into the KWS CNN at Speech Commands' shape (40
         mels, n_fft 400, hop 160, 12 classes, bf16): labels equal to the
         direct call, ``top1`` exactly once per micro-batch and
         ``normalize_u8`` never; a float32 build on the card (TF32 off)
         against the CPU on 8 clips (rtol 1e-4, atol 1e-4 of the largest
         logit's magnitude); a second run through ``tensor_decoder
         mode=flexbuf device-fused=never ! tensor_converter
         mode=custom:flexbuf`` whose logits must be bit-equal to the direct
         call's, and one card tensor through the flexbuf decoder and
         converter bit-equal;
      3. eight 256-byte ASCII prompts (seeded cuts of ``PARAGRAPH``) through
         ``tensor_converter mode=custom:tokenizer ! tensor_filter`` (GPT-2
         small, ``generate:32``, ``max-batch=8``) ``! tensor_decoder
         mode=detokenizer``: ids equal to the direct ``make_generate`` call,
         ``meta["text"]`` equal to their bytes (ids >= 256 as '?'), host
         bytes at the sink, no kernel launch;
      4. ``REGION_FRAMES`` (256) 300x300 frames as a ``.y4m`` through
         ``videofilesrc ! tensor_converter ! tee``, one branch into
         ``tensor_crop``'s raw pad, the other through SSD-MobileNet-v2 300
         (path f's configuration) and ``tensor_decoder mode=tensor_region
         option1=3`` (threshold midway between two candidate scores, about
         20 a frame over it) into its info pad: regions equal to the host
         decode of the direct call's raw heads, every crop equal to a numpy
         slice of the reader's frame, ``normalize_u8`` exactly once per
         micro-batch.
      g1, g2 and g4 also print the card's busy share over a second, whole
      run of the same pipeline (``torch.profiler``, device activity).
   h. int8 on the card (``quantize:int8``; the kernels ``quantize_i8``,
      ``int8_conv`` and ``int8_dwconv``):
      1. ``INT8_FRAMES`` (1024) frames through path a's pipeline with
         ``custom=arch:mobilenet_v2,quantize:int8`` (224, width 1.0, 1001
         classes, bf16, the decoder's device half fused): labels equal to
         the direct call in the same micro-batch sizes; launches exactly
         ``normalize_u8`` and ``top1`` once, ``int8_conv`` 35 (32 by the
         GEMM route, 3 by the gather route), ``int8_dwconv`` 17 and
         ``quantize_i8`` 52 (all one-pass) times per micro-batch, plus one
         ``quantize_i8`` per layer for its weight (by the route its shape
         takes); frames/s and latency beside path a's bf16;
      2. forward hooks on every int8 layer of one MobileNet-v2 micro-batch
         (128 frames), one YOLOv5s 640 micro-batch (``H2_YOLO_FRAMES``) and
         one GPT-2 small call (2 prompts of 1024 tokens): on each captured
         input the activation's and the weight's int8 values and scales and
         the product (in the layer's dtype and as the int32 accumulator)
         bit-equal to the plain versions, by the layer's own routes and by
         the general ones (two-pass, gather); the same at ``INT8_AWKWARD``'s
         shapes (K = 27, 16 and 3072, M = 1 and 65, N = 24 and 1001, odd H
         and W, 6x6 stride 2, C not a multiple of 16 or 4, float32/bf16/fp16
         in), an activation 8 bytes off alignment (the gather route) and a
         row longer than a wave (the two-pass route); the kernels timed on
         both routes at path shapes beside their plain versions, their
         bounds and ``torch._int_mm``;
      3. frames alone give the int8 trunk output of their rows in a
         micro-batch of 128, bit for bit;
      4. SSD-MobileNet-v2 300, YOLOv5s 640 and ViT-B/16 224 (``attn:flash``)
         int8 beside their bf16 builds of the same seed: output correlation
         above 0.8 on 16 frames, time per 128-frame micro-batch of both,
         int8 launches per call; GPT-2 small int8 scoring through the filter
         (8 prompts of 1024 tokens, per-position argmax equal to the direct
         call, 48 ``int8_conv`` per call, all by the GEMM route; ViT-B/16
         the same) and ``generate:32`` through the filter (tokens equal to
         the direct call, 48 ``int8_conv`` per step).
   Prints frames/s or sequences/s and tokens/s, latencies, the direct
   per-batch time and the feed's counters (lane staged and stacking ms per
   batch, window reaped, dispatch_waits and dwell, staging pool reuse rate)
   beside the card line.
5. summary: a ``{"feed_ab": {...}}`` JSON line (paths a and c in both
   modes), a ``{"generation": {...}}`` JSON line (path d's numbers), a
   ``{"composed": {...}}`` JSON line (path e's numbers), a
   ``{"vision": {...}}`` JSON line (path f's numbers), a ``{"media":
   {...}}`` JSON line (path g's numbers), an ``{"int8": {...}}`` JSON line
   (path h's numbers), one
   ``{"kernels": [...]}`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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


def run_lm_path(torch, np, counters, prompts: int, seed: int, card: str, extra: str = "",
                custom: str = LM_CUSTOM, name: str = "LM") -> dict:
    """GPT-2-small scoring: `prompts` seeded prompts of 1024 tokens through
    appsrc ! tensor_filter ! tensor_sink, the filter's feed set by `extra`
    (the defaults when empty), the model by `custom` (path c's; path h
    adds ``quantize:int8``), printed under `name`; checks every frame's
    per-position argmax against the direct call and the flash launches;
    returns the argmaxes, launches, invokes and feed statistics."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    props = custom_props(custom)
    seq, vocab, layers = int(props["seq"]), int(props["vocab"]), int(props["layers"])
    tokens = np.random.default_rng(seed).integers(0, vocab, (prompts, seq), dtype=np.int32)
    # batch-timeout: every mode sees the same full micro-batches
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_filter name=f framework=torch-cuda model=zoo "
        f"custom={custom},seed:{seed} max-batch=8 batch-timeout=1000 {extra} "
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
            raise AssertionError(f"{name}: {len(out)} of {prompts} frames came back, or out of "
                                 "order")
        got = []
        for f in out:
            logits = f.tensors[0]
            if logits.shape != (seq, vocab) or logits.dtype != np.float32 or not np.isfinite(
                    logits).all():
                raise AssertionError(f"{name}: a frame of {logits.shape} {logits.dtype}, or not "
                                     "finite")
            got.append(logits.argmax(-1))
        got = np.stack(got)
        del out, logits
        pipe["out"].frames.clear()
        for kernel in ("flash_attention", "flash_attention_tensor_cores"):
            if launches[kernel] < layers * len(sizes):
                raise AssertionError(f"{name}: {kernel} launched {launches[kernel]} times for "
                                     f"{len(sizes)} invokes of {layers} layers")
        module = pipe["f"].backend._module
        want, batch_s = [], []
        for _, n, logits, t in direct_batches(torch, module, tokens, sizes):
            want.append(logits.argmax(-1).cpu().numpy())
            batch_s.append((time.perf_counter() - t, n))
        want = np.concatenate(want)
        if not np.array_equal(got, want):
            bad = np.argwhere(got != want)
            raise AssertionError(f"{name}: {len(bad)} argmax positions differ from the direct call "
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
    print(f"{name} path{mode}: {prompts} prompts of {seq} tokens in {len(sizes)} invokes (sizes "
          f"{sizes}), per-position argmax equal to the direct call; launches {launches}")
    print(f"{name} path{mode}: {prompts / wall:.2f} sequences/s, "
          f"{prompts * seq / wall:.1f} tokens/s (push to last logits frame at the sink, logits "
          "copied to the host), "
          + ("not measured" if steady is None else f"{steady:.2f}")
          + " sequences/s after the first invoke; latency (push to sink) p50 "
          f"{p50:.1f} ms p99 {p99:.1f} ms; direct model call per {max(sizes)}-prompt batch "
          f"{batch_ms:.2f} ms (host clock, synchronized), time outside the model "
          f"{outside:.1f} ms per invoke (wall / invokes - direct call); on {card}")
    print(f"{name} path{mode}: {feed_line(feed)}; on {card}")
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


def generate_through_filter(torch, np, counters, custom: str, prompts, name: str) -> tuple:
    """``generate:32`` through ``tensor_filter`` (``max-batch=8``), the
    prompts pushed one by one, staged by the lane and reaped by the window,
    against the same module called directly in the pipeline's micro-batch
    sizes.  Returns the sizes and the launch counts read before the direct
    call."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    n, tp = prompts.shape
    vocab = int(custom_props(custom)["vocab"])
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_filter name=f framework=torch-cuda model=zoo "
        f"custom={custom},generate:32 max-batch=8 batch-timeout=1000 ! tensor_sink name=out")
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            for i in range(n):
                pipe["src"].push(prompts[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
        launches = counters.read()
        check_feed(name, feed_stats(pipe["f"]), len(sizes), window=True)
        module = pipe["f"].backend._module
        got = np.stack([f.tensors[0] for f in pipe["out"].frames])
        want = np.concatenate([out.cpu().numpy() for _, _, out, _ in
                               direct_batches(torch, module, prompts, sizes)])
    finally:
        pipe.stop()
    if got.shape != (n, tp + 32) or got.dtype != np.int32 or not np.array_equal(got, want):
        raise AssertionError(f"{name} through the filter: {got.shape} {got.dtype}, "
                             "or tokens not those of the direct call")
    if not np.array_equal(got[:, :tp], prompts) or not ((got >= 0) & (got < vocab)).all():
        raise AssertionError(f"{name}: the prompt is not echoed or a token is out of range")
    return sizes, launches


def run_generation_path(torch, np, counters, seed: int, card: str) -> dict:
    """GPT-2-small generation (path d): one-shot ``generate:<N>`` through the
    filter, cache against no cache, the slotted throughput run with the
    unslotted path beside it, slotted against one-shot in float32, and the
    sampling checks.  Flash attention must launch 0 times."""
    from nnstreamer_tpu_torch.models import transformer as tr
    from nnstreamer_tpu_torch.ops import threefry as tf

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
    sizes, _ = generate_through_filter(torch, np, counters, custom, prompts, "generate:32")
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


#: frames of g1 (224x224 .y4m) and clips of g2 (1 s at 16 kHz in one .wav)
MEDIA_FRAMES = 1024
#: frames of g4 (300x300 .y4m), two micro-batches of 128
REGION_FRAMES = 256
#: the keyword-spotting task's published shape: Speech Commands (Warden
#: 2018), 1 s clips at 16 kHz mono int16, 40 mels, n_fft 400, hop 160, 12
#: classes
KWS_CUSTOM = "arch:kws_cnn,samples:16000,channels:1,classes:12,dtype:bfloat16"
KWS_LABELS = ("yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go",
              "_silence_", "_unknown_")
#: g3's prompts are 256-byte cuts of this text (byte ids are GPT-2 ids)
PARAGRAPH = (
    "A stream of frames arrives from a camera, a microphone or an application, and each "
    "one passes through a chain of elements: a source reads it, a converter turns the raw "
    "bytes into tensors, a filter runs the model on a micro-batch of them, and a decoder "
    "turns what the model returns into labels, boxes, regions or text that a sink hands "
    "back to the application. The pipeline is written as one line of text, and the same "
    "line runs on a laptop or on an accelerator; only the filter's framework changes. "
    "What the user pays for is the time the card spends on each frame, and the delay "
    "between the moment a frame enters and the moment its answer comes out.")


def timed_source(pipe, name: str = "src") -> list:
    """Record the host clock at which source `name` emits each frame (its
    ``frames()`` wrapped before the pipeline starts)."""
    src, emitted = pipe[name], []
    inner = src.frames

    def frames():
        for f in inner():
            emitted.append(time.perf_counter())
            yield f

    src.frames = frames
    return emitted


def stream_numbers(emitted: list, arrived: dict, first: int) -> tuple:
    """Frames/s after the first micro-batch (ending at frame `first`) and
    latency p50/p99 in ms, emission to sink."""
    n = len(emitted)
    lat = sorted(arrived[i] - emitted[i] for i in range(n))
    span = max(arrived.values()) - arrived[first]
    steady = (n - first - 1) / span if span > 0 else float("nan")
    return steady, lat[n // 2] * 1e3, lat[min(n - 1, int(n * 0.99))] * 1e3


def whole_run_busy(text: str):
    """The card's busy share over a second, whole run of `text`'s pipeline
    (a file source feeds it from start to end): the union of the kernels'
    and copies' device intervals (``torch.profiler``) over the host wall
    from ``start()`` to the end of the stream.  None when the profiler saw
    no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(text)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            pipe.start()
            pipe.wait(timeout=600)
            wall = time.perf_counter() - t
    finally:
        pipe.stop()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type.name == "CUDA"]
    return union_us(spans) / (wall * 1e6) if spans else None


def busy_text(share) -> str:
    return ("card busy not measured" if share is None else
            f"card busy {share:.1%} over a second whole run (torch.profiler)")


def check_launches(name: str, launches: dict, want: dict) -> None:
    """Every counter equal to `want`'s, and 0 where `want` names none."""
    want = dict.fromkeys(launches, 0) | want
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")


def run_video_file_path(torch, np, lab, counters, seed: int, card: str, work, beside) -> dict:
    """g1: MEDIA_FRAMES seeded 224x224 frames written as an I420 .y4m, read
    by ``videofilesrc ! tensor_converter`` into MobileNet-v2 whose weights
    (a seeded zoo build's state_dict) come from a model repository through
    ``model://``; labels against the direct call on the port reader's RGB
    frames in the same micro-batch sizes, ``normalize_u8`` and ``top1``
    once per micro-batch."""
    from nnstreamer_tpu_torch.media.y4m import Y4MReader, write_y4m
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    frames = MEDIA_FRAMES
    rng = np.random.default_rng(seed + 9)
    path = work / "g1.y4m"
    write_y4m(str(path), (rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
                          for _ in range(frames)))
    with Y4MReader(str(path)) as r:
        rgb = np.stack(list(r.frames_rgb()))
    custom = "arch:mobilenet_v2,dtype:bfloat16"
    saved, _, _ = build("mobilenet_v2", custom_props(custom) | {"seed": str(seed + 1)})
    version = work / "models" / "mobilenet_v2" / "1"
    version.mkdir(parents=True, exist_ok=True)
    torch.save(saved.state_dict(), version / "model.pt")
    os.environ["NNS_TPU_MODEL_REPO"] = str(work / "models")
    text = (f"videofilesrc name=src location={path} ! tensor_converter ! tensor_filter name=f "
            f"framework=torch-cuda model=model://mobilenet_v2 custom={custom} max-batch=128 "
            f"batch-timeout=20 ! tensor_decoder mode=image_labeling "
            f"option1={work / 'labels.txt'} ! tensor_sink name=out")
    pipe = parse_pipeline(text)
    emitted, arrived = timed_source(pipe), {}
    pipe["out"].connect_new_data(
        lambda f: arrived.__setitem__(round(f.pts * 30), time.perf_counter()))
    counters.zero()
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            t0 = time.perf_counter()
            pipe.wait(timeout=600)
            wall = time.perf_counter() - t0
        launches = counters.read()
        feed = feed_stats(pipe["f"])
        module = pipe["f"].backend._module
        out = pipe["out"].frames
    finally:
        pipe.stop()
    batches = len(sizes)
    if len(out) != frames or sorted(arrived) != list(range(frames)):
        raise AssertionError(f"g1: {len(out)} of {frames} frames reached the sink")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(module.state_dict().values(),
                                                       saved.state_dict().values())):
        raise AssertionError("g1: the filter's weights are not the model repository's")
    check_launches("g1", launches, {"normalize_u8": batches, "top1": batches,
                                    "flash_attention": 0, "flash_attention_tensor_cores": 0})
    got = np.array([f.meta["label_index"] for f in sorted(out, key=lambda f: f.pts)])
    want = np.concatenate([lab.top1_plain(logits)[0].cpu().numpy()
                           for _, _, logits, _ in direct_batches(torch, module, rgb, sizes)])
    if not np.array_equal(got, want):
        raise AssertionError(f"g1: {int((got != want).sum())} labels differ from the direct call")
    steady, p50, p99 = stream_numbers(emitted, arrived, sizes[0] - 1)
    busy = whole_run_busy(text)
    path_a = "" if beside is None else (
        f" (path a in this run: {beside['fps_steady']:.1f} frames/s after the first "
        f"micro-batch, latency push to sink p50 {beside['latency_ms_p50']:.2f} ms p99 "
        f"{beside['latency_ms_p99']:.2f} ms)")
    print(f"g1 video file -> MobileNet-v2 (model://mobilenet_v2, state_dict from the repository): "
          f"{frames} frames in {batches} micro-batches (sizes {sorted(set(sizes))}), labels equal "
          f"to the direct call on the reader's RGB frames; launches {launches}; {frames / wall:.1f} "
          f"frames/s overall, {steady:.1f} after the first micro-batch; latency (emission to "
          f"sink) p50 {p50:.2f} ms p99 {p99:.2f} ms{path_a}; {feed_line(feed)}; "
          f"{busy_text(busy)}; on {card}")
    return {"launches": launches, "batches": batches, "fps": frames / wall, "fps_steady": steady,
            "latency_ms_p50": p50, "latency_ms_p99": p99, "busy_share": busy}


def speech_clips(np, n: int, seed: int):
    """`n` seeded 1 s clips at 16 kHz, int16 (n, 16000, 1): two tones and
    noise at a random level each."""
    rng = np.random.default_rng(seed)
    t = np.arange(16000, dtype=np.float32) / 16000
    freqs = rng.uniform(100, 3000, (n, 2, 1)).astype(np.float32)
    tones = np.sin(2 * np.pi * freqs * t).sum(axis=1) * rng.uniform(0.05, 0.4, (n, 1))
    noise = rng.normal(0, 1, (n, 16000)).astype(np.float32) * rng.uniform(0.01, 0.1, (n, 1))
    return (np.clip(tones + noise, -1, 1) * 32767).astype(np.int16)[..., None]


def run_audio_path(torch, np, lab, counters, seed: int, card: str, work) -> dict:
    """g2: MEDIA_FRAMES seeded clips in one .wav through ``audiofilesrc
    samples-per-buffer=16000 ! tensor_converter`` into the KWS CNN at
    Speech Commands' shape, labels against the direct call, ``top1`` once
    per micro-batch; float32 logits on the card against the CPU; and a
    second run through ``tensor_decoder mode=flexbuf ! tensor_converter
    mode=custom:flexbuf`` whose logits must be bit-equal to the direct
    call's."""
    from nnstreamer_tpu_torch.converters.serialize import FlexbufConverter
    from nnstreamer_tpu_torch.core.buffer import TensorFrame
    from nnstreamer_tpu_torch.decoders.serialize import FlexbufDecoder
    from nnstreamer_tpu_torch.media.wav import write_wav
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    n = MEDIA_FRAMES
    clips = speech_clips(np, n, seed + 11)
    path = work / "g2.wav"
    write_wav(str(path), clips.reshape(-1), 16000)
    labels = work / "kws_labels.txt"
    labels.write_text("\n".join(KWS_LABELS))
    custom = f"{KWS_CUSTOM},seed:{seed}"
    head = (f"audiofilesrc name=src location={path} samples-per-buffer=16000 ! tensor_converter "
            f"! tensor_filter name=f framework=torch-cuda model=zoo custom={custom} "
            "max-batch=128 batch-timeout=20 ! ")
    runs = {}
    for run, tail in (("labels", f"tensor_decoder mode=image_labeling option1={labels}"),
                      ("flexbuf", "tensor_decoder mode=flexbuf device-fused=never ! "
                                  "tensor_converter mode=custom:flexbuf")):
        pipe = parse_pipeline(head + tail + " ! tensor_sink name=out")
        emitted, arrived = timed_source(pipe), {}
        pipe["out"].connect_new_data(lambda f: arrived.__setitem__(round(f.pts), time.perf_counter()))
        counters.zero()
        pipe.start()
        try:
            with recording_batches(pipe, "f") as sizes:
                t0 = time.perf_counter()
                pipe.wait(timeout=600)
                wall = time.perf_counter() - t0
            launches = counters.read()
            module = pipe["f"].backend._module
            out = sorted(pipe["out"].frames, key=lambda f: f.pts)
        finally:
            pipe.stop()
        if len(out) != n or sorted(arrived) != list(range(n)):
            raise AssertionError(f"g2 [{run}]: {len(out)} of {n} clips reached the sink")
        direct = [logits for _, _, logits, _ in direct_batches(torch, module, clips, sizes)]
        runs[run] = {"launches": launches, "sizes": list(sizes), "wall": wall, "out": out,
                     "direct": direct, "numbers": stream_numbers(emitted, arrived, sizes[0] - 1)}
    r = runs["labels"]
    batches = len(r["sizes"])
    check_launches("g2", r["launches"], {"normalize_u8": 0, "top1": batches,
                                         "flash_attention": 0, "flash_attention_tensor_cores": 0})
    got = np.array([f.meta["label_index"] for f in r["out"]])
    want = np.concatenate([lab.top1_plain(d)[0].cpu().numpy() for d in r["direct"]])
    if not np.array_equal(got, want) or got.max() >= len(KWS_LABELS):
        raise AssertionError(f"g2: {int((got != want).sum())} labels differ from the direct call")
    # the serialize decoder and converter: host bytes out of card logits
    f = runs["flexbuf"]
    got_logits = np.stack([fr.tensors[0] for fr in f["out"]])
    want_logits = torch.cat(f["direct"]).cpu().numpy()
    if got_logits.dtype != np.float32 or not np.array_equal(got_logits.view(np.int32),
                                                            want_logits.view(np.int32)):
        raise AssertionError("g2: logits through flexbuf are not bit-equal to the direct call's")
    row = f["direct"][0][:1]  # a card tensor straight into the decoder (materialize)
    back = FlexbufConverter().convert(FlexbufDecoder().decode(TensorFrame([row], pts=0.0), None))
    if not np.array_equal(back.tensors[0].view(np.int32), row.cpu().numpy().view(np.int32)):
        raise AssertionError("g2: the flexbuf decoder changed a card tensor's bits")
    # float32, TF32 off: the card against the CPU on 8 clips
    f32, _, _ = build("kws_cnn", custom_props(custom) | {"dtype": "float32"})
    with torch.inference_mode():
        cpu = f32.eval()(torch.from_numpy(clips[:8])).numpy()
        card_out = f32.cuda()(torch.from_numpy(clips[:8]).cuda()).cpu().numpy()
    diff = float(np.abs(card_out - cpu).max())
    scale = max(1.0, float(np.abs(cpu).max()))
    if not np.allclose(card_out, cpu, rtol=1e-4, atol=1e-4 * scale):
        raise AssertionError(f"g2: float32 logits on the card differ from the CPU's by {diff:.3g}")
    steady, p50, p99 = r["numbers"]
    busy = whole_run_busy(head + f"tensor_decoder mode=image_labeling option1={labels} "
                          "! tensor_sink name=out")
    print(f"g2 wav -> KWS CNN (Speech Commands shape, bf16): {n} clips in {batches} micro-batches "
          f"(sizes {sorted(set(r['sizes']))}), labels equal to the direct call; launches "
          f"{r['launches']}; flexbuf run: {n} logits bit-equal to the direct call ("
          f"{len(f['sizes'])} micro-batches, launches {f['launches']}); float32 card vs CPU max "
          f"abs diff {diff:.3g} at logits up to {scale:.3g} (rtol 1e-4, atol 1e-4 x that); "
          f"{n / r['wall']:.1f} clips/s overall, {steady:.1f} after the first micro-batch; "
          f"latency (emission to sink) p50 {p50:.2f} ms p99 {p99:.2f} ms; {busy_text(busy)}; "
          f"on {card}")
    return {"launches": r["launches"], "batches": batches, "fps": n / r["wall"],
            "fps_steady": steady, "latency_ms_p50": p50, "latency_ms_p99": p99,
            "float32_max_abs_diff": diff, "busy_share": busy}


def run_text_path(torch, np, counters, seed: int, card: str) -> dict:
    """g3: eight 256-byte ASCII prompts through ``tensor_converter
    mode=custom:tokenizer ! tensor_filter (GPT-2 small, generate:32) !
    tensor_decoder mode=detokenizer``: ids against the direct make_generate
    call, text against the ids' bytes, host bytes at the sink, and no
    kernel launch (the KV-cache path's attention is dense)."""
    from nnstreamer_tpu_torch.models import transformer as tr
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    rng = np.random.default_rng(seed + 13)
    source = (PARAGRAPH * 2).encode("ascii")
    prompts = [source[o:o + 256] for o in rng.integers(0, len(PARAGRAPH), 8)]
    ids = np.stack([np.frombuffer(p, np.uint8).astype(np.int32) for p in prompts])
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_converter mode=custom:tokenizer ! tensor_filter name=f "
        f"framework=torch-cuda model=zoo custom={LM_CUSTOM},seed:{seed},generate:32 max-batch=8 "
        "batch-timeout=1000 ! tensor_decoder mode=detokenizer ! tensor_sink name=out")
    counters.zero()
    pipe.start()
    try:
        with recording_io(pipe, "f", keep=True) as (sizes, _, kept):
            t0 = time.perf_counter()
            for i, p in enumerate(prompts):
                pipe["src"].push(np.frombuffer(p, np.uint8), pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
            wall = time.perf_counter() - t0
        launches = counters.read()
        module = pipe["f"].backend._module
        out = sorted(pipe["out"].frames, key=lambda f: f.pts)
    finally:
        pipe.stop()
    got = np.concatenate([k[0].numpy() for k in kept])
    gen = tr.make_generate(module.lm, 32)
    want = np.concatenate([o.cpu().numpy() for _, _, o, _ in direct_batches(torch, gen, ids, sizes)])
    if got.shape != (8, 288) or not np.array_equal(got, want) or not np.array_equal(got[:, :256], ids):
        raise AssertionError("g3: token ids are not the direct make_generate call's")
    for f, row in zip(out, got):
        text = np.where(row < 256, row, ord("?")).astype(np.uint8)
        if type(f.tensors[0]) is not np.ndarray or not np.array_equal(f.tensors[0], text) or \
                f.meta["text"] != text.tobytes().decode("utf-8", errors="replace"):
            raise AssertionError("g3: the sink's text is not the ids' bytes")
    check_launches("g3", launches, {"normalize_u8": 0, "top1": 0, "flash_attention": 0,
                                    "flash_attention_tensor_cores": 0})
    print(f"g3 text in, text out (GPT-2 small, generate:32): 8 prompts of 256 bytes in "
          f"micro-batches {sizes}, ids equal to the direct make_generate call, text equal to "
          f"their bytes ({int((got[:, 256:] >= 256).sum())} of 256 new ids print as '?'), host "
          f"bytes at the sink; launches {launches}; {8 * 32 / wall:.1f} new tokens/s "
          f"({wall:.2f} s); on {card}")
    return {"launches": launches, "batches": len(sizes), "seconds": wall,
            "tokens_per_s": 8 * 32 / wall}


def run_region_path(torch, np, counters, seed: int, card: str, work) -> dict:
    """g4: REGION_FRAMES seeded 300x300 frames as a .y4m, ``videofilesrc !
    tensor_converter ! tee``: one branch into ``tensor_crop``'s raw pad,
    the other through SSD-MobileNet-v2 and ``tensor_decoder
    mode=tensor_region`` into its info pad.  Regions against the host
    decode of the direct call's raw heads, every crop against a numpy slice
    of the reader's frame, ``normalize_u8`` once per micro-batch."""
    from nnstreamer_tpu_torch.core.buffer import TensorFrame
    from nnstreamer_tpu_torch.decoders.tensor_region import TensorRegion
    from nnstreamer_tpu_torch.media.y4m import Y4MReader, write_y4m
    from nnstreamer_tpu_torch.models import build, ssd_mobilenet
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    frames = REGION_FRAMES
    rng = np.random.default_rng(seed + 17)
    path = work / "g4.y4m"
    write_y4m(str(path), (rng.integers(0, 256, (300, 300, 3), dtype=np.uint8)
                          for _ in range(frames)))
    with Y4MReader(str(path)) as r:
        rgb = np.stack(list(r.frames_rgb()))
    custom = f"arch:ssd_mobilenet_v2,classes:91,dtype:bfloat16,seed:{seed}"
    priors = ssd_mobilenet.write_box_priors(str(work / "priors.txt"))
    probe, _, _ = build("ssd_mobilenet_v2", custom_props(custom))
    with torch.inference_mode():  # the threshold midway between two candidate scores
        scores = probe.cuda().eval()(torch.from_numpy(rgb[:16]).cuda())[1].double()
    best = torch.sigmoid(scores).amax(-1).flatten().sort(descending=True).values
    thr = repr(float((best[319] + best[320]) / 2))  # about 20 a frame over it
    del probe, scores
    options = ["3", "", f"{priors}:{thr}", "300:300"] + [""] * 5
    text = (f"videofilesrc name=src location={path} ! tensor_converter ! tee name=t  "
            "t. ! queue ! c.  "
            f"t. ! queue ! tensor_filter name=f framework=torch-cuda model=zoo custom={custom} "
            "max-batch=128 batch-timeout=20 ! tensor_decoder name=d mode=tensor_region "
            + " ".join(f"option{i + 1}={v}" for i, v in enumerate(options) if v)
            + " ! c.  tensor_crop name=c ! tensor_sink name=out")
    pipe = parse_pipeline(text)
    emitted, arrived = timed_source(pipe), {}
    pipe["out"].connect_new_data(
        lambda f: arrived.__setitem__(round(f.pts * 30), time.perf_counter()))
    counters.zero()
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            t0 = time.perf_counter()
            pipe.wait(timeout=600)
            wall = time.perf_counter() - t0
        launches = counters.read()
        module = pipe["f"].backend._module
        out = sorted(pipe["out"].frames, key=lambda f: f.pts)
    finally:
        pipe.stop()
    batches = len(sizes)
    check_launches("g4", launches, {"normalize_u8": batches, "top1": 0, "flash_attention": 0,
                                    "flash_attention_tensor_cores": 0})
    if len(out) != frames:
        raise AssertionError(f"g4: {len(out)} of {frames} crops reached the sink")
    dec = TensorRegion()
    dec.set_options(options)
    regions, crops = [], 0
    for k, n, raw, _ in direct_batches(torch, module, rgb, sizes):
        raw = [o.float().cpu().numpy() for o in raw]
        for i in range(n):
            want = dec.decode(TensorFrame([o[i] for o in raw]), None).tensors[0]
            f = out[k + i]
            if f.meta["crop_regions"] != want.tolist():
                raise AssertionError(f"g4: frame {k + i}'s regions {f.meta['crop_regions']} are "
                                     f"not the direct call's {want.tolist()}")
            regions.append(len(want))
            kept = [(x, y, w, h) for x, y, w, h in want.tolist() if w > 0 and h > 0]
            if not kept:
                kept_crops = [rgb[k + i][0:0, 0:0]]
            else:
                kept_crops = [rgb[k + i][y:y + h, x:x + w] for x, y, w, h in kept]
            if len(f.tensors) != len(kept_crops) or not all(
                    np.array_equal(a, b) for a, b in zip(f.tensors, kept_crops)):
                raise AssertionError(f"g4: frame {k + i}'s crops are not slices of its frame")
            crops += len(kept)
    counts = Counter(regions)
    steady, p50, p99 = stream_numbers(emitted, arrived, sizes[0] - 1)
    busy = whole_run_busy(text)
    print(f"g4 regions -> crop (SSD-MobileNet-v2 300, tensor_region option1=3, threshold {thr}): "
          f"{frames} frames in {batches} micro-batches (sizes {sorted(set(sizes))}), regions "
          f"equal to the host decode of the direct call's raw heads, {crops} crops equal to "
          f"slices of the reader's frames; regions a frame {dict(sorted(counts.items()))}; "
          f"launches {launches}; {frames / wall:.1f} frames/s overall, {steady:.1f} after the "
          f"first micro-batch; latency (emission to sink) p50 {p50:.2f} ms p99 {p99:.2f} ms; "
          f"{busy_text(busy)}; on {card}")
    return {"launches": launches, "batches": batches, "fps": frames / wall, "fps_steady": steady,
            "latency_ms_p50": p50, "latency_ms_p99": p99, "crops": crops, "threshold": thr,
            "busy_share": busy}


def run_media(torch, np, lab, counters, seed: int, card: str, work, beside=None) -> tuple:
    """Path g: g1-g4 (`beside`: path a's numbers of this run, printed
    beside g1's).  Returns ({path: its launches and micro-batches}, {path:
    its numbers, "seconds": ..., "card": card})."""
    t0 = time.perf_counter()
    media, paths = {}, {}
    for name, run in (
            ("g1_video_file", lambda: run_video_file_path(torch, np, lab, counters, seed, card,
                                                          work, beside)),
            ("g2_wav_kws", lambda: run_audio_path(torch, np, lab, counters, seed, card, work)),
            ("g3_text", lambda: run_text_path(torch, np, counters, seed, card)),
            ("g4_regions_crop", lambda: run_region_path(torch, np, counters, seed, card, work))):
        torch.cuda.empty_cache()
        r = run()
        paths[name] = {k: r.pop(k) for k in ("launches", "batches")}
        media[name] = r
    media["seconds"] = time.perf_counter() - t0
    print(f"path g: {media['seconds']:.1f} s")
    media["card"] = card
    return paths, media


# -- path h: int8 on the card ----------------------------------------------------

#: path h's flagship: the reference's mobilenet_v2_1.0_224_quant.tflite
#: analog, MobileNet-v2 (Sandler et al. 2018) at 224, width 1.0, 1001
#: classes, bf16, every convolution int8
INT8_CUSTOM = "arch:mobilenet_v2,dtype:bfloat16,quantize:int8"
#: frames through h1
INT8_FRAMES = 1024
#: the dense int8 rate of the tensor cores (H100 SXM data sheet)
INT8_OPS_PER_S = 1979e12
#: int8 launches per MobileNet-v2 call, reckoned from its _CFG: 35
#: convolutions with groups 1 (the stem, 16 expansions, 17 projections, the
#: head), 17 depthwise, one activation quantization each; by route: the stem
#: (K = 27) and the two expansions of 24 channels gather, the other 32 are
#: 1 x 1 with K a multiple of 16 (GEMM); every activation row is 16-byte
#: aligned and fits a wave (one pass)
MOBILENET_INT8 = {"int8_conv": 35, "int8_conv_gemm": 32, "int8_conv_gather": 3,
                  "int8_dwconv": 17, "quantize_i8": 52, "quantize_i8_onepass": 52}
#: the int8 counters, and the route split of each kernel with routes
INT8_COUNTERS = ("int8_conv", "int8_conv_gemm", "int8_conv_gather", "int8_dwconv", "quantize_i8",
                 "quantize_i8_onepass", "quantize_i8_twopass")
#: h4's builds beside their bf16 builds: (name, custom, size, frames per
#: micro-batch); the SSD heads, YOLOv5s's detect convolutions, ViT's patch
#: embedding and head stay float, as in the JAX package
INT8_DIRECT = (
    ("SSD-MobileNet-v2", "arch:ssd_mobilenet_v2,classes:91,dtype:bfloat16", 300, 128),
    ("YOLOv5s", "arch:yolov5s,size:640,classes:80,dtype:bfloat16", 640, 128),
    ("ViT-B/16", VIT_CUSTOM, 224, 128),
)


def quant_layers(module) -> list:
    from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d, QuantLinear

    return [m for m in module.modules() if isinstance(m, (QuantConv2d, QuantLinear))]


def int8_equal(torch, what: str, got, want) -> None:
    """Bit-equal shapes and values (floats by their bits), or raise."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(
            bits(got) if got.is_floating_point() else got,
            bits(want) if want.is_floating_point() else want):
        raise AssertionError(f"{what}: the kernel is not bit-equal to its plain version")


@contextmanager
def forced_routes(q, two_pass: bool = False, gather: bool = False):
    """``ops/quantize.py``'s route functions forced to the general routes
    (the two-pass quantize, the gather product; the wrappers look the
    functions up at each call), to hold and time both routes of a kernel
    on the same inputs."""
    plan, conv = q.quantize_plan, q.int8_conv_route
    if two_pass:
        q.quantize_plan = lambda *args: q.QuantizePlan("two-pass", 0, 0)
    if gather:
        q.int8_conv_route = lambda *args: "gather"
    try:
        yield
    finally:
        q.quantize_plan, q.int8_conv_route = plan, conv


def check_int8_layer(torch, q, layer, x, what: str) -> None:
    """One int8 layer's kernels on its input `x` against their plain
    versions: the activation's int8 values and scales (by the route its
    shape takes and by the two-pass route), the weight's, then the product
    in the layer's output dtype and as the int32 accumulator (by its route
    and, for groups 1, by the gather route)."""
    from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d

    conv = isinstance(layer, QuantConv2d)
    if conv:
        rows = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    else:
        rows = x.reshape(-1, x.shape[-1])
    xq2, sx2 = q.quantize_rows_plain(rows)
    for two_pass in (False, True):
        with forced_routes(q, two_pass=two_pass):
            xq, sx = q.quantize_rows(rows)
        route = "two-pass" if two_pass else "its route"
        int8_equal(torch, f"{what} quantize_i8 {tuple(rows.shape)} ({route})", xq, xq2)
        int8_equal(torch, f"{what} quantize_i8 scales ({route})", sx, sx2)
    wq, sw = layer.qweight()
    wq2, sw2 = q.quantize_weight_plain(layer.weight)
    int8_equal(torch, f"{what} weight quantize_i8", wq, wq2)
    int8_equal(torch, f"{what} weight scales", sw, sw2)
    routes = (False,) if conv and layer.groups > 1 else (False, True)
    for out in (x.dtype, torch.int32):
        if conv:
            xq4 = xq.reshape(x.shape[0], x.shape[2], x.shape[3], x.shape[1])
            args = (xq4, sx, wq, sw, layer.stride[0], layer.groups, out)
            want = q.conv_i8_plain(*args)
            got = []
            for gather in routes:
                with forced_routes(q, gather=gather):
                    got.append(q.conv_i8(*args))
            kernel = "int8_dwconv" if layer.groups > 1 else "int8_conv"
        else:
            want = q.dense_i8_plain(xq, sx, wq, sw, out)
            got = []
            for gather in routes:
                with forced_routes(q, gather=gather):
                    got.append(q.dense_i8(xq, sx, wq, sw, out))
            kernel = "int8_conv"
        for g, gather in zip(got, routes):
            route = " (gather)" if gather else ""
            int8_equal(torch, f"{what} {kernel}{route} {tuple(x.shape)} -> {out}", g, want)


def check_int8_model(torch, q, module, inputs, name: str) -> int:
    """h2 on one model: every int8 layer's input captured by a forward
    hook during one call on `inputs`, checked against the plain versions
    as it passes; returns the layers checked."""
    seen = []

    def hook(layer, args, out):
        check_int8_layer(torch, q, layer, args[0], f"{name} layer {len(seen)}")
        seen.append(layer)

    handles = [m.register_forward_hook(hook) for m in quant_layers(module)]
    try:
        with torch.inference_mode():
            module(inputs)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return len(seen)


#: frames of h2's YOLOv5s micro-batch (its plain float64 convolutions hold
#: the im2col of the 6 x 6 stem: 0.9 GB at 640 and 16 frames)
H2_YOLO_FRAMES = 16
#: h2's awkward shapes: (n, h, w, c, o, kernel, stride, groups, input dtype)
INT8_AWKWARD = [
    (3, 9, 9, 3, 32, 3, 2, 1, "float32"),  # K = 27, odd size
    (2, 64, 64, 3, 32, 6, 2, 1, "bfloat16"),  # YOLOv5s's 6x6 stride-2 stem, even size
    (2, 65, 63, 3, 32, 6, 2, 1, "float16"),
    (3, 17, 13, 24, 144, 1, 1, 1, "bfloat16"),  # C % 16 = 8
    (2, 13, 11, 40, 70, 3, 1, 1, "float32"),  # C % 16 = 8, O not a multiple of 8
    (2, 15, 15, 20, 36, 3, 2, 1, "bfloat16"),  # C % 8 = 4
    (1, 1, 1, 768, 2304, 1, 1, 1, "bfloat16"),  # M = 1: one decode slot
    (5, 1, 1, 3072, 768, 1, 1, 1, "float32"),  # K = 3072
    (65, 1, 1, 64, 96, 1, 1, 1, "bfloat16"),  # M = 65 on the GEMM route
    (2, 9, 7, 32, 24, 1, 1, 1, "float32"),  # N = 24
    (3, 1, 1, 1280, 1001, 1, 1, 1, "bfloat16"),  # N = 1001
    (2, 11, 11, 16, 96, 1, 1, 1, "float16"),  # K = 16
    (2, 15, 15, 144, 144, 3, 1, 144, "bfloat16"),  # depthwise, odd
    (2, 9, 9, 6, 6, 3, 2, 6, "float32"),  # depthwise, C % 4 != 0
    (1, 10, 10, 32, 32, 3, 2, 32, "float16"),
]


def check_int8_awkward(torch, q) -> int:
    """h2 at INT8_AWKWARD's shapes: a seeded int8 layer of each (and, at
    H = W = 1, the dense layer of the same weight) through
    :func:`check_int8_layer`."""
    from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d, QuantLinear

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    for n, h, w, c, o, k, s, groups, dt in INT8_AWKWARD:
        x = torch.randn(n, c, h, w, device=dev, generator=g).to(getattr(torch, dt))
        x = x.contiguous(memory_format=torch.channels_last)
        conv = QuantConv2d(c, o, k, s, groups).to(dev)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, device=dev, generator=g))
        what = f"awkward {(n, h, w, c, o, k, s, groups, dt)}"
        check_int8_layer(torch, q, conv, x, what)
        if h == w == 1:  # the dense route
            dense = QuantLinear(c, o).to(dev)
            with torch.no_grad():
                dense.weight.copy_(conv.weight.reshape(o, c))
            check_int8_layer(torch, q, dense, x.reshape(n, c), what + " dense")
    torch.cuda.synchronize()
    check_route_edges(torch, q)
    return len(INT8_AWKWARD) + 2


def check_route_edges(torch, q) -> None:
    """h2's two route edges, each bit-equal to its plain version and
    counted on the route it must take: a GEMM-shaped 1 x 1 convolution
    whose activation starts 8 bytes off 16-byte alignment (gather), and one
    row longer than a wave of the one-pass quantize kernel (two-pass); then
    rows of exact .5 ties through both quantize routes."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    n, h, w, c, o = 2, 7, 7, 64, 96
    flat = torch.randint(-127, 128, (n * h * w * c + 8,), dtype=torch.int8, device=dev,
                         generator=g)
    xq = flat[8:].view(n, h, w, c)
    wq = torch.randint(-127, 128, (o, 1, 1, c), dtype=torch.int8, device=dev, generator=g)
    sx, sw = torch.rand(n, device=dev, generator=g), torch.rand(o, device=dev, generator=g)
    if q.int8_conv_route(c, 1, 1, 1, xq.data_ptr(), wq.data_ptr()) != "gather":
        raise AssertionError("h2: an activation 8 bytes off alignment is not routed to gather")
    before = (q.CONV_GEMM_LAUNCHES, q.CONV_GATHER_LAUNCHES)
    for out in (torch.bfloat16, torch.int32):
        int8_equal(torch, f"h2 int8_conv 8 bytes off alignment -> {out}",
                   q.conv_i8(xq, sx, wq, sw, out_dtype=out),
                   q.conv_i8_plain(xq, sx, wq, sw, out_dtype=out))
    if (q.CONV_GEMM_LAUNCHES, q.CONV_GATHER_LAUNCHES) != (before[0], before[1] + 2):
        raise AssertionError("h2: the unaligned activation did not launch the gather route")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cols = sms * q.QUANTIZE_BUF_BYTES // 2 + 8  # bf16: one vector more than a wave holds
    x = torch.randn(1, cols, device=dev, generator=g).to(torch.bfloat16)
    if q.quantize_plan(1, cols, 2, cols, x.data_ptr(), sms).route != "two-pass":
        raise AssertionError(f"h2: a row of {cols} bf16 is not routed to the two-pass kernel")
    before = (q.QUANTIZE_ONEPASS_LAUNCHES, q.QUANTIZE_TWOPASS_LAUNCHES)
    for got, want in zip(q.quantize_rows(x), q.quantize_rows_plain(x)):
        int8_equal(torch, f"h2 quantize_i8 one row of {cols} bf16", got, want)
    if (q.QUANTIZE_ONEPASS_LAUNCHES, q.QUANTIZE_TWOPASS_LAUNCHES) != (before[0], before[1] + 1):
        raise AssertionError("h2: the row longer than a wave did not launch the two-pass route")
    # exact .5 ties (amax 127: scale 1) round half to even on both routes
    ties = torch.tensor([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -3.5] * 2] * 3, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        for two_pass in (False, True):
            with forced_routes(q, two_pass=two_pass):
                got_q = q.quantize_rows(ties.to(dt))
            for got, want in zip(got_q, q.quantize_rows_plain(ties.to(dt))):
                int8_equal(torch, f"h2 quantize_i8 .5 ties {dt} two_pass={two_pass}", got, want)
    torch.cuda.synchronize()


def forced_ms(q, fn, **routes) -> float:
    """:func:`time_ms` of `fn` under :func:`forced_routes`."""
    with forced_routes(q, **routes):
        return time_ms(fn)


def time_int8(torch, q) -> list:
    """The three int8 kernels timed at path shapes on each of their routes
    beside their plain versions, their bounds and, for the GEMM,
    ``torch._int_mm``: quantize_i8 on MobileNet-v2's largest activation
    (the first depthwise input, 112 x 112 x 96 a frame, bf16, 128 frames)
    one-pass and two-pass, int8_conv on a 1 x 1 convolution of its 14 x 14
    stage (96 -> 576) and on GPT-2 small's qkv projection over 8 prompts of
    1024 tokens by the GEMM and the gather routes, int8_dwconv on that
    first depthwise layer.  Each entry's ``ms`` is the route the path takes
    there."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def act(n, c, h, w):
        x = torch.randn(n, c, h, w, device=dev, generator=g).to(torch.bfloat16)
        return x.contiguous(memory_format=torch.channels_last)

    # quantize_i8: x read once, int8 written once; abs, compare, divide, round, clamp
    x = act(128, 96, 112, 112)
    rows = x.permute(0, 2, 3, 1).reshape(128, -1)
    n = rows.numel()
    plan = q.quantize_plan(*rows.shape, 2, rows.stride(0), rows.data_ptr(), sms)
    if plan.route != "one-pass":
        raise AssertionError(f"quantize_i8 at {tuple(rows.shape)}: {plan} (want one pass)")
    quant = {"ms": time_ms(lambda: q.quantize_rows(rows)),
             "two_pass_ms": forced_ms(q, lambda: q.quantize_rows(rows), two_pass=True),
             "plain_ms": time_ms(lambda: q.quantize_rows_plain(rows)), "library_ms": None,
             "shape": list(rows.shape), "plan": plan._asdict()}
    quant["bound_ms"], quant["bound_by"] = bound_ms(n * 3 + 128 * 4, 5 * n)
    # int8_dwconv: that first depthwise layer, 3 x 3 stride 2
    xq, sx = q.quantize_rows(rows)
    xq = xq.reshape(128, 112, 112, 96)
    wq, sw = q.quantize_weight(torch.randn(96, 1, 3, 3, device=dev, generator=g))
    out = 128 * 56 * 56 * 96
    dw = {"ms": time_ms(lambda: q.conv_i8(xq, sx, wq, sw, 2, 96)),
          "plain_ms": time_ms(lambda: q.conv_i8_plain(xq, sx, wq, sw, 2, 96), reps=5),
          "library_ms": None, "shape": [128, 112, 112, 96, "3x3/2"]}
    dw["bound_ms"], dw["bound_by"] = bound_ms(n + 96 * 9 + out * 2, 2 * 9 * out, INT8_OPS_PER_S)
    # int8_conv: a 1 x 1 convolution of the 14 x 14 stage, and GPT-2's qkv
    gemm = {}
    for key, (m, k, o) in (("mobilenet_1x1", (128 * 14 * 14, 96, 576)),
                           ("gpt2_qkv", (8 * 1024, 768, 2304))):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev, generator=g)
        b = torch.randint(-127, 128, (o, k), dtype=torch.int8, device=dev, generator=g)
        sa = torch.rand(m, device=dev, generator=g)
        sb = torch.rand(o, device=dev, generator=g)
        if q.int8_conv_route(k, 1, 1, 1, a.data_ptr(), b.data_ptr()) != "gemm":
            raise AssertionError(f"int8_conv {key}: not on the GEMM route")
        r = {"ms": time_ms(lambda: q.dense_i8(a, sa, b, sb, torch.bfloat16)),
             "gather_ms": forced_ms(q, lambda: q.dense_i8(a, sa, b, sb, torch.bfloat16),
                                    gather=True),
             "plain_ms": time_ms(lambda: q.dense_i8_plain(a, sa, b, sb, torch.bfloat16), reps=5),
             "library_ms": time_ms(lambda: torch._int_mm(a, b.T)), "shape": [m, k, o]}
        r["bound_ms"], r["bound_by"] = bound_ms(m * k + o * k + m * o * 2 + 4 * (m + o),
                                                2 * m * o * k, INT8_OPS_PER_S)
        gemm[key] = r
    conv = dict(gemm["mobilenet_1x1"], gpt2_qkv=gemm["gpt2_qkv"])
    print(f"quantize_i8 {tuple(rows.shape)} bf16: one pass {quant['ms']:.4f} ms ({plan.grid} "
          f"blocks, {plan.rows_per_wave} rows a wave), two passes {quant['two_pass_ms']:.4f} ms, "
          f"plain {quant['plain_ms']:.4f} ms, bound {quant['bound_ms']:.4f} ms "
          f"({quant['bound_by']}); int8_dwconv (128, 112, 112, 96) 3x3/2: kernel {dw['ms']:.4f} "
          f"ms, plain {dw['plain_ms']:.4f} ms, bound {dw['bound_ms']:.4f} ms ({dw['bound_by']})")
    for key, r in gemm.items():
        print(f"int8_conv as a GEMM {key} (M, K, N) {tuple(r['shape'])} -> bf16: GEMM route "
              f"{r['ms']:.4f} ms, gather route {r['gather_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, torch._int_mm (int32 out) {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    common = {"route": "cuda", "max_abs_err": 0.0, "match": True}
    return [dict(common, name="quantize_i8", source="nnstreamer_tpu_torch/csrc/quantize_i8.cu",
                 replaces="nnstreamer_tpu/ops/quantize.py:34", **quant),
            dict(common, name="int8_conv", source="nnstreamer_tpu_torch/csrc/int8_conv.cu",
                 replaces="nnstreamer_tpu/ops/quantize.py:52 (groups 1) and :82", **conv),
            dict(common, name="int8_dwconv", source="nnstreamer_tpu_torch/csrc/int8_dwconv.cu",
                 replaces="nnstreamer_tpu/ops/quantize.py:52 (groups == C)", **dw)]


def check_batch_invariance(torch, module, images) -> list:
    """h3: the int8 trunk's output (the head's activations, before the
    pool) of a frame alone bit-equal to its row in a micro-batch of 128."""
    outs = []
    handle = module.head.register_forward_hook(lambda m, args, out: outs.append(out))
    picks = [0, 61, 127]
    try:
        with torch.inference_mode():
            module(torch.from_numpy(images[:128]).cuda())
            whole = outs.pop()
            for i in picks:
                module(torch.from_numpy(images[i:i + 1]).cuda())
                if not torch.equal(bits(outs.pop()[0]), bits(whole[i])):
                    raise AssertionError(f"h3: frame {i} alone differs from its row in a "
                                         "micro-batch of 128 (int8 trunk output)")
    finally:
        handle.remove()
    return picks


def launches_per_call(torch, counters, fn) -> dict:
    """The int8 counters over one call of `fn` (its weights already cached)."""
    counters.zero()
    fn()
    torch.cuda.synchronize()
    got = counters.read()
    return {k: got[k] for k in INT8_COUNTERS}


def reckoned_routes(q, module) -> dict:
    """int8_conv launches per call of `module` by route, reckoned from each
    groups-1 int8 layer's shape by ``int8_conv_route`` (fresh activations
    and weights are 16-byte aligned)."""
    from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d

    routes = Counter()
    for m in quant_layers(module):
        if not isinstance(m, QuantConv2d):
            routes[q.int8_conv_route(m.in_features, 1, 1, 1, 0, 0)] += 1
        elif m.groups == 1:
            routes[q.int8_conv_route(m.in_channels, *m.kernel_size, m.stride[0], 0, 0)] += 1
    return {"int8_conv_gemm": routes["gemm"], "int8_conv_gather": routes["gather"]}


def correlation(np, a, b) -> float:
    a, b = (t.float().cpu().numpy().ravel() for t in (a, b))
    return float(np.corrcoef(a, b)[0, 1])


def int8_beside_float(torch, np, counters, name: str, custom: str, size: int, batch: int,
                      seed: int, card: str) -> dict:
    """h4 for one image build: the int8 and bf16 builds of one seed on the
    card, the correlation of their outputs on 16 frames (above 0.8, the JAX
    suite's bar), each build's time per micro-batch (CUDA events), the int8
    launches per call, split by route as reckoned."""
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.ops import quantize as q

    props = custom_props(f"{custom},seed:{seed}")
    images = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (batch, size, size, 3), dtype=np.uint8)).cuda()
    mods = [build(props["arch"], p)[0].cuda().eval() for p in (props, props | {"quantize": "int8"})]
    with torch.inference_mode():
        outs = [m(images[:16]) for m in mods]
        outs = [list(o) if isinstance(o, (list, tuple)) else [o] for o in outs]
        corr = [correlation(np, q, f) for f, q in zip(*outs)]
        if min(corr) <= 0.8 or not all(torch.isfinite(q).all() for q in outs[1]):
            raise AssertionError(f"h4 {name}: int8 against bf16 correlation {corr} (want > 0.8), "
                                 "or not finite")
        per_call = launches_per_call(torch, counters, lambda: mods[1](images[:1]))
        reckoned = reckoned_routes(q, mods[1])
        if {k: per_call[k] for k in reckoned} != reckoned:
            raise AssertionError(f"h4 {name}: int8 launches per call {per_call}, want {reckoned}")
        ms = [time_ms(lambda m=m: m(images), reps=5, inner=1) for m in mods]
    print(f"h4 {name} int8: outputs correlate {', '.join(f'{c:.4f}' for c in corr)} with the bf16 "
          f"build's; {batch}-frame micro-batch {ms[1]:.2f} ms against bf16 {ms[0]:.2f} ms (CUDA "
          f"events); int8 launches per call {per_call}; on {card}")
    return {"correlation": corr, "int8_ms": ms[1], "bf16_ms": ms[0], "batch": batch,
            "launches_per_call": per_call}


def run_int8(torch, np, lab, counters, seed: int, card: str, labels, beside=None) -> tuple:
    """Path h: int8 on the card.  h1 the flagship pipeline (INT8_CUSTOM,
    INT8_FRAMES frames, labels against the direct call, launches against
    the reckoned counts) beside path a's bf16 numbers `beside` when given; h2 every
    int8 layer of one MobileNet-v2, YOLOv5s and GPT-2 micro-batch and the
    awkward shapes against the plain versions, then the kernels' times; h3
    the per-sample promise; h4 SSD-MobileNet-v2, YOLOv5s and ViT-B/16
    beside their bf16 builds, GPT-2 small int8 scoring and ``generate:32``
    through the filter.  Returns ({path: launches and micro-batches},
    the summary, the kernel entries)."""
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.ops import quantize as q

    t0 = time.perf_counter()
    paths, summary = {}, {}
    # h1
    r = run_labeling_path(torch, np, lab, counters, "MobileNet-v2 int8", INT8_CUSTOM,
                          {"normalize_u8": 1, "top1": 1, **MOBILENET_INT8}, INT8_FRAMES, seed,
                          card, labels)
    module, images, b = r.pop("module"), r.pop("images"), r["batches"]
    layers = quant_layers(module)
    # each layer quantizes its weight once, at its first call, by the route
    # of its (O, kh kw C/groups) float32 rows
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    weights = Counter(q.quantize_plan(m.weight.shape[0], m.weight[0].numel(), 4,
                                      m.weight[0].numel(), 0, sms).route for m in layers)
    want = {k: v * b for k, v in MOBILENET_INT8.items()}
    want["quantize_i8"] += len(layers)
    want["quantize_i8_onepass"] += weights["one-pass"]
    want["quantize_i8_twopass"] = weights["two-pass"]
    check_launches("h1", r["launches"], {"normalize_u8": b, "top1": b, **want})
    layers = len(layers)
    paths["mobilenet_v2_int8"] = {"launches": r["launches"], "batches": b}
    summary["h1"] = {k: r[k] for k in ("fps", "fps_steady", "latency_ms_p50", "latency_ms_p99")}
    if beside is not None:
        summary["h1"]["bf16_path_a"] = {k: beside[k] for k in summary["h1"]}
    print(f"h1 MobileNet-v2 int8: {r['fps']:.1f} frames/s ({r['fps_steady']:.1f} after the first "
          f"micro-batch), latency p50 {r['latency_ms_p50']:.2f} ms p99 {r['latency_ms_p99']:.2f} "
          "ms" + ("" if beside is None else
                  f", against path a's bf16 {beside['fps']:.1f} ({beside['fps_steady']:.1f}), p50 "
                  f"{beside['latency_ms_p50']:.2f} ms p99 {beside['latency_ms_p99']:.2f} ms")
          + f"; launches per micro-batch {MOBILENET_INT8} as reckoned, plus {layers} weight "
          f"quantizations; on {card}")
    # h2
    checked = {"mobilenet_v2": check_int8_model(
        torch, q, module, torch.from_numpy(images[:128]).cuda(), "MobileNet-v2")}
    _, yolo_custom, yolo_size, _ = INT8_DIRECT[1]
    yolo = build("yolov5s", custom_props(yolo_custom) | {"seed": str(seed), "quantize": "int8"})[0]
    yolo_in = np.random.default_rng(seed).integers(
        0, 256, (H2_YOLO_FRAMES, yolo_size, yolo_size, 3), dtype=np.uint8)
    checked["yolov5s"] = check_int8_model(torch, q, yolo.cuda().eval(),
                                          torch.from_numpy(yolo_in).cuda(), "YOLOv5s")
    del yolo
    lm_props = custom_props(LM_CUSTOM) | {"seed": str(seed), "quantize": "int8"}
    lm = build("transformer", lm_props)[0].cuda().eval()
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, int(lm_props["vocab"]), (2, int(lm_props["seq"])), dtype=np.int32)).cuda()
    checked["gpt2_small"] = check_int8_model(torch, q, lm, tokens, "GPT-2")
    del lm
    checked["awkward"] = check_int8_awkward(torch, q)
    torch.cuda.empty_cache()
    kernels = time_int8(torch, q)
    summary["h2_layers_bit_equal"] = checked
    print(f"h2: every int8 layer's quantize_i8, weight quantize_i8 and int8_conv/int8_dwconv "
          f"(output dtype and int32 accumulator) bit-equal to the plain versions on the layer's "
          f"captured input: {checked}")
    # h3
    picks = check_batch_invariance(torch, module, images)
    summary["h3_frames_alone_equal"] = picks
    print(f"h3: frames {picks} alone: int8 trunk output bit-equal to their rows in a micro-batch "
          "of 128")
    del module
    torch.cuda.empty_cache()
    # h4
    summary["h4"] = {}
    for name, custom, size, batch in INT8_DIRECT:
        summary["h4"][name] = int8_beside_float(torch, np, counters, name, custom, size, batch,
                                                seed, card)
        torch.cuda.empty_cache()
    layers_lm = int(custom_props(LM_CUSTOM)["layers"]) * 4
    r = run_lm_path(torch, np, counters, 8, seed, card, custom=f"{LM_CUSTOM},quantize:int8",
                    name="LM int8")
    lb = r["batches"]
    got = [r["launches"][k] for k in ("int8_conv", "int8_conv_gemm", "quantize_i8", "int8_dwconv")]
    if got != [layers_lm * lb, layers_lm * lb, layers_lm * lb + layers_lm, 0]:
        raise AssertionError(f"LM int8: launches {r['launches']} for {lb} invokes (want every "
                             "int8_conv on the GEMM route)")
    paths["gpt2_small_int8"] = {"launches": r["launches"], "batches": lb}
    summary["h4"]["gpt2_small_scoring"] = {"sps": r["sps"], "sps_steady": r["sps_steady"],
                                           "dense_per_call": layers_lm}
    torch.cuda.empty_cache()
    prompts = np.random.default_rng(seed + 4).integers(
        0, int(custom_props(LM_CUSTOM)["vocab"]), (8, 128), dtype=np.int32)
    counters.zero()
    t = time.perf_counter()
    sizes, launches = generate_through_filter(
        torch, np, counters, f"{LM_CUSTOM},seed:{seed},quantize:int8", prompts, "int8 generate:32")
    gen_s = time.perf_counter() - t
    if launches["int8_conv"] != 32 * layers_lm * len(sizes) or (
            launches["int8_conv_gemm"] != launches["int8_conv"]):
        raise AssertionError(f"int8 generate:32: launches {launches} for {len(sizes)} invokes "
                             f"(want {32 * layers_lm} int8_conv each, one prefill and 31 steps, "
                             "all on the GEMM route)")
    paths["gpt2_small_int8_generation"] = {"launches": launches, "batches": len(sizes)}
    summary["h4"]["gpt2_small_generate32"] = {"invokes": sizes, "seconds": gen_s}
    print(f"h4 GPT-2 small int8 generate:32 through tensor_filter: 8 prompts of 128 tokens in "
          f"micro-batches {sizes}, tokens equal to the direct call; {layers_lm} int8_conv "
          f"launches per step; {gen_s:.1f} s with the direct call; on {card}")
    summary["seconds"] = time.perf_counter() - t0
    summary["card"] = card
    print(f"path h: {summary['seconds']:.1f} s")
    return paths, summary, kernels


def kernel_counters() -> Counters:
    """Every kernel wrapper's launch counter."""
    from nnstreamer_tpu_torch.ops import flash_attention as fa
    from nnstreamer_tpu_torch.ops import labeling as lab
    from nnstreamer_tpu_torch.ops import preprocess as pre
    from nnstreamer_tpu_torch.ops import quantize as q

    return Counters({"normalize_u8": (pre, "LAUNCHES"), "top1": (lab, "LAUNCHES"),
                     "flash_attention": (fa, "LAUNCHES"),
                     "flash_attention_tensor_cores": (fa, "LAUNCHES_TENSOR_CORES"),
                     "quantize_i8": (q, "QUANTIZE_LAUNCHES"),
                     "quantize_i8_onepass": (q, "QUANTIZE_ONEPASS_LAUNCHES"),
                     "quantize_i8_twopass": (q, "QUANTIZE_TWOPASS_LAUNCHES"),
                     "int8_conv": (q, "CONV_LAUNCHES"), "int8_conv_gemm": (q, "CONV_GEMM_LAUNCHES"),
                     "int8_conv_gather": (q, "CONV_GATHER_LAUNCHES"),
                     "int8_dwconv": (q, "DWCONV_LAUNCHES")})


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
    _build.build(["normalize_u8", "top1", "flash_attention", "quantize_i8", "int8_conv",
                  "int8_dwconv"])
    print(f"build: {time.perf_counter() - t:.1f} s (nvcc, sm_90a, six kernels in parallel)")

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
    media_paths, media = run_media(torch, np, lab, counters, args.seed, card, work,
                                   beside=paths["mobilenet_v2"])
    paths.update(media_paths)
    torch.cuda.empty_cache()
    int8_paths, int8, int8_kernels = run_int8(torch, np, lab, counters, args.seed, card, labels,
                                              beside=paths["mobilenet_v2"])
    paths.update(int8_paths)
    kernels += int8_kernels
    print(json.dumps({"feed_ab": feed_ab}))
    for p in paths.values():
        for k in ("labels", "feed"):
            p.pop(k, None)
    print(json.dumps({"generation": paths["gpt2_small_generation"].pop("generation")}))
    composed = paths["composed_mobilenet_v2"]
    print(json.dumps({"composed": {k: composed.pop(k) for k in (
        "fps", "fps_steady", "latency_ms_p50", "latency_ms_p99", "e2")} | {"card": card}}))
    print(json.dumps({"vision": vision}))
    print(json.dumps({"media": media}))
    print(json.dumps({"int8": int8}))

    for k in kernels:
        by_path = {name: p["launches"][k["name"]] for name, p in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        k["microbatches_by_path"] = {name: p["batches"] for name, p in paths.items()
                                     if by_path[name]}
        k["kernel_ms"] = k["ms"]
    for k in kernels:
        routes = {"quantize_i8": ("onepass", "twopass"), "int8_conv": ("gemm", "gather")}
        for route in routes.get(k["name"], ()):
            k.setdefault("launches_by_route", {})[route] = sum(
                p["launches"][f"{k['name']}_{route}"] for p in paths.values())
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
