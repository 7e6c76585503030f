#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nnstreamer_tpu_torch``) on
one NVIDIA GPU.  Run from the root of a checkout::

    python3 chip_smoke.py [--frames 2048] [--vit-frames 1024] [--prompts 16] [--seed 0]
                          [--only i,j,k]

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
         shapes (K = 27, 16 and 3072, M = 1, 65 and 129, N = 24 and 1001,
         odd H and W, 6x6 and 3x3 stride 2 at even and odd sizes, C of 32
         and 64 at 3x3, C not a multiple of 16 or 4, O of 32 and 64,
         depthwise at C = 6, 144, 576 and 960, float32/bf16/fp16 in), each
         also counted once on the route its plan names; an activation 8
         bytes off alignment (1 x 1 on the gather route, 3x3 and depthwise
         in 8-byte copies), the 6x6 stem's 1, 2 and 3 bytes off, a row
         longer than a wave (the two-pass route); ``INT8_STRESS``'s layers
         run ``INT8_STRESS_RUNS`` times back to back, every run bit-equal
         to the plain int32 accumulator; the kernels timed on both routes
         at path shapes beside their plain versions, their bounds and
         ``torch._int_mm``, and (``time_int8_layers``) every gather-route
         and depthwise layer of one MobileNet-v2, SSD-MobileNet-v2 and
         YOLOv5s call at 128 frames beside its bound and cuDNN's bf16
         convolution, with the sums (an ``{"int8_layers": ...}`` line);
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
      h2 also holds ``PAD_EDGES`` (explicit pads as the ``.tflite`` int8 route
      passes them: VALID and asymmetric on the GEMM, gather and depthwise
      routes, j1's stem and first 3x3/2 depthwise layer, the patch-sum
      products on weights of ones) bit-equal to the plain versions.
   i. the shared-prefix KV cache: GPT-2 small (path d's custom and seed),
      ``PREFIX_PROMPTS`` (32) prompts of a shared seeded 256-token prefix and
      a distinct 64-192-token tail through ``tensor_generator slots=16
      chunk=16 max-new=64 prefix-cache=on prefix-grain=64``, and the same run
      with the cache off: every prompt's greedy tokens equal, prefix hits
      above 0; hits, hit tokens, entry bytes and time to first chunk p50 and
      p99 of both runs printed as information.
   j. model files written by ``tests/torch_model_files.py`` (struct and
      numpy) from the zoo MobileNet-v2 (224, width 1.0, 1001 classes,
      float32, ``--seed``, BatchNorm folded; activation ranges from a float
      forward over 32 seeded frames), under ``build/chip_smoke/models``:
      1. a uint8 per-tensor ``.tflite`` with the hosted quantized file's op
         set (``CONV_2D`` and ``DEPTHWISE_CONV_2D`` with fused RELU6,
         ``ADD``, ``AVERAGE_POOL_2D``, ``RESHAPE``): ``FILE_FRAMES`` (1024)
         frames through ``tensor_filter framework=tflite custom=int8:true
         max-batch=128 ! tensor_decoder mode=image_labeling``: labels equal
         to the direct call in the same micro-batch sizes, 128 frames
         bit-equal to the same lowering on the kernels' plain versions,
         ``int8_conv`` (by route) and ``int8_dwconv`` launches per
         micro-batch as the file reckons them (patch sums included), no
         graph call frame by frame; the agreement with ``int8:false`` in
         output quanta, ms per 128 frames beside the zoo's ``quantize:int8``
         build, and every int8 layer timed beside its bound;
      2. the same model to TFLite's int8 spec (int8 per-channel symmetric
         weights, int8 activations), ``FILE_INT8_FRAMES`` (256) int8
         frames, the same checks;
      3. a float32 ``.onnx`` (opset 13: ``Cast``, ``Mul``, ``Add``,
         ``Transpose``, ``Conv`` with ``group``, ``Clip``,
         ``GlobalAveragePool``, ``Flatten``, ``Gemm``), 1024 frames through
         ``framework=onnx`` and the fused labeling decoder: labels equal to
         the zoo's float32 call on the card except at counted near-ties
         (top-2 logits within 1e-4 of the largest magnitude), ``top1`` once
         per micro-batch.
   k. supervision, liveness, lifecycle and card memory, at path a's
      configuration (1024 frames a run) and on path d's GPT-2 small:
      k1 a real ``torch.cuda.OutOfMemoryError`` under an allocator capped
      between one 64-frame and one 128-frame call's peak, each 128-frame
      micro-batch retried as two halves; k2 an injected ``device.oom``,
      ``device.lost`` under ``error-policy=restart`` and a ``hang`` under
      ``stall-policy=restart``, the card's allocated bytes back within
      1 MiB after them; k3 a hot swap between ``model://mobilenet_v2/1``
      and ``/2`` at frame 300 and a rollback on an error burst; k4 the
      memory monitor's watermarks around a tensor of a quarter of the
      card; k5 the slot engine's OOM shed at its third decode call (8
      prompts of 128 tokens, ``generate:32``, ``slots=4 chunk=16``).
      Every run: each frame once and in order, labels equal to the
      direct call of the model that served each micro-batch (in its
      size), ``normalize_u8`` and ``top1`` once per successful call.
   l. observability on the card, at path a's configuration (``OBS_FRAMES``
      1024 frames) and on path d's GPT-2 small:
      1. ``latency=1 throughput=1`` with ``enable_tracing()``, a flight
         recorder and ``serve_metrics(0)``, ``/metrics`` scraped over
         127.0.0.1 mid-run and after EOS: ``nns.element.frames`` of the
         filter and the sink 1024, ``nns.filter.invokes`` equal to the
         micro-batches and to the ``normalize_u8`` and ``top1`` launches,
         labels equal to the direct call, the tracer's bytes through the
         filter 1024 x 224 x 224 x 3, and ``torch.profiler`` seeing the
         same device-to-host copies traced as untraced, of the labels'
         bytes only; frames/s traced and untraced, the filter's proctime
         p50/p99 and ``latency_us`` (the host's time around the backend
         call) beside the direct call's device time per frame, printed as
         information;
      2. ``trace=1 trace-dir=...`` over a warm-up micro-batch of 128
         frames and then ``OBS_SHORT_FRAMES`` (256) counted frames behind an
         ``annotate`` marker: after ``stop()`` one Chrome trace naming, after
         the marker, the ``normalize_u8`` and ``top1`` kernels as often as
         their launch counters count them, and no profiler session left;
      3. k2's hang under ``stall-policy=restart`` with the recorder armed:
         exactly one dump, posted on the bus, holding the filter's open
         span with its trace id and a thread profile in which the filter's
         thread is parked in the hung call; every frame once, labels equal;
      4. ``output-combination=i0,o0`` with manual ``input``/``input-type``
         matching the model, 256 frames: i0 byte-equal to each pushed frame,
         o0 bit-equal to the direct call's logits; a mismatching ``input``
         and a mismatching ``output`` raise the JAX package's texts;
      5. GPT-2 small, 8 prompts of 128 tokens, ``slots=4 chunk=16``, 32
         greedy tokens, with and without the three ``slo-*`` objectives:
         equal tokens, 8 streams good, the ``nns.slo.*`` series in a scrape.
   m. tensor_query on the card: servers and clients in this process over
      127.0.0.1, ``port=0``, ``connect-type=tcp``:
      1. ``QUERY_FRAMES`` (1024) seeded frames through ``appsrc !
         tensor_query_client wire-batch=32 max-in-flight=8 ! tensor_sink``
         into ``tensor_query_serversrc block-ingress=true !`` path a's filter
         and fused labeling decoder ``! tensor_query_serversink``: every frame
         once and in order, labels equal to the direct call in the server's
         micro-batch sizes, ``normalize_u8`` and ``top1`` once each a
         micro-batch, device-to-host copies the labels' bytes only
         (``torch.profiler``), every answer's span segments adding up to
         its total exactly, the ``nns.query.*`` series in both ``/metrics``
         scrapes (client requests = server admissions), and a second client
         pinned to ``wire-version=1`` on ``QUERY_V1_FRAMES`` (256) frames
         equal to the direct call; frames/s after the first micro-batch,
         push-to-sink p50/p99 and the server's stacking ms beside path a's;
      2. GPT-2 small (path d's custom and seed) behind ``tensor_generator
         slots=16 chunk=16 prefill-chunk=128 max-new=32``: 8 concurrent ``stream=true`` clients
         of one 128-token prompt each, tokens equal to the in-process
         generator's and chunks sized as the unslotted path's; then with
         ``max-new=768`` (the same ``chunk=16``): a client stopped
         mid-stream frees its slot (``gen_cancelled`` + 1) within 1 s, and a
         client budget of ``QUERY_BUDGET_S`` ends in the typed-expiry final
         chunk, which must reach the client before its budget ends (the
         engine cuts decode calls short for the deadline), whose partial
         tokens equal the in-process generator's;
      3. faults while the card serves, two m1 servers behind ``hosts=``:
         a ``corrupt=bitflip`` fault at ``tcp_query.send`` every
         ``QUERY_FAULT_EVERY`` requests (fired = detected = retried = refused),
         one server drained mid-stream (GOAWAY seen as sent, drain ``dropped``
         0, no breaker trip), and a held card tensor lifting
         ``memory_reserved`` over a third server's ``mem-high-watermark`` (BUSY
         replies = memory sheds, released memory ends the shed); every frame
         once, labels equal to the direct call of the micro-batch that
         served it.
   n. edge pub/sub, MQTT and discovery on the card, everything over
      127.0.0.1 in this process on the port's own ``MiniBroker``:
      1. ``DIST_FRAMES`` (1024) seeded frames from ``appsrc ! edgesink
         connect-type=tcp topic=cam`` into ``edgesrc connect-type=tcp !``
         path a's filter and fused labeling decoder ``! mqttsink
         pub-topic=labels qos=1``, read by ``mqttsrc sub-topic=labels qos=1
         ! tensor_sink``: every label once and equal to the direct call in
         the server's micro-batch sizes, ``normalize_u8`` and ``top1`` once
         each a micro-batch, device-to-host copies the labels' bytes only
         (``torch.profiler``); frames/s after the first micro-batch,
         push-to-listener p50/p99 and the MQTT leg (the header's sent
         epoch) beside paths a's and m's; then ``DIST_MQTT_FRAMES`` (256)
         frames over ``mqttsink qos=1`` into ``mqttsrc qos=1`` and the same
         filter, every frame once, labels equal; no mqttsrc dropped a message
         for a full receive queue (``dropped_full`` 0: both size theirs to
         the stream, ``max-msg-buf-size`` = its frames);
      2. two m1 servers announcing on ``topic=lab`` (``dest-brokers=`` a
         standby) and a third that announces and crashes without deleting
         its announce: a client with ``topic=lab`` and no ``hosts=`` finds
         the two live servers and skips the stale one, and labels
         ``DIST_QUERY_FRAMES`` (512) frames equal to the direct call of the
         micro-batch that served them; mid-stream one server drains (one of
         its micro-batches held ``DIST_HOLD_S`` so its listener stays open):
         its announce turns ``draining:true``; from then on the draining
         server admits no request, the running client fails over on every
         GOAWAY it sent, and a client that starts then discovers it
         draining (its endpoint hint), gets no GOAWAY and labels
         ``DIST_LATE_FRAMES`` (64) frames equal, nothing dropped;
         ``Pipeline.degraded_feedback``
         on the other announces ``degraded:true``; then the first broker
         closes: ``nns.query.reannounces`` and ``plane_reconnects`` 1 per
         server, and a fresh client discovers both through the standby
         (the degraded one hinted) and labels ``DIST_FAILOVER_FRAMES``
         (256) frames equal;
      3. without ``grpc``, edgesink and edgesrc in ``connect-type=server``,
         ``client`` and ``hybrid``, ``tensor_sink_grpc`` and
         ``tensor_src_grpc`` fail at ``start()`` with the typed error and
         leave no thread; with ``grpc``, n1's edge leg over
         ``connect-type=hybrid`` on 256 frames, labels equal, ``normalize_u8``
         and ``top1`` once each a micro-batch, and the gRPC broker dropped
         nothing (``dropped_full`` 0; the pushes are paced to stay within
         its subscriber queue of 64).
   o. stream continuity and the fleet's control loop, everything over
      127.0.0.1 in this process; GPT-2 small in float32 (path d's widths,
      ``--seed``), its tokens held against an uninterrupted in-process run
      (``slots=8 chunk=8``): every stream ``FLEET_NEW`` (64) tokens once,
      chunk indices contiguous, one final chunk, equal up to the first
      divergence, which must fall where the uninterrupted run's top-2 logit
      gap (a full forward of the same weights) is at most ``FLEET_GAP``
      (1e-2); every stream's divergence and gap are printed:
      1. two servers ``tensor_query_serversrc ! tensor_generator slots=8 !
         tensor_query_serversink``, 16 stream clients (``stream-resume`` on)
         of 128-token prompts, eight trying each server first; once 16
         tokens of every stream arrived, ``request_drain()`` on A: A's
         ``gen_goaway_evicted`` = the streams live on A = B's ``gen_resumes``
         = the clients' ``stream_migrations``; then A restarted on its port,
         a stream on B, and B stopped without a drain: the stream resumes
         on A (``stream_resumes`` 1, A's ``gen_resumes`` 1);
      2. ``request_resize(16)`` on a serving ``slots=8`` generator with 8
         streams: they hand off and resume on the same server at the new
         width (hand-offs = resumes = migrations), ``gen_resizes`` 1, no
         ``_LEDGER_ATTRS`` counter below its value before, and the card's
         peak allocated bytes over the resize below the bytes before it plus
         the new cache less the old one (plus 256 MiB): the old cache goes
         before the new one is allocated; the bytes are printed;
      3. two MobileNet-v2 labeling servers (path m1's) and a GPT-2 server
         (``slots=8 max-new=256``) announcing with ``digest-interval=0.5``
         on a ``MiniBroker``, a ``FleetObservatory`` over them:
         ``FLEET_FRAMES`` (512) frames over both MobileNet-v2 servers, labels
         equal to the direct call of the micro-batch that served them,
         ``normalize_u8`` and ``top1`` once each a micro-batch, 4 streams on
         the GPT-2 server; the rollup's ``admitted`` and ``tokens`` equal the
         sums of the servers' own ledgers, and still after one MobileNet-v2
         server stops (tombstoned, retired); ``nns.fleet.*`` in a scrape;
      4. two ``FleetController``s contending for a ``LeaderLease`` over a
         ``LeaseChannel`` (TTL 2 s, ticked every 0.1 s), their actuator in
         this process: drain -> ``serversrc.request_drain(epoch)`` (then the
         drained pipeline stopped), resize ->
         ``generator.request_resize(slots, epoch)``, spawn -> one more
         MobileNet-v2 server.  The first takes the lease (the standby is
         refused), spawns a server for a floor of 3, then, with
         ``min_servers=1``, drains an idle MobileNet-v2 server while a client
         sends ``FLEET_DRAIN_FRAMES`` (512) frames to both: every frame once,
         labels equal, ``normalize_u8`` and ``top1`` once each a micro-batch.
         The leader stops; the standby takes the lease at a higher epoch,
         drains the other MobileNet-v2 server and widens the busy GPT-2
         server to 16 slots (its streams hand off and resume, every one
         whole); the deposed leader's drain and resize raise
         ``StaleEpochError`` with nothing touched (``stale_epoch_rejects`` 1
         on each target); ``nns.autoscale.*`` in a scrape.
      The KV-cache decode launches no kernel (o1, o2).
   p. user filters, ``framework=auto``, the native mailbox core and the
      launch CLI (the entry points a user starts a pipeline from):
      1. ``framework=auto`` on path j's uint8 ``.tflite`` (``custom=int8:true``)
         and ``.onnx`` (written again under ``--only p``), 256 frames each in
         blocks of 128: the framework resolved, labels and every launch
         count equal to the same frames through ``framework=tflite`` /
         ``framework=onnx``;
      2. path a's MobileNet-v2 (224, width 1.0, 1001 classes, bf16) as a
         batched ``custom-easy`` callable (the micro-batch to the card,
         ``normalize_u8``, the body), the decoder on the host: 512 frames
         at ``max-batch=128``, labels equal to the module called directly
         in the same micro-batch sizes, ``normalize_u8`` once per invoke;
      3. the same body traced on the card (float input, after
         normalization) and saved as TorchScript, served by
         ``framework=auto model=<x>.pt`` (the ``torch`` backend): 256 frames,
         logits equal bit for bit to the traced module called directly;
      4. ``framework=custom`` on ``libscaler.so`` (g++ from the port's
         ``native/examples/scaler_custom.cc``, ``custom=mult:2.0``) and
         ``framework=python3`` on a doubling script, 256 float32 frames of
         (224, 224, 3): every output ``2 * x`` exactly; a missing g++ fails;
      5. path a's pipeline, 2048 frames at ``max-batch=128``, on the port's
         ``queue.Queue`` mailboxes and, swapped in by the script, on the
         port's ``NativeMailbox`` (the JAX package's default; the core built
         with g++, a missing g++ fails), in 5 alternating pairs: labels
         equal across the runs and to path a's, ``normalize_u8`` and
         ``top1`` once per micro-batch, frames/s of each run and the pairs'
         ratios;
      6. ``cli.launch.main`` in process on ``videotestsrc`` (256 random
         frames) ``! tensor_converter ! tensor_filter framework=torch-cuda``
         (path a's model) ``! tensor_decoder ! tensor_sink``: exit 0, both
         kernels once per invoke; the same text through ``python -m
         nnstreamer_tpu_torch.cli.launch`` exits 0; ``tensor_src_iio`` on
         a fake sysfs tree (``le:s12/16>>4`` and ``be:u16/16``, 64 frames)
         equal to a numpy decode of its bytes.
   q. converted and exported models as ``.pt2`` ``torch.export`` programs,
      the rest of the CLI and the kernel build cache:
      1. path j's uint8 ``.tflite`` converted with ``--int8`` and its
         ``.onnx``, each by ``python -m nnstreamer_tpu_torch.cli.convert``
         in a child process; each program through ``framework=auto`` and
         ``framework=torch-cuda``, 512 frames in blocks of 128 with the
         labeling decoder: labels equal to path j's graph called directly
         (the ``.onnx``: except at counted near-ties), the int8 kernels'
         and ``top1``'s launches per micro-batch as path j1's; ms per 128
         frames beside the eager graph;
      2. ``export_model`` of path a's MobileNet-v2 (bf16), its
         ``quantize:int8`` build and path b's ViT-B/16 (``attn:flash``),
         traced on the CPU, served on the card: labels equal to the module's,
         ``normalize_u8`` once and flash 12 times a call from inside the
         program; the eager host ms of a kernel through its operator;
      3. the ``--int8`` program at 1, 7 and 128 frames in one call each, the
         ``.onnx``'s ``--fixed`` conversion at 7 frames a call a frame:
         bit-equal to path j's graphs;
      4. ``confchk`` names the card and the six kernel libraries built,
         ``inspect`` lists 44 element classes, path a's text round-trips
         through ``pbtxt`` and labels alike, ``codegen`` C (g++) and Python
         filters pass frames through;
      5. a child process on a fresh ``NNS_TPU_CUDA_CACHE_DIR`` runs nvcc six
         times, a second on the same directory none; both times to the
         first micro-batch.
      Under ``--only q`` the kernel checks and ``time_int8`` run first, and
      the kernels line and the ok line close the output as in a whole run.
   r. in-pipeline training (``datareposrc ! tensor_trainer framework=torch``):
      1. the MNIST CNN (28x28x1, 10 classes, float32) on the JAX trainer's
         synthetic task (class = the brightest of 10 row bands), 2048 + 256
         samples written from ``--seed`` through ``appsrc ! datareposink``,
         trained ``datareposrc epochs=3 is-shuffle=true``, batch 32, adam
         1e-3: per-epoch loss and accuracy, the last validation accuracy at
         least ``TRAIN_VAL_FLOOR`` (0.9), the first epoch's 64 step losses
         (from the step-64 checkpoint's cursor) within 1e-3 + 1e-2 * |cpu| of
         the same run with ``accelerator=cpu`` in this process (TF32 off),
         ms per step and steps/s, the card's busy share over a 1-epoch run;
         no kernel launches (the model scales its uint8 input itself);
      2. a child process with deterministic algorithms on and
         ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, beside r3's gradient checks
         and r4 (neither timed): r1's run with
         ``checkpoint-steps=16`` uninterrupted, killed by ``FAULTS`` at
         ``trainer.step`` (step 41) and resumed with ``resume=true``, and torn
         at ``trainer.checkpoint.commit`` (step 32) and resumed from step 16:
         the final weights, optimizer state and model file bit-identical to
         the uninterrupted run's, the replay skip equal to the cursor's stream
         position, every (epoch, sample) trained once in the uninterrupted
         run's order, the torn step never resumed;
      3. ViT-B/16 (path b's widths, bf16, ``attn:flash``) trained 8 adam steps
         (1e-4) on one seeded batch of 32 repeated, through ``appsrc !
         tensor_trainer`` with a step checkpoint and a model file: flash
         exactly 12 times a forward, all on the tensor cores (its backward
         recomputes through ``reference_attention_lse``: no launch); the loss
         falling; one step's gradients against ``attn:xla`` on the same
         weights within a relative L2 of 6e-2 per parameter in bf16 (batch
         32; 3e-2 over all parameters together) and 1e-4 in float32 (batch
         2); a direct step's ms, the flash
         forward's and the recompute backward's device ms (``torch.profiler``)
         and peak memory;
      4. r3's checkpoint directory and model file each served by
         ``tensor_filter framework=torch-cuda`` with the labeling decoder's
         fused half, 64 frames: labels equal to the trained module called
         directly in the same micro-batch sizes, 12 flash launches and one
         ``top1`` a micro-batch.
      Under ``--only r`` the kernel checks and ``time_int8`` run first, and
      the kernels line and the ok line close the output.
   ``--only i,j,k,l,m,n,o,p,q,r`` runs paths i, j, k, l, m, n, o, p, q and r
   alone after the kernel build (j with ``PAD_EDGES`` first), each summary a
   JSON line.
   Prints frames/s or sequences/s and tokens/s, latencies, the direct
   per-batch time and the feed's counters (lane staged and stacking ms per
   batch, window reaped, dispatch_waits and dwell, staging pool reuse rate)
   beside the card line.
5. summary: a ``{"feed_ab": {...}}`` JSON line (paths a and c in both
   modes), a ``{"generation": {...}}`` JSON line (path d's numbers), a
   ``{"composed": {...}}`` JSON line (path e's numbers), a
   ``{"vision": {...}}`` JSON line (path f's numbers), a ``{"media":
   {...}}`` JSON line (path g's numbers), an ``{"int8": {...}}`` JSON line
   (path h's numbers), a ``{"prefix_cache": {...}}`` line (path i's), a
   ``{"model_files": {...}}`` line (path j's), a ``{"supervision": {...}}``
   line (path k's), an ``{"observability": {...}}`` line (path l's), a
   ``{"query": {...}}`` line (path m's), a ``{"distributed": {...}}`` line
   (path n's), a ``{"fleet": {...}}`` line (path o's: o1-o4's counts, times
   and peaks), a ``{"user_filters": {...}}`` line (path p's), an
   ``{"exported": {...}}`` line (path q's), a ``{"training": {...}}`` line
   (path r's), one
   ``{"kernels": [...]}`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
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
            # kernels that run within moments of the session's start or end
            # can be left out of it (seen on the card: a session's launches
            # missing from its events): margins on both sides
            time.sleep(0.2)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.2)
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
        ("ViT-B/16 training", (32, 197, 12, 64), None, bf16, False, "fused"),
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
                                        ("ViT-B/16", (128, 197, 12, 64), False, f32),
                                        ("ViT-B/16 training", (32, 197, 12, 64), False, bf16)):
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
                      card, labels, extra: str = "", busy: bool = False, on_start=None) -> dict:
    """One image-labeling path: `frames` seeded 224x224 frames pushed one by
    one, the filter's feed set by `extra` (the defaults when empty); checks
    labels, launches and the direct call; returns the path's launches,
    micro-batches, labels, feed statistics and module.  With `busy`, a
    second pipeline of the same configuration measures the card's busy
    share over a steady window.  `on_start` gets the started pipeline."""
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
        if on_start is not None:
            on_start(pipe)
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
                  prefill_chunk: int = 128, keep=None, extra: str = ""):
    """`prompts` pushed at once through appsrc ! tensor_generator !
    tensor_sink (the generator's properties `extra` added); returns the
    tokens per prompt, the push clock per prompt, the arrival clock of every
    chunk by prompt, the wall seconds and whatever `keep(pipe)` returned
    before the pipeline stopped."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_generator name=g custom={custom} max-new={max_new} "
        f"chunk={chunk} slots={slots} prefill-chunk={prefill_chunk} {extra} ! "
        "tensor_sink name=out")
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
    (2, 12, 12, 32, 32, 3, 1, 1, "bfloat16"),  # a 128-byte stage spans 4 taps; O = 32
    (2, 11, 11, 64, 64, 3, 1, 1, "float16"),  # 2 taps a stage; O = 64
    (2, 16, 16, 32, 64, 3, 2, 1, "bfloat16"),  # 3x3/2 even (pads 0 and 1)
    (2, 17, 15, 32, 64, 3, 2, 1, "float32"),  # 3x3/2 odd
    (1, 3, 43, 32, 32, 3, 1, 1, "bfloat16"),  # M = 129: one row past a tile
    (2, 32, 32, 3, 32, 3, 2, 1, "bfloat16"),  # MobileNet-v2's stem, even
    (2, 40, 40, 128, 128, 3, 1, 1, "bfloat16"),  # YOLOv5s's bottleneck, K = 1152
    (2, 7, 7, 960, 960, 3, 1, 960, "bfloat16"),  # depthwise C = 960
    (2, 14, 14, 576, 576, 3, 2, 576, "float32"),  # depthwise 3x3/2, C = 576
    (2, 9, 9, 3, 160, 3, 2, 1, "bfloat16"),  # C = 3, O past one tile: byte loads
    (2, 11, 11, 20, 20, 3, 1, 20, "float32"),  # depthwise C % 8 = 4: 4-byte copies
    (2, 224, 224, 3, 32, 3, 2, 1, "bfloat16"),  # path j1's stem at full size
    (2, 112, 112, 96, 96, 3, 2, 96, "bfloat16"),  # j1's first 3x3/2 depthwise layer
]


def route_counts(q) -> tuple:
    return q.CONV_GEMM_LAUNCHES, q.CONV_GATHER_LAUNCHES, q.DWCONV_LAUNCHES


def check_int8_awkward(torch, q) -> int:
    """h2 at INT8_AWKWARD's shapes: a seeded int8 layer of each (and, at
    H = W = 1, the dense layer of the same weight) through
    :func:`check_int8_layer`, then one call by its own plan, counted on the
    route the plan names; the route edges; the stress case."""
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
        before = route_counts(q)
        conv(x)
        wq = conv.qweight()[0]
        route = "depthwise" if groups > 1 else q.int8_conv_plan(
            c, o, k, k, s, 0, wq.data_ptr()).route  # fresh activations are aligned
        want = tuple(b + (r == route) for b, r in zip(before, ("gemm", "gather", "depthwise")))
        if route_counts(q) != want:
            raise AssertionError(f"{what}: launches {route_counts(q)} from {before}, want the "
                                 f"{route} route once")
        if h == w == 1:  # the dense route
            dense = QuantLinear(c, o).to(dev)
            with torch.no_grad():
                dense.weight.copy_(conv.weight.reshape(o, c))
            check_int8_layer(torch, q, dense, x.reshape(n, c), what + " dense")
    torch.cuda.synchronize()
    check_route_edges(torch, q)
    check_pad_edges(torch, q)
    check_int8_stress(torch, q)
    return len(INT8_AWKWARD) + 1 + len(ROUTE_EDGES) + len(PAD_EDGES) + len(INT8_STRESS)


#: the stress case: (n, h, w, c, o, kernel, stride, groups) layers each run
#: INT8_STRESS_RUNS times back to back, every run compared bit for bit (a
#: missing fence between the gather producers' copies and wgmma, or between
#: a depthwise box and its readers, shows only as rare wrong values)
INT8_STRESS = [
    (8, 320, 320, 32, 64, 3, 2, 1),  # YOLOv5s's second convolution (16-byte copies)
    (8, 640, 640, 3, 32, 6, 2, 1),  # its stem (byte copies)
    (16, 40, 40, 128, 128, 3, 1, 1),  # its bottleneck: 9 stages a tile
    (16, 112, 112, 96, 96, 3, 2, 96),  # MobileNet-v2's first strided depthwise layer
    (8, 160, 160, 3, 160, 3, 2, 1),  # C = 3, O past one tile: byte loads, not staged
    (16, 56, 56, 20, 20, 3, 1, 20),  # depthwise by 4-byte copies
]
INT8_STRESS_RUNS = 40


def check_int8_stress(torch, q) -> None:
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(9)
    for n, h, w, c, o, k, s, groups in INT8_STRESS:
        xq = torch.randint(-127, 128, (n, h, w, c), dtype=torch.int8, device=dev, generator=g)
        wq = torch.randint(-127, 128, (o, k, k, c // groups), dtype=torch.int8, device=dev,
                           generator=g)
        sx, sw = torch.rand(n, device=dev, generator=g), torch.rand(o, device=dev, generator=g)
        want = q.conv_i8_plain(xq, sx, wq, sw, s, groups, torch.int32)
        runs = [q.conv_i8(xq, sx, wq, sw, s, groups, torch.int32)
                for _ in range(INT8_STRESS_RUNS)]
        torch.cuda.synchronize()
        bad = [i for i, r in enumerate(runs) if not torch.equal(r, want)]
        if bad:
            raise AssertionError(f"stress {(n, h, w, c, o, k, s, groups)}: runs {bad} of "
                                 f"{INT8_STRESS_RUNS} differ from the plain int32 accumulator")
        del runs, want


#: h2's narrow copies: ((n, h, w, c, o, kernel, stride, groups), bytes the
#: activation starts off 16-byte alignment, the plan it must take: (route,
#: copy bytes, staged runs) or ("depthwise", copy bytes))
ROUTE_EDGES = [
    ((2, 7, 7, 64, 96, 3, 2, 1), 8, ("gather", 8, False)),
    ((2, 7, 7, 64, 64, 3, 2, 64), 8, ("depthwise", 8)),
    ((2, 7, 7, 64, 96, 3, 2, 1), 1, ("gather", 1, False)),  # byte loads, 1 byte off
    ((2, 9, 9, 3, 160, 3, 2, 1), 0, ("gather", 1, False)),  # C = 3, O past one tile
    ((2, 20, 18, 3, 32, 6, 2, 1), 1, ("gather", 1, True)),  # YOLOv5s's stem, runs staged
    ((2, 20, 18, 3, 32, 6, 2, 1), 2, ("gather", 1, True)),
    ((2, 20, 18, 3, 32, 6, 2, 1), 3, ("gather", 1, True)),
    ((2, 7, 7, 64, 64, 3, 2, 64), 4, ("depthwise", 4)),
    ((2, 11, 11, 20, 20, 3, 1, 20), 0, ("depthwise", 4)),  # C % 8 = 4
    ((2, 9, 9, 6, 6, 3, 2, 6), 0, ("depthwise", 1)),
]


def check_route_edges(torch, q) -> None:
    """h2's route edges, each bit-equal to its plain version and counted on
    the route it must take: a GEMM-shaped 1 x 1 convolution whose
    activation starts 8 bytes off 16-byte alignment (gather), ROUTE_EDGES
    (each also on the plan it must take), and one row longer than a wave
    of the one-pass quantize kernel (two-pass); then rows of exact .5 ties
    through both quantize routes."""
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
    # the narrow copies, each on the plan (copy bytes, staged runs) it must take
    for (n, h, w, c, o, k, s, groups), off, want in ROUTE_EDGES:
        flat = torch.randint(-127, 128, (n * h * w * c + off,), dtype=torch.int8, device=dev,
                             generator=g)
        xe = flat[off:].view(n, h, w, c)
        we = torch.randint(-127, 128, (o, k, k, c // groups), dtype=torch.int8, device=dev,
                           generator=g)
        se, sxe = torch.rand(o, device=dev, generator=g), torch.rand(n, device=dev, generator=g)
        if groups == 1:
            plan = q.int8_conv_plan(c, o, k, k, s, xe.data_ptr(), we.data_ptr())
            got = ("gather", plan.chunk, plan.staged) if plan.route == "gather" else ("gemm",)
        else:
            plan = q.int8_dwconv_plan(n, h, w, c, k, k, s, xe.data_ptr() % 16, 132)
            got = ("depthwise", plan.chunk)
        what = f"h2 route edge {(n, h, w, c, o, k, s, groups)} {off} bytes off"
        if got != want:
            raise AssertionError(f"{what}: plan {got}, want {want}")
        before = route_counts(q)
        for out in (torch.bfloat16, torch.int32):
            int8_equal(torch, f"{what} -> {out}", q.conv_i8(xe, sxe, we, se, s, groups, out),
                       q.conv_i8_plain(xe, sxe, we, se, s, groups, out))
        counted = tuple(b + 2 * (r == want[0])
                        for b, r in zip(before, ("gemm", "gather", "depthwise")))
        if route_counts(q) != counted:
            raise AssertionError(f"{what}: launches {route_counts(q)} from {before}, want the "
                                 f"{want[0]} route twice")
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


#: explicit pads, as the ``.tflite`` int8 route passes them: ((n, h, w, c, o,
#: kernel, stride, groups), (top, bottom, left, right), the route it must
#: take, and "ones" for a patch-sum product (weights of ones)
PAD_EDGES = [
    ((2, 7, 7, 64, 96, 1, 1, 1), (0, 0, 0, 0), "gemm"),  # explicit 0s keep the GEMM route
    ((2, 9, 9, 64, 96, 3, 1, 1), (0, 0, 0, 0), "gather"),  # VALID
    ((2, 10, 9, 32, 64, 3, 2, 1), (0, 0, 0, 0), "gather"),  # VALID 3x3/2
    ((2, 9, 11, 32, 64, 3, 1, 1), (2, 0, 1, 2), "gather"),  # asymmetric
    ((2, 9, 9, 3, 32, 3, 2, 1), (0, 1, 1, 0), "gather"),  # C = 3, asymmetric
    ((2, 5, 5, 16, 8, 1, 2, 1), (0, 0, 0, 0), "gather"),  # 1x1 stride 2
    ((2, 9, 9, 64, 64, 3, 1, 64), (0, 0, 0, 0), "depthwise"),  # VALID
    ((2, 10, 10, 64, 64, 3, 2, 64), (1, 0, 0, 1), "depthwise"),  # asymmetric 3x3/2
    ((2, 9, 9, 20, 20, 3, 1, 20), (2, 1, 0, 2), "depthwise"),  # C % 8 = 4, asymmetric
    # j1's shapes: the stem and the first 3x3/2 depthwise layer, SAME (0, 1, 0, 1)
    ((4, 224, 224, 3, 32, 3, 2, 1), (0, 1, 0, 1), "gather"),
    ((4, 112, 112, 96, 96, 3, 2, 96), (0, 1, 0, 1), "depthwise"),
    # the patch sums: weights of ones, O = 1 by the gather route, C depthwise
    ((4, 224, 224, 3, 1, 3, 2, 1), (0, 1, 0, 1), "gather", "ones"),
    ((2, 9, 9, 32, 1, 3, 1, 1), (0, 0, 0, 0), "gather", "ones"),
    ((4, 56, 56, 144, 144, 3, 1, 144), (1, 1, 1, 1), "depthwise", "ones"),
]


def check_pad_edges(torch, q) -> None:
    """PAD_EDGES, each bit-equal to the plain version (int32 accumulator and
    bf16), of the output size its pads give, and counted on its route."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(13)
    for (n, h, w, c, o, k, s, groups), pads, route, *ones in PAD_EDGES:
        xq = torch.randint(-127, 128, (n, h, w, c), dtype=torch.int8, device=dev, generator=g)
        wq = (torch.ones((o, k, k, c // groups), dtype=torch.int8, device=dev) if ones else
              torch.randint(-127, 128, (o, k, k, c // groups), dtype=torch.int8, device=dev,
                            generator=g))
        sx, sw = torch.rand(n, device=dev, generator=g), torch.rand(o, device=dev, generator=g)
        what = f"pad edge {(n, h, w, c, o, k, s, groups)} pads {pads}" + (" ones" if ones else "")
        before = route_counts(q)
        for out in (torch.int32, torch.bfloat16):
            got = q.conv_i8(xq, sx, wq, sw, s, groups, out, pads)
            if tuple(got.shape[2:]) != q.conv_out(h, w, k, k, s, pads):
                raise AssertionError(f"{what}: output {tuple(got.shape)}")
            int8_equal(torch, f"{what} -> {out}", got,
                       q.conv_i8_plain(xq, sx, wq, sw, s, groups, out, pads))
        counted = tuple(b + 2 * (r == route)
                        for b, r in zip(before, ("gemm", "gather", "depthwise")))
        if route_counts(q) != counted:
            raise AssertionError(f"{what}: launches {route_counts(q)} from {before}, want the "
                                 f"{route} route twice")
    torch.cuda.synchronize()
    print(f"int8 explicit pads: {len(PAD_EDGES)} cases (VALID, asymmetric, j1's 3x3/2 "
          "layers, patch sums on weights of ones) bit-equal to the plain versions on their "
          "routes", flush=True)


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


#: the model calls whose gather-route and depthwise int8 layers
#: time_int8_layers times one by one: (name, custom, size)
INT8_LAYER_MODELS = (
    ("MobileNet-v2", INT8_CUSTOM, 224),
    ("SSD-MobileNet-v2", f"{INT8_DIRECT[0][1]},quantize:int8", 300),
    ("YOLOv5s", f"{INT8_DIRECT[1][1]},quantize:int8", 640),
)
#: frames of each timed layer's input (a micro-batch of the paths)
INT8_LAYER_FRAMES = 128


def int8_layer_inputs(torch, module, inputs) -> list:
    """(layer, input shape) of every int8 layer of `module` in call order,
    from forward hooks during one call on `inputs`."""
    seen = []
    handles = [m.register_forward_hook(lambda m, args, out: seen.append((m, tuple(args[0].shape))))
               for m in quant_layers(module)]
    try:
        with torch.inference_mode():
            module(inputs)
    finally:
        for h in handles:
            h.remove()
    return seen


def time_int8_layers(torch, np, q, seed: int, card: str) -> dict:
    """Each gather-route ``int8_conv`` and each ``int8_dwconv`` layer of one
    call of INT8_LAYER_MODELS, at its own shape over INT8_LAYER_FRAMES
    frames (random int8 input, the layer's int8 weight), bf16 out: the
    kernel's time (CUDA events), its bound, and cuDNN's bf16 convolution
    at the same shape as the bf16 build runs it (channels_last; a strided
    layer on its SAME-padded input, the pad not timed).  Returns, per model
    and kernel, the layers and the sums."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    n = INT8_LAYER_FRAMES
    result = {}
    for name, custom, size in INT8_LAYER_MODELS:
        props = custom_props(f"{custom},seed:{seed}")
        module = build(props["arch"], props)[0].cuda().eval()
        frame = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, (1, size, size, 3), dtype=np.uint8)).cuda()
        per_kernel = {"int8_conv_gather": [], "int8_dwconv": []}
        for layer, (_, c, h, w) in int8_layer_inputs(torch, module, frame):
            if not isinstance(layer, QuantConv2d):
                continue
            (kh, kw), s, groups, o = layer.kernel_size, layer.stride[0], layer.groups, \
                layer.out_channels
            if groups == 1 and q.int8_conv_route(c, kh, kw, s, 0, 0) != "gather":
                continue
            xq = torch.randint(-127, 128, (n, h, w, c), dtype=torch.int8, device=dev, generator=g)
            sx = torch.rand(n, device=dev, generator=g)
            wq, sw = layer.qweight()
            ms = time_ms(lambda: q.conv_i8(xq, sx, wq, sw, s, groups), reps=7, inner=5)
            ho, wo = -(-h // s), -(-w // s)
            outs = n * ho * wo * o
            bound, by = bound_ms(xq.numel() + wq.numel() + 2 * outs + 4 * (n + o),
                                 2 * outs * kh * kw * (c // groups), INT8_OPS_PER_S)
            del xq
            xb = torch.randn(n, c, h, w, device=dev, generator=g).to(torch.bfloat16)
            xb = xb.contiguous(memory_format=torch.channels_last)
            pad = (kh - 1) // 2
            if s > 1:
                top, bottom = q.same_pads(h, kh, s)
                left, right = q.same_pads(w, kw, s)
                xb, pad = F.pad(xb, (left, right, top, bottom)), 0
            wb = torch.randn(o, c // groups, kh, kw, device=dev, generator=g).to(torch.bfloat16)
            wb = wb.contiguous(memory_format=torch.channels_last)
            cudnn = time_ms(lambda: F.conv2d(xb, wb, stride=s, padding=pad, groups=groups),
                            reps=7, inner=5)
            del xb
            per_kernel["int8_dwconv" if groups > 1 else "int8_conv_gather"].append(
                {"shape": [n, h, w, c, o, kh, s, groups], "ms": ms, "bound_ms": bound,
                 "bound_by": by, "cudnn_bf16_ms": cudnn})
        del module
        torch.cuda.empty_cache()
        result[name] = {}
        for kernel, rows in per_kernel.items():
            if not rows:
                continue
            sums = {k: sum(r[k] for r in rows) for k in ("ms", "bound_ms", "cudnn_bf16_ms")}
            result[name][kernel] = dict(layers=len(rows), **sums, rows=rows)
            print(f"{name} {kernel}: {len(rows)} layers of one call over {n} frames (bf16 out): "
                  f"kernel {sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms "
                  f"({sums['bound_ms'] / sums['ms']:.0%}), cuDNN bf16 {sums['cudnn_bf16_ms']:.4f} "
                  f"ms (CUDA events, sums of per-layer medians); on {card}", flush=True)
    return result


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
    int8 layer of one MobileNet-v2, YOLOv5s, SSD-MobileNet-v2, ViT-B/16 and
    GPT-2 micro-batch (SSD's and ViT's of h4's size) and the awkward
    shapes against the plain versions, then the kernels' times; h3
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
    for key, (name, custom, size, frames) in (("ssd_mobilenet_v2", INT8_DIRECT[0]),
                                              ("vit_b16", INT8_DIRECT[2])):
        props = custom_props(f"{custom},seed:{seed},quantize:int8")
        model = build(props["arch"], props)[0].cuda().eval()
        frames_in = np.random.default_rng(seed).integers(0, 256, (frames, size, size, 3),
                                                         dtype=np.uint8)
        checked[key] = check_int8_model(torch, q, model, torch.from_numpy(frames_in).cuda(), name)
        del model
        torch.cuda.empty_cache()
    lm_props = custom_props(LM_CUSTOM) | {"seed": str(seed), "quantize": "int8"}
    lm = build("transformer", lm_props)[0].cuda().eval()
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, int(lm_props["vocab"]), (2, int(lm_props["seq"])), dtype=np.int32)).cuda()
    checked["gpt2_small"] = check_int8_model(torch, q, lm, tokens, "GPT-2")
    del lm
    checked["awkward"] = check_int8_awkward(torch, q)
    torch.cuda.empty_cache()
    kernels = time_int8(torch, q)
    layer_times = time_int8_layers(torch, np, q, seed, card)
    print(json.dumps({"int8_layers": layer_times | {"card": card}}))
    for k, key in ((kernels[1], "int8_conv_gather"), (kernels[2], "int8_dwconv")):
        k["model_layers"] = {model: {f: t[key][f] for f in (
            "layers", "ms", "bound_ms", "cudnn_bf16_ms")} for model, t in layer_times.items()
            if key in t}
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


# -- path i: the shared-prefix KV cache ------------------------------------------------

#: path i: prompts, each a shared seeded prefix of PREFIX_TOKENS tokens and a
#: distinct tail of 64-192 tokens, through slots=16 with the cache on and off
PREFIX_PROMPTS = 32
PREFIX_TOKENS = 256
PREFIX_GRAIN = 64
PREFIX_NEW = 64


def run_prefix_path(torch, np, counters, seed: int, card: str) -> dict:
    """Path i: GPT-2 small (path d's custom and seed) through ``tensor_generator
    slots=16 chunk=16 prefix-cache=on prefix-grain=64`` and the same run with
    the cache off: every prompt's greedy tokens equal, prefix hits > 0;
    hits, hit tokens, entry bytes and time to first chunk of both runs are
    printed as information."""
    custom = f"{LM_CUSTOM},seed:{seed}"
    vocab = int(custom_props(LM_CUSTOM)["vocab"])
    rng = np.random.default_rng(seed + 11)
    prefix = rng.integers(0, vocab, PREFIX_TOKENS, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, int(n), dtype=np.int32)])
               for n in rng.integers(64, 193, PREFIX_PROMPTS)]
    t0 = time.perf_counter()
    runs = {}
    for mode in ("on", "off"):
        counters.zero()
        extra = f"prefix-cache={mode} prefix-grain={PREFIX_GRAIN}"
        toks, pushed, arrived, wall, snap = run_generator(
            np, custom, prompts, PREFIX_NEW, 16, 16, prefill_chunk=32, extra=extra,
            keep=lambda pipe: pipe["g"]._engine.snapshot())
        ttfc = [(min(arrived[i]) - pushed[i]) * 1e3 for i in range(len(prompts))]
        runs[mode] = {"tokens": toks, "launches": counters.read(), "snapshot": snap,
                      "wall_s": wall, "ttfc_ms_p50": pct(ttfc, 0.5), "ttfc_ms_p99": pct(ttfc, 0.99)}
    bad = [i for i in range(len(prompts))
           if not np.array_equal(runs["on"]["tokens"][i], runs["off"]["tokens"][i])]
    if bad:
        raise AssertionError(f"path i: prompts {bad} give other tokens with prefix-cache=on "
                             "than with it off")
    snap = runs["on"]["snapshot"]
    if snap["prefix_hits"] <= 0 or any(k.startswith("prefix_") for k in runs["off"]["snapshot"]):
        raise AssertionError(f"path i: prefix cache snapshot {snap} (want hits > 0, and no "
                             "prefix keys with the cache off)")
    entry = snap["prefix_bytes"] / max(1, snap["prefix_entries"])
    summary = {"prompts": len(prompts), "prefix_tokens": PREFIX_TOKENS, "grain": PREFIX_GRAIN,
               "prefix_hits": snap["prefix_hits"], "prefix_misses": snap["prefix_misses"],
               "prefix_hit_tokens": snap["prefix_hit_tokens"],
               "prefix_publishes": snap["prefix_publishes"],
               "prefix_entries": snap["prefix_entries"], "entry_bytes": entry,
               "card": card, "seconds": time.perf_counter() - t0}
    for mode in ("on", "off"):
        summary[mode] = {k: runs[mode][k] for k in ("wall_s", "ttfc_ms_p50", "ttfc_ms_p99")}
    print(f"path i: {len(prompts)} prompts of a shared {PREFIX_TOKENS}-token prefix and 64-192 "
          f"tail tokens, {PREFIX_NEW} greedy tokens each through slots=16 chunk=16: tokens equal "
          f"with prefix-cache=on and off; hits {snap['prefix_hits']} misses "
          f"{snap['prefix_misses']}, hit tokens {snap['prefix_hit_tokens']}, "
          f"{snap['prefix_entries']} entries of {entry / 2**20:.2f} MiB; time to first chunk p50 "
          f"{summary['on']['ttfc_ms_p50']:.1f} ms p99 {summary['on']['ttfc_ms_p99']:.1f} ms on, "
          f"{summary['off']['ttfc_ms_p50']:.1f} / {summary['off']['ttfc_ms_p99']:.1f} ms off "
          f"(information only); {summary['seconds']:.1f} s; on {card}")
    return {"launches": runs["on"]["launches"], "batches": snap["gen_decode_steps"],
            "summary": summary}


# -- path j: model files ---------------------------------------------------------------

#: frames of j1 and j3, of j2, and of the calibration forward of the files
FILE_FRAMES = 1024
FILE_INT8_FRAMES = 256
CALIBRATION_FRAMES = 32


def model_files():
    """``tests/torch_model_files.py`` (struct and numpy; the checkout's)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_model_files

    return torch_model_files


def reckon_file_int8(q, lowering) -> dict:
    """int8 kernel launches one call of a lowered ``.tflite`` makes with
    ``int8:true``, from the file: each conv on its route (fresh activations
    and weights are 16-byte aligned) and its patch sums where the weights'
    zero point is not 0 (ones weights on the gather route for kernels over
    1 x 1, a second depthwise launch)."""
    want = {"int8_conv_gemm": 0, "int8_conv_gather": 0, "int8_dwconv": 0}
    for i, layer in lowering.int8_layers.items():
        op = lowering.m.ops[i]
        c = lowering.m.tensors[op.inputs[0]].shape[-1]
        if layer.kind == "DEPTHWISE_CONV_2D":
            want["int8_dwconv"] += 1 + bool(layer.zp_w_p)
            continue
        if layer.kind == "FULLY_CONNECTED":
            kh = kw = stride = 1
        else:
            kh, kw, stride = layer.kh, layer.kw, layer.stride[0]
        pads = None if op.opcode == "FULLY_CONNECTED" or op.options["padding"] == "SAME" else (
            0, 0, 0, 0)
        want[f"int8_conv_{q.int8_conv_route(c, kh, kw, stride, 0, 0, pads)}"] += 1
        if layer.zp_w_p and (kh > 1 or kw > 1 or stride > 1):
            want[f"int8_conv_{q.int8_conv_route(c, kh, kw, stride, 0, 0, pads)}"] += 1
    want["int8_conv"] = want["int8_conv_gemm"] + want["int8_conv_gather"]
    return want


def file_pipeline(np, counters, name: str, text: str, frames, card: str) -> dict:
    """`frames` pushed one by one through the pipeline `text` (its filter
    ``f``, its sink ``out``); the labels, micro-batch sizes, launches,
    module and rates."""
    from nnstreamer_tpu_torch.backends import _importer_common as ic
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(text)
    arrived = {}
    pipe["out"].connect_new_data(lambda f: arrived.__setitem__(int(f.pts), time.perf_counter()))
    counters.zero()
    calls = ic.FRAME_CALLS
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            pushed, t0 = [], time.perf_counter()
            for i, x in enumerate(frames):
                pushed.append(time.perf_counter())
                pipe["src"].push(x, pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
            wall = time.perf_counter() - t0
        launches = counters.read()
        module = pipe["f"].backend._module
        out = pipe["out"].frames
    finally:
        pipe.stop()
    if [f.pts for f in out] != list(range(len(frames))):
        raise AssertionError(f"{name}: {len(out)} of {len(frames)} frames came back, or out of "
                             "order")
    if ic.FRAME_CALLS != calls:
        raise AssertionError(f"{name}: {ic.FRAME_CALLS - calls} graph calls ran frame by frame "
                             "(want 0: every micro-batch folded)")
    lat = sorted(arrived[i] - pushed[i] for i in range(len(frames)))
    return {"labels": np.array([f.meta["label_index"] for f in out]), "sizes": sizes,
            "launches": launches, "module": module, "fps": len(frames) / wall,
            "latency_ms_p50": lat[len(lat) // 2] * 1e3, "frame_calls": ic.FRAME_CALLS - calls,
            "latency_ms_p99": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3}


def direct_labels(torch, np, lab, module, frames, sizes):
    """The module called directly in the pipeline's micro-batch sizes, each
    frame's scores flattened and taken as float32 (the decoder's device
    half), labelled by ``top1_plain``; and the logits."""
    got, logits = [], []
    for _, n, out, _ in direct_batches(torch, module, frames, sizes):
        scores = (out[0] if isinstance(out, (list, tuple)) else out).reshape(n, -1).float()
        got.append(lab.top1_plain(scores)[0].cpu().numpy())
        logits.append(scores)
    return np.concatenate(got), torch.cat(logits)


def time_file_layers(torch, np, q, lowering, n: int, card: str, name: str) -> dict:
    """Every int8 convolution one call of the lowered file makes, with its
    patch sums, at its shape over `n` frames (random int8 input, the layer's
    int8 weights, int32 out): the kernel's time (CUDA events) beside its
    bound, summed by route.  Returns the sums."""
    from nnstreamer_tpu_torch.importers.tflite_lower import _conv_padding

    dev = lowering.device  # where the lowering last ran: the card
    g = torch.Generator(device=dev).manual_seed(12)
    sums = {}

    def add(key, fn, nbytes, ops):
        ms = time_ms(fn, reps=5, inner=3)
        bound, _ = bound_ms(nbytes, ops, INT8_OPS_PER_S)
        row = sums.setdefault(key, {"layers": 0, "ms": 0.0, "bound_ms": 0.0})
        row["layers"] += 1
        row["ms"] += ms
        row["bound_ms"] += bound

    for i, layer in lowering.int8_layers.items():
        op = lowering.m.ops[i]
        shape = lowering.m.tensors[op.inputs[0]].shape
        if layer.kind == "FULLY_CONNECTED":
            continue
        _, h, w, c = shape
        k, s = layer.kh, layer.stride[0]
        (t, b), (left, r) = _conv_padding(op.options, shape, k, k)
        pads = (t, b, left, r)
        ho, wo = q.conv_out(h, w, k, k, s, pads)
        xq = torch.randint(-127, 128, (n, h, w, c), dtype=torch.int8, device=dev, generator=g)
        wq = torch.from_numpy(layer.w_i8).to(dev)
        o = wq.shape[0]
        groups = c if layer.kind == "DEPTHWISE_CONV_2D" else 1
        ones = torch.ones((c, k, k, 1) if groups > 1 else (1, k, k, c), dtype=torch.int8,
                          device=dev)
        s_x, s_w = torch.ones(n, device=dev), torch.ones(o, device=dev)
        route = "depthwise" if groups > 1 else q.int8_conv_plan(
            c, o, k, k, s, xq.data_ptr(), wq.data_ptr(), pads).route
        outs = n * ho * wo * o
        add(route, lambda: q.conv_i8(xq, s_x, wq, s_w, s, groups, torch.int32, pads),
            xq.numel() + wq.numel() + 4 * outs, 2 * outs * k * k * (c // groups))
        if layer.zp_w_p and (groups > 1 or k > 1 or s > 1):
            po = c if groups > 1 else 1
            add(f"patch_sums_{route}", lambda: q.conv_i8(xq, s_x, ones, s_w[:po], s, groups,
                                                         torch.int32, pads),
                xq.numel() + 4 * n * ho * wo * po, 2 * n * ho * wo * po * k * k * (c // groups))
        del xq
    for key, row in sums.items():
        print(f"{name} int8 layers {key}: {row['layers']} of one call over {n} frames (int32 "
              f"out): {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_ms'] / row['ms']:.0%}; CUDA events, sums of per-layer medians); on "
              f"{card}", flush=True)
    return sums


def run_tflite_path(torch, np, lab, q, counters, name: str, path, frames, card: str, labels,
                    zoo=None) -> dict:
    """j1 or j2: `frames` through ``framework=tflite custom=int8:true``: labels
    equal to the direct call in the same micro-batch sizes, one micro-batch
    bit-equal to the kernels' plain versions on the card, the int8 kernels'
    launches per micro-batch as the file reckons them (patch sums included),
    none frame by frame; the agreement with ``int8:false`` in output quanta;
    ms per 128 frames beside the zoo's ``quantize:int8`` build `zoo`."""
    from nnstreamer_tpu_torch.backends._importer_common import ImportedGraph
    from nnstreamer_tpu_torch.importers.tflite_lower import _Lowering
    from nnstreamer_tpu_torch.importers.tflite_reader import read_tflite

    text = (f"appsrc name=src ! tensor_filter name=f framework=tflite model={path} "
            f"custom=int8:true max-batch=128 batch-timeout=20 ! tensor_decoder "
            f"mode=image_labeling option1={labels} ! tensor_sink name=out")
    r = file_pipeline(np, counters, name, text, frames, card)
    module, sizes, b = r["module"], r["sizes"], len(r["sizes"])
    want_labels, _ = direct_labels(torch, np, lab, module, frames, sizes)
    if not np.array_equal(r["labels"], want_labels):
        bad = np.flatnonzero(r["labels"] != want_labels)
        raise AssertionError(f"{name}: {len(bad)} labels differ from the direct call "
                             f"(first frames {bad[:8]})")
    per_batch = reckon_file_int8(q, module.lowering)
    want = {k: v * b for k, v in per_batch.items()} | {"top1": b, "normalize_u8": 0,
                                                       "quantize_i8": 0}
    got = {k: r["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got} for {b} micro-batches (want {want}: "
                             f"{per_batch} a micro-batch, as the file reckons them)")
    x = torch.from_numpy(frames[:128]).cuda()
    with torch.inference_mode():
        kernel = module(x)[0]
        module.lowering.plain = True
        try:
            plain = module(x)[0]
        finally:
            module.lowering.plain = False
        if not torch.equal(kernel, plain):
            raise AssertionError(f"{name}: a micro-batch of 128 on the int8 kernels is not "
                                 "bit-equal to the same lowering on their plain versions")
        model = read_tflite(path)
        fq_low = _Lowering(model, int8_compute=False)
        fq = ImportedGraph(fq_low, fq_low.params(), [4]).cuda().eval()
        fake = fq(x)[0]
        diff = (kernel.int() - fake.int()).abs()
        quanta = {"max": int(diff.max()), "mean": float(diff.float().mean()),
                  "share_off": float((diff > 0).float().mean())}
        ms = {"int8": time_ms(lambda: module(x), reps=7, inner=3),
              "fake_quant": time_ms(lambda: fq(x), reps=5, inner=2)}
        if zoo is not None:
            zx = x.reshape(-1, *x.shape[2:])
            ms["zoo_quantize_int8"] = time_ms(lambda: zoo(zx), reps=7, inner=3)
    del fq
    layers = time_file_layers(torch, np, q, module.lowering, 128, card, name)
    summary = {"frames": len(frames), "micro_batches": b, "launches_per_micro_batch": per_batch,
               "fps": r["fps"], "latency_ms_p50": r["latency_ms_p50"],
               "latency_ms_p99": r["latency_ms_p99"], "fake_quant_quanta": quanta,
               "ms_per_128": ms, "layers": layers, "frame_calls": r["frame_calls"],
               "card": card}
    print(f"{name}: {len(frames)} frames in {b} micro-batches, labels equal to the direct call; "
          f"128 frames bit-equal to the kernels' plain versions; launches per micro-batch "
          f"{per_batch} as the file reckons them, 0 frame by frame; against int8:false: "
          f"{quanta['max']} output quanta at most, {quanta['share_off']:.2%} of outputs off; "
          f"{r['fps']:.1f} frames/s, latency p50 {r['latency_ms_p50']:.2f} ms p99 "
          f"{r['latency_ms_p99']:.2f} ms; ms per 128 frames (direct, CUDA events) "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"; on {card}", flush=True)
    return {"launches": r["launches"], "batches": b, "summary": summary}


def run_onnx_path(torch, np, lab, counters, path, frames, zoo, card: str, labels) -> dict:
    """j3: `frames` through ``framework=onnx`` and the fused labeling decoder:
    labels equal to the zoo model's float32 call on the card except at
    counted near-ties (the zoo's top-2 logits within 1e-4 of the largest
    magnitude), ``top1`` once per micro-batch, none frame by frame."""
    text = (f"appsrc name=src ! tensor_filter name=f framework=onnx model={path} "
            f"max-batch=128 batch-timeout=20 ! tensor_decoder mode=image_labeling "
            f"option1={labels} ! tensor_sink name=out")
    r = file_pipeline(np, counters, "j3", text, frames, card)
    b = len(r["sizes"])
    if r["launches"]["top1"] != b or r["launches"]["normalize_u8"] != 0:
        raise AssertionError(f"j3: launches {r['launches']} for {b} micro-batches (want top1 "
                             "exactly once each and nothing else)")
    want, logits = direct_labels(torch, np, lab, zoo, frames.reshape(-1, *frames.shape[2:]),
                                 r["sizes"])
    top = logits.topk(2, dim=1).values
    ties = ((top[:, 0] - top[:, 1]) < 1e-4 * logits.abs().amax(dim=1)).cpu().numpy()
    bad = np.flatnonzero(r["labels"] != want)
    if not ties[bad].all():
        raise AssertionError(f"j3: {len(bad)} labels differ from the zoo's float32 call, "
                             f"{int((~ties[bad]).sum())} of them away from a near-tie")
    summary = {"frames": len(frames), "micro_batches": b, "fps": r["fps"],
               "latency_ms_p50": r["latency_ms_p50"], "latency_ms_p99": r["latency_ms_p99"],
               "near_ties": int(ties.sum()), "labels_off_at_near_ties": len(bad),
               "frame_calls": r["frame_calls"], "card": card}
    print(f"j3 MobileNet-v2 .onnx float32: {len(frames)} frames in {b} micro-batches, labels "
          f"equal to the zoo's float32 call but {len(bad)} at {int(ties.sum())} counted "
          f"near-ties; top1 once per micro-batch, 0 frame by frame; {r['fps']:.1f} frames/s, "
          f"latency p50 {r['latency_ms_p50']:.2f} ms p99 {r['latency_ms_p99']:.2f} ms; on {card}",
          flush=True)
    return {"launches": r["launches"], "batches": b, "summary": summary}


def write_model_files(torch, np, seed: int, work) -> tuple:
    """Path j's three files of the zoo MobileNet-v2 (224, width 1.0, 1001
    classes, seed `seed`, float32, BatchNorm folded) under ``work/models``:
    ({"uint8", "int8", "onnx": path}, the float32 module on the card, the
    seeded generator after the calibration frames)."""
    from nnstreamer_tpu_torch.models import build

    mf = model_files()
    float32 = build("mobilenet_v2", {"dtype": "float32", "seed": str(seed)})[0].cuda().eval()
    rng = np.random.default_rng(seed + 21)
    calib = rng.integers(0, 256, (CALIBRATION_FRAMES, 224, 224, 3), dtype=np.uint8)
    files = work / "models"
    files.mkdir(parents=True, exist_ok=True)
    paths = {"uint8": files / "mobilenet_v2_quant_uint8.tflite",
             "int8": files / "mobilenet_v2_quant_int8.tflite",
             "onnx": files / "mobilenet_v2_float32.onnx"}
    with torch.inference_mode():
        for spec in ("uint8", "int8"):
            paths[spec].write_bytes(mf.mobilenet_v2_tflite(
                float32, calib, spec, device=next(float32.parameters()).device))
    paths["onnx"].write_bytes(mf.mobilenet_v2_onnx(float32))
    _MODEL_FILES[seed] = paths
    return paths, float32, rng


#: path j's files by seed, for path p's framework=auto (written once a run)
_MODEL_FILES: dict = {}


def run_files(torch, np, lab, counters, seed: int, card: str, work, labels) -> tuple:
    """Path j: the zoo MobileNet-v2 (224, width 1.0, 1001 classes, seed `seed`,
    float32, BatchNorm folded) written by ``tests/torch_model_files.py`` as
    j1 a uint8 per-tensor ``.tflite`` (the hosted quantized file's op set
    and scheme), j2 the same to TFLite's int8 spec, j3 a float32 ``.onnx``,
    the activation ranges from a float forward over CALIBRATION_FRAMES
    seeded frames; each file served on the card.  Returns ({path: launches
    and micro-batches}, the summary)."""
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.ops import quantize as q

    t0 = time.perf_counter()
    paths, float32, rng = write_model_files(torch, np, seed, work)
    print(f"path j: wrote {', '.join(f'{p.name} ({p.stat().st_size / 2**20:.1f} MiB)' for p in paths.values())} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    zoo_int8 = build("mobilenet_v2", {"quantize": "int8", "seed": str(seed)})[0].cuda().eval()
    frames = rng.integers(0, 256, (FILE_FRAMES, 1, 224, 224, 3), dtype=np.uint8)
    out, summary = {}, {}
    r = run_tflite_path(torch, np, lab, q, counters, "j1 MobileNet-v2 .tflite uint8", paths["uint8"],
                        frames, card, labels, zoo=zoo_int8)
    out["tflite_uint8"], summary["j1"] = r, r.pop("summary")
    del zoo_int8
    torch.cuda.empty_cache()
    frames8 = (frames[:FILE_INT8_FRAMES].astype(np.int16) - 128).astype(np.int8)
    r = run_tflite_path(torch, np, lab, q, counters, "j2 MobileNet-v2 .tflite int8 spec",
                        paths["int8"], frames8, card, labels)
    out["tflite_int8"], summary["j2"] = r, r.pop("summary")
    torch.cuda.empty_cache()
    r = run_onnx_path(torch, np, lab, counters, paths["onnx"], frames, float32, card, labels)
    out["onnx_float32"], summary["j3"] = r, r.pop("summary")
    del float32
    torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t0
    summary["card"] = card
    print(f"path j: {summary['seconds']:.1f} s", flush=True)
    return out, summary


# -- path k: supervision, liveness, lifecycle and card memory ----------------------

#: frames of k1, each run of k2, k3's swap run and k4; k3's rollback run
SUPERVISION_FRAMES = 1024
ROLLBACK_FRAMES = 512
MOBILENET_CUSTOM = "arch:mobilenet_v2,dtype:bfloat16"


@contextmanager
def recording_calls():
    """Every ``TorchCuda.invoke_batch`` call, in order: the backend's model
    path, rows, whether it returned, the error's type and its cause's, the
    ``normalize_u8`` / ``top1`` launches made meanwhile, and whether a hot
    swap's staging thread made it (a warm-up call, concurrent with serving
    ones: their launch deltas then overlap)."""
    import threading

    from nnstreamer_tpu_torch.backends.torch_cuda import TorchCuda
    from nnstreamer_tpu_torch.ops import labeling as lab
    from nnstreamer_tpu_torch.ops import preprocess as pre

    inner, calls = TorchCuda.invoke_batch, []

    def invoke_batch(self, inputs):
        rec = {"model": self.model_path, "rows": int(inputs[0].shape[0]), "ok": False,
               "error": None, "cause": None,
               "warm": threading.current_thread().name.endswith("-model-stage")}
        calls.append(rec)
        n0, t0 = pre.LAUNCHES, lab.LAUNCHES
        try:
            out = inner(self, inputs)
            rec["ok"] = True
            return out
        except BaseException as e:
            rec["error"] = type(e).__name__
            rec["cause"] = type(e.__cause__).__name__ if e.__cause__ is not None else None
            raise
        finally:
            rec["normalize_u8"], rec["top1"] = pre.LAUNCHES - n0, lab.LAUNCHES - t0

    with mock.patch.object(TorchCuda, "invoke_batch", invoke_batch):
        yield calls


def served_labels(torch, np, lab, modules: dict, images, calls) -> "np.ndarray":
    """The labels the direct call gives, frame by frame, when each
    successful serving call's rows run through the module of the model
    that served them (``modules`` by model path), in that call's size."""
    want, k = [], 0
    for c in calls:
        if not c["ok"] or c["warm"]:
            continue
        (_, n, logits, _), = direct_batches(torch, modules[c["model"]], images[k:], [c["rows"]])
        want.append(lab.top1_plain(logits)[0].cpu().numpy())
        k += n
    if k != len(images):
        raise AssertionError(f"path k: the calls served {k} rows for {len(images)} frames")
    return np.concatenate(want)


def supervised_run(torch, np, lab, counters, name: str, text: str, images, during=None,
                   modules=None, timeout: float = 600, served=None, setup=None) -> dict:
    """One MobileNet-v2 labeling run of `text`: frames pushed one by one
    (``setup(pipe)`` called before the pipeline starts, ``during(pipe, i)``
    before frame i, ``served()`` once the stream has ended and before the
    direct calls), then the checks every k and l run shares: each frame once and in order, labels equal to the direct
    call of the model that served each micro-batch, ``normalize_u8`` and
    ``top1`` once per successful call (a failed call launched ``top1``
    never).  Returns the calls, launches, health and labels."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(text)
    if setup is not None:
        setup(pipe)
    counters.zero()
    pipe.start()
    try:
        with recording_calls() as calls:
            for i in range(len(images)):
                if pipe.errors:
                    break  # the pipeline failed: wait() raises its error
                if during is not None:
                    during(pipe, i)
                pipe["src"].push(images[i], pts=float(i))
            if not pipe.errors:
                pipe["src"].end_of_stream()
            pipe.wait(timeout=timeout)
        launches = counters.read()
        if served is not None:
            served()
        health = pipe.health()["f"]
        if modules is None:
            be = pipe["f"].backend
            modules = {be.model_path: be._module}
        out = pipe["out"].frames
        if [f.pts for f in out] != [float(i) for i in range(len(images))]:
            raise AssertionError(f"{name}: {len(out)} of {len(images)} frames came back, or "
                                 "some twice or out of order")
        got = np.array([f.meta["label_index"] for f in out])
        want = served_labels(torch, np, lab, modules, images, calls)
    finally:
        pipe.stop()
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(f"{name}: {len(bad)} labels differ from the direct call of the "
                             f"serving model (first frames {bad[:8]})")
    ok = [c for c in calls if c["ok"] and not c["warm"]]
    warm = [c for c in calls if c["warm"]]
    failed = [c for c in calls if not c["ok"]]
    per_call = [(c["rows"], c["ok"], c["warm"], c["normalize_u8"], c["top1"]) for c in calls]
    if not warm and (any(c["top1"] != 1 or c["normalize_u8"] != 1 for c in ok)
                     or any(c["top1"] for c in failed)):
        raise AssertionError(f"{name}: launches per call {per_call} (want one of each per "
                             "successful call, no top1 in a failed one)")
    # a successful model call launches each kernel once; a failed one
    # launched normalize_u8 only where the OOM came after it, never top1
    reckoned = {"normalize_u8": len(ok) + len(warm) + sum(c["normalize_u8"] for c in failed),
                "top1": len(ok) + len(warm)}
    if {k: launches[k] for k in reckoned} != reckoned:
        raise AssertionError(f"{name}: launches {launches}, reckoned from the calls {reckoned} "
                             f"({per_call})")
    return {"calls": calls, "launches": launches, "health": health, "labels": got,
            "batches": len(ok)}


def peak_bytes(torch, be, images, n: int) -> int:
    """``max_memory_allocated`` over one ``n``-frame call of the backend."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = be.invoke_batch([images[:n]])
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated()


def run_k1(torch, np, lab, counters, seed: int, images, labels) -> dict:
    """k1: a real OOM.  The allocator is capped between one 64-frame and one
    128-frame call's peak, three quarters of the way up (the cap counts
    reserved bytes, and a half needs room for the allocator's block
    rounding above its peak of allocated bytes), so every 128-frame
    micro-batch fails with ``torch.cuda.OutOfMemoryError`` and the filter
    retries it as two halves."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    text = labeling_text(f"{MOBILENET_CUSTOM}", seed, labels, "error-policy=restart")
    probe = parse_pipeline(text)
    probe.start()
    try:
        be = probe["f"].backend
        peak_bytes(torch, be, images, 128)  # the first call pays the lazy set-up
        p128, p64 = peak_bytes(torch, be, images, 128), peak_bytes(torch, be, images, 64)
    finally:
        probe.stop()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = p64 + 3 * (p128 - p64) // 4
    print(f"k1: one call's peak allocated bytes {p128} for 128 frames, {p64} for 64; the "
          f"allocator capped at {cap} bytes")
    def uncap():
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
        torch.cuda.empty_cache()

    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total, 0)
    try:
        # the reference labels come from direct calls with the cap lifted
        run = supervised_run(torch, np, lab, counters, "k1", text, images, served=uncap)
    finally:
        uncap()
    calls, h = run["calls"], run["health"]
    failed = [c for c in calls if not c["ok"]]
    if not failed or any((c["error"], c["cause"]) != ("DeviceOomError", "OutOfMemoryError")
                         for c in failed):
        raise AssertionError(f"k1: failed calls {failed} (want torch.cuda.OutOfMemoryError "
                             "typed as DeviceOomError)")
    if not (h["oom_retries"] > 0 and h["oom_shrinks"] > 0 and h["oom_evictions"] > 0
            and h["oom_trimmed_bytes"] > 0) or (
            h["restarts"] or h["dead_letters"]):
        raise AssertionError(f"k1: health {h}")
    if any(c["rows"] > 64 for c in calls if c["ok"]):
        raise AssertionError(f"k1: a call of more than 64 rows got through the cap: {calls}")
    return run | {"peak_128": p128, "peak_64": p64, "cap_bytes": cap, "failed_calls": len(failed)}


def run_k2(torch, np, lab, counters, seed: int, images, labels) -> dict:
    """k2: injected faults, each over its own run: one ``device.oom`` (one
    shrink), one ``device.lost`` under ``error-policy=restart`` (the JAX
    package's unsharded outcome: the loss re-raises into supervision, one
    restart, the batch retried), and a ``hang`` at the filter's
    ``handle_frame`` under ``stall-timeout`` and ``stall-policy=restart``
    (the watchdog interrupts it, one restart, the batch retried); then the
    card's allocated bytes must be back within 1 MiB."""
    import gc

    from nnstreamer_tpu_torch.core.resilience import FAULTS, DeviceLostError, DeviceOomError

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    runs = {}
    faults = {
        "oom": ("", lambda: FAULTS.arm("device.oom", exc=DeviceOomError, times=1, after=2)),
        "lost": ("error-policy=restart restart-backoff=0.01",
                 lambda: FAULTS.arm("device.lost", exc=DeviceLostError, times=1, after=2)),
        "hang": ("stall-timeout=2 stall-policy=restart restart-backoff=0.01",
                 lambda: FAULTS.arm("element.f.handle_frame", hang=True, times=1, after=2)),
    }
    for kind, (extra, arm) in faults.items():
        text = labeling_text(MOBILENET_CUSTOM, seed, labels, extra)
        try:
            runs[kind] = supervised_run(torch, np, lab, counters, f"k2 {kind}", text, images,
                                        during=lambda pipe, i: arm() if i == 0 else None)
        finally:
            FAULTS.reset()
    h = {k: r["health"] for k, r in runs.items()}
    if (h["oom"]["oom_retries"], h["oom"]["oom_shrinks"], h["oom"]["restarts"]) != (1, 1, 0):
        raise AssertionError(f"k2 oom: health {h['oom']} (want one retry as two halves)")
    if (h["lost"]["device_lost"], h["lost"]["restarts"], h["lost"]["remeshes"],
            h["lost"]["dead_letters"]) != (1, 1, 0, 0):
        raise AssertionError(f"k2 lost: health {h['lost']} (want one loss, one restart)")
    if h["hang"]["restarts"] != 1 or h["hang"]["stalls"] < 1 or h["hang"]["dead_letters"]:
        raise AssertionError(f"k2 hang: health {h['hang']} (want one stall, one restart)")
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if abs(after - before) > 1 << 20:
        raise AssertionError(f"k2: card memory allocated {before} bytes before the faulted runs, "
                             f"{after} after (want within 1 MiB)")
    return {"runs": runs, "allocated_before": before, "allocated_after": after}


def run_k3(torch, np, lab, counters, seed: int, images, work, labels) -> dict:
    """k3: hot swap between ``model://mobilenet_v2/1`` and ``/2`` (seeds
    seed+1 and seed+2, in the work dir's model repository): a reload at
    frame 300 of a stream, every frame once and in order, each micro-batch's
    labels equal to the direct call of the version that served it; then a
    second run whose post-swap invokes fail (``filter.reload.post``) inside
    the observation window rolls back to /1, every label /1's."""
    from nnstreamer_tpu_torch.core.model_uri import resolve_model_uri
    from nnstreamer_tpu_torch.core.resilience import FAULTS
    from nnstreamer_tpu_torch.models import build

    repo = work / "models"
    os.environ["NNS_TPU_MODEL_REPO"] = str(repo)
    modules, paths = {}, {}
    for version in (1, 2):
        module, _, _ = build("mobilenet_v2", custom_props(MOBILENET_CUSTOM)
                             | {"seed": str(seed + version)})
        d = repo / "mobilenet_v2" / str(version)
        d.mkdir(parents=True, exist_ok=True)
        torch.save(module.state_dict(), d / "model.pt")
        paths[version] = resolve_model_uri(f"model://mobilenet_v2/{version}")
        modules[paths[version]] = module.to("cuda").eval()
    text = (f"appsrc name=src ! tensor_filter name=f framework=torch-cuda "
            f"model=model://mobilenet_v2/1 custom={MOBILENET_CUSTOM} max-batch=128 "
            f"batch-timeout=20 is-updatable=true staged-reload=true {{extra}} ! tensor_decoder "
            f"mode=image_labeling option1={labels} ! tensor_sink name=out")
    tickets = []

    def reload_at_300(pipe, i):
        # the stream goes on once the new model is staged: the swap lands at
        # the next micro-batch boundary
        if i == 300:
            ticket = pipe.reload_model("f", "model://mobilenet_v2/2")
            if not ticket.wait_staged(60) or not ticket.ok:
                raise AssertionError(f"k3 swap: staging failed: {ticket.error}")
            tickets.append(ticket)

    swap = supervised_run(torch, np, lab, counters, "k3 swap",
                          text.format(extra="observation-window=0.5"), images,
                          during=reload_at_300, modules=modules)
    served = [c["model"] for c in swap["calls"] if c["ok"] and not c["warm"]]
    switch = served.index(paths[2]) if paths[2] in served else -1
    if switch <= 0 or served[switch:] != [paths[2]] * (len(served) - switch) or (
            swap["health"]["swaps"], swap["health"]["swap_failures"]) != (1, 0):
        raise AssertionError(f"k3 swap: versions served {served}, health {swap['health']} "
                             "(want /1 then /2 from one boundary on, one swap)")
    swap_frame = sum(c["rows"] for c in swap["calls"] if c["ok"] and not c["warm"]
                     and c["model"] == paths[1])

    def armed_reload(pipe, i):
        if i == 128:  # at least three micro-batches of 128 follow
            ticket = pipe.reload_model("f", "model://mobilenet_v2/2")
            if not ticket.wait_staged(60) or not ticket.ok:
                raise AssertionError(f"k3 rollback: staging failed: {ticket.error}")
            FAULTS.arm("filter.reload.post", exc=RuntimeError("the new model fails"), times=2)
            tickets.append(ticket)

    try:
        rollback = supervised_run(
            torch, np, lab, counters, "k3 rollback",
            text.format(extra="observation-window=60 rollback-error-burst=2"),
            images[:ROLLBACK_FRAMES], during=armed_reload, modules=modules)
    finally:
        FAULTS.reset()
    hr = rollback["health"]
    if any(c["model"] != paths[1] for c in rollback["calls"] if c["ok"] and not c["warm"]) or (
            hr["swaps"], hr["rollbacks"], hr["model_version"], hr["restarts"]) != (1, 1, 0, 0) \
            or tickets[-1].state != "rolled-back":
        raise AssertionError(f"k3 rollback: health {hr}, ticket {tickets[-1].state} (want every "
                             "frame served by /1 and one rollback)")
    return {"swap": swap, "rollback": rollback, "swap_frame": swap_frame,
            "batches": swap["batches"] + rollback["batches"]}


def run_k4(torch, np, lab, counters, seed: int, images, labels) -> dict:
    """k4: card-memory watermarks while frames stream.  The monitor's
    ``high`` and ``low`` sit around a tensor of a quarter of the card that
    the script allocates at 30% of the stream and frees (``del``, then
    ``empty_cache``) at 60%: entering pressure runs the trim hooks (the
    backend's ``trim_caches`` must release allocator segments and card
    bytes; the host staging pools are left alone, since the monitor reads
    the card), and the monitor must clear below ``low``."""
    from nnstreamer_tpu_torch.core.liveness import device_memory_sample

    total = torch.cuda.get_device_properties(0).total_memory
    big = total // 4
    state, samples, hook_entries = {}, [], []
    base = torch.cuda.memory_reserved()
    high, low = (base + 0.6 * big) / total, (base + 0.3 * big) / total

    def sample():
        s = device_memory_sample()
        samples.append((round(time.perf_counter(), 3), s[0], s[1]))
        return s

    grab, free = len(images) * 3 // 10, len(images) * 6 // 10

    def during(pipe, i):
        if i == 0:
            mon = state["mon"] = pipe.enable_memory_monitor(
                high=high, low=low, sustain_s=60.0, min_poll_s=0.05, sample=sample)
            mon.trim_hooks = [wrapped(h) for h in mon.trim_hooks]
            state["be"] = pipe["f"].backend
            state["bytes0"] = state["be"].trimmed_bytes
        elif i == grab:
            state["x"] = torch.empty(big, dtype=torch.uint8, device="cuda")
            wait_for(lambda: state["mon"].pressured, "entered pressure")
        elif i == free:
            del state["x"]
            torch.cuda.empty_cache()
            wait_for(lambda: not state["mon"].pressured, "cleared")

    def wrapped(hook):
        def run():
            freed = int(hook() or 0)
            hook_entries.append((getattr(hook, "__name__", "hook"), freed))
            return freed
        return run

    def wait_for(pred, what):
        deadline = time.perf_counter() + 10
        while not pred():
            if time.perf_counter() > deadline:
                raise AssertionError(f"k4: the monitor never {what}: {state['mon'].snapshot()}")
            time.sleep(0.01)

    text = labeling_text(MOBILENET_CUSTOM, seed, labels)
    run = supervised_run(torch, np, lab, counters, "k4", text, images, during=during)
    snap = state["mon"].snapshot()
    freed = dict(hook_entries)
    card_bytes = state["be"].trimmed_bytes - state["bytes0"]
    if snap["mem_trims"] != 1 or freed.get("trim_caches", 0) <= 0 or card_bytes <= 0 or freed.get(
            "trim_staging_pools_on_host", 0):
        raise AssertionError(f"k4: monitor {snap}, entries freed by the hooks {hook_entries}, "
                             f"card bytes {card_bytes} (want one trim sweep, segments and bytes "
                             "from trim_caches, no host-pool trim)")
    return run | {"monitor": snap, "hook_entries": hook_entries, "trimmed_bytes": card_bytes,
                  "high": high, "low": low, "tensor_bytes": big, "samples": samples}


K5_PROMPTS, K5_TOKENS, K5_NEW = 8, 128, 32


def run_k5(torch, np, counters, seed: int) -> dict:
    """k5: the slot engine's OOM shed on GPT-2 small (path d's model): 8
    prompts of 128 tokens, ``generate`` 32 greedy tokens through
    ``slots=4 chunk=16``, once fault-free and once where the engine's
    third decode call runs on the card (advancing the KV cache's write
    positions in place) and then raises ``DeviceOomError``: the shed
    stream ends with the typed final chunk (``evicted: oom``, its tokens a
    prefix of its fault-free ones), every other stream's tokens equal the
    fault-free run's, which holds only if the positions went back."""
    from nnstreamer_tpu_torch.core.resilience import DeviceOomError
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    vocab = int(custom_props(LM_CUSTOM)["vocab"])
    rng = np.random.default_rng(seed + 16)
    prompts = [rng.integers(0, vocab, K5_TOKENS, dtype=np.int32) for _ in range(K5_PROMPTS)]
    runs = {}
    for kind in ("clean", "oom"):
        pipe = parse_pipeline(
            f"appsrc name=src ! tensor_generator name=g custom={LM_CUSTOM},seed:{seed} "
            f"max-new={K5_NEW} chunk=16 slots=4 prefill-chunk=128 ! tensor_sink name=out")
        counters.zero()
        pipe.start()
        decodes, fired = [0], []
        try:
            if kind == "oom":
                eng = pipe["g"]._engine
                inner = eng._decode_fn

                def counted(k, inner=inner):
                    decodes[0] += 1
                    step = inner(k)
                    if decodes[0] != 3:
                        return step

                    def runs_then_fails(cache, *args):
                        before = cache.pos.clone()
                        step(cache, *args)
                        fired.append(int((cache.pos - before).abs().sum()))
                        raise DeviceOomError("injected after decode call 3 ran")
                    return runs_then_fails

                eng._decode_fn = counted
            for i, p in enumerate(prompts):
                pipe["src"].push(p, pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
            snap = pipe["g"]._engine.snapshot()
        finally:
            pipe.stop()
        by = {}
        for f in pipe["out"].frames:
            by.setdefault(int(f.pts), []).append(f)
        runs[kind] = {"by": by, "snapshot": snap, "launches": counters.read()}
    clean = {i: stream_tokens(fs, K5_NEW) for i, fs in runs["clean"]["by"].items()}
    shed, equal = [], 0
    for i, fs in sorted(runs["oom"]["by"].items()):
        final = max(fs, key=lambda f: f.meta["chunk_index"])
        if final.meta.get("evicted") == "oom":
            toks = np.concatenate([f.tensors[0] for f in sorted(
                fs, key=lambda f: f.meta["chunk_index"]) if f.tensors], axis=1)[0]
            if ("deadline_expired" in final.meta or not final.meta["final"]
                    or not np.array_equal(toks, clean[i][:len(toks)]) or len(toks) >= K5_NEW):
                raise AssertionError(f"k5: shed stream {i}: tokens {toks} against {clean[i]}, "
                                     f"final meta {final.meta}")
            shed.append((i, len(toks)))
        elif np.array_equal(stream_tokens(fs, K5_NEW), clean[i]):
            equal += 1
        else:
            raise AssertionError(f"k5: stream {i} differs from the fault-free run")
    snap = runs["oom"]["snapshot"]
    if len(shed) != 1 or equal != K5_PROMPTS - 1 or (
            snap["gen_oom_retries"], snap["gen_oom_sheds"]) != (1, 1) or fired[:1] == [0] or (
            len(fired) != 1):
        raise AssertionError(f"k5: shed {shed}, {equal} streams equal, snapshot {snap}, "
                             f"positions the failed call advanced {fired}")
    launches = {k: runs["clean"]["launches"][k] + runs["oom"]["launches"][k]
                for k in runs["clean"]["launches"]}
    return {"shed": shed, "equal": equal, "snapshot": snap, "launches": launches,
            "positions_advanced": fired[0],
            "batches": runs["clean"]["snapshot"]["gen_decode_steps"] + snap["gen_decode_steps"]}


def run_supervision(torch, np, lab, counters, seed: int, card: str, work, labels) -> tuple:
    """Path k: k1-k5 (see their docstrings) at path a's configuration
    (MobileNet-v2 224, 1001 classes, bf16, ``max-batch=128``, the decoder's
    device half fused) and GPT-2 small for k5.  Returns (paths: each
    sub-path's launches and successful micro-batches, the summary line)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 15)
    size = int(custom_props(MOBILENET_CUSTOM).get("size", "224"))
    images = rng.integers(0, 256, (SUPERVISION_FRAMES, size, size, 3), dtype=np.uint8)
    secs, paths = {}, {}

    def timed(key, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        secs[key] = time.perf_counter() - t
        return out

    k1 = timed("k1", run_k1, torch, np, lab, counters, seed, images, labels)
    k2 = timed("k2", run_k2, torch, np, lab, counters, seed, images, labels)
    k3 = timed("k3", run_k3, torch, np, lab, counters, seed, images, work, labels)
    k4 = timed("k4", run_k4, torch, np, lab, counters, seed, images, labels)
    torch.cuda.empty_cache()
    k5 = timed("k5", run_k5, torch, np, counters, seed)
    for key, run in (("k1", k1), ("k2_oom", k2["runs"]["oom"]), ("k2_lost", k2["runs"]["lost"]),
                     ("k2_hang", k2["runs"]["hang"]), ("k3_swap", k3["swap"]),
                     ("k3_rollback", k3["rollback"]), ("k4", k4), ("k5", k5)):
        paths[f"supervision_{key}"] = {"launches": run["launches"], "batches": run["batches"]}
    keep = ("oom_retries", "oom_shrinks", "oom_evictions", "oom_trimmed_bytes", "device_lost",
            "restarts",
            "dead_letters", "swaps", "rollbacks", "model_version", "stalls")
    health = {"k1": k1["health"], **{f"k2_{k}": r["health"] for k, r in k2["runs"].items()},
              "k3_swap": k3["swap"]["health"], "k3_rollback": k3["rollback"]["health"]}
    summary = {
        "frames": SUPERVISION_FRAMES, "card": card,
        "seconds": {k: round(v, 3) for k, v in secs.items()} | {
            "total": round(time.perf_counter() - t0, 3)},
        "health": {k: {f: h.get(f) for f in keep if f in h} for k, h in health.items()},
        "k1": {"peak_128_bytes": k1["peak_128"], "peak_64_bytes": k1["peak_64"],
               "cap_bytes": k1["cap_bytes"], "failed_calls": k1["failed_calls"],
               "calls": len(k1["calls"]), "launches": {
                   k: k1["launches"][k] for k in ("normalize_u8", "top1")}},
        "k2": {"allocated_before": k2["allocated_before"],
               "allocated_after": k2["allocated_after"]},
        "k3": {"swap_frame": k3["swap_frame"]},
        "k4": {"monitor": k4["monitor"], "hook_entries": k4["hook_entries"],
               "trimmed_bytes": k4["trimmed_bytes"],
               "tensor_bytes": k4["tensor_bytes"], "high": k4["high"], "low": k4["low"],
               "samples": len(k4["samples"])},
        "k5": {"shed": k5["shed"], "equal_streams": k5["equal"],
               "positions_advanced_by_the_failed_call": k5["positions_advanced"],
               "oom_retries": k5["snapshot"]["gen_oom_retries"],
               "oom_sheds": k5["snapshot"]["gen_oom_sheds"]},
    }
    marks = [s for s in k4["samples"] if s[1] / max(1, s[2]) >= k4["high"]][:1] + \
        [s for s in k4["samples"] if s[1] / max(1, s[2]) <= k4["low"]][-1:]
    print(f"path k: k1 a real OOM on every 128-frame micro-batch under a cap of "
          f"{k1['cap_bytes'] / 2**30:.2f} GiB (one call peaks at {k1['peak_128'] / 2**30:.2f} GiB "
          f"for 128 frames, {k1['peak_64'] / 2**30:.2f} for 64): {k1['failed_calls']} "
          f"torch.cuda.OutOfMemoryError typed as DeviceOomError, each retried as two halves; "
          f"labels equal to the direct call at each serving call's size with the cap lifted; "
          f"launches {summary['k1']['launches']}")
    print(f"path k: k2 device.oom, device.lost (error-policy=restart) and a hang "
          f"(stall-policy=restart) each over {SUPERVISION_FRAMES} frames: every frame once, in "
          f"order, labels equal; allocated {k2['allocated_before']} bytes before, "
          f"{k2['allocated_after']} after")
    print(f"path k: k3 swap /1 -> /2 at frame {k3['swap_frame']}, rollback after 2 errors in the "
          f"observation window, labels equal to the serving version's direct call")
    print(f"path k: k4 monitor {k4['monitor']}; entries per hook {k4['hook_entries']}, card "
          f"bytes from trim_caches {k4['trimmed_bytes']}; samples "
          f"(clock, reserved, limit) {len(k4['samples'])}, first at pressure and last below low "
          f"{marks}")
    print(f"path k: k5 GPT-2 small decode call 3 ran (write positions advanced by "
          f"{k5['positions_advanced']}) and then failed; shed stream (index, tokens) {k5['shed']}, "
          f"{k5['equal']} streams equal to the fault-free run; seconds {summary['seconds']}; "
          f"on {card}")
    return paths, summary


OBS_FRAMES = 1024
OBS_SHORT_FRAMES = 256
L5_PROMPTS, L5_TOKENS, L5_NEW = 8, 128, 32
#: l5's objectives: loose enough that a healthy run meets them
L5_SLO = "slo-ttft-p95=10 slo-token-p99=1 slo-availability=0.99"


def scrape(port: int) -> dict:
    """``/metrics`` of the endpoint on 127.0.0.1:`port` as {name{labels}:
    value}; a malformed line fails."""
    import re
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    out, line_re = {}, re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        if m is None:
            raise AssertionError(f"path l: unparseable exposition line {line!r}")
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def series(metrics: dict, name: str, **labels) -> float:
    """The sum of a scrape's `name` samples whose labels include `labels`;
    fails when there is none."""
    total, found = 0.0, False
    for key, v in metrics.items():
        base, _, rest = key.partition("{")
        if base == name and all(f'{k}="{val}"' in rest for k, val in labels.items()):
            total, found = total + v, True
    if not found:
        raise AssertionError(f"path l: the scrape has no {name} series with labels {labels}")
    return total


def d2h_copies(prof, path) -> list:
    """The bytes of every device-to-host copy a ``torch.profiler`` session
    saw, sorted, from its Chrome trace written to `path`."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return sorted(int(e.get("args", {}).get("bytes", -1)) for e in events
                  if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""))


def run_l1(torch, np, lab, counters, seed: int, images, labels, work) -> dict:
    """l1: path a's pipeline with ``latency=1 throughput=1``, untraced, then
    traced, with a flight recorder and ``/metrics`` scraped over 127.0.0.1
    mid-run and after EOS.  Both under ``torch.profiler`` (device
    activity), both timed again without it."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    n = len(images)
    text = labeling_text(MOBILENET_CUSTOM, seed, labels, "latency=1 throughput=1")

    def one(traced: bool, profiled: bool) -> dict:
        pipe = parse_pipeline(text, name="l1")
        tracer, port, mid = None, None, None
        if traced:
            tracer = pipe.enable_tracing()
            pipe.enable_flight_recorder(dump_dir=str(work / "l1_flight"))
            port = pipe.serve_metrics(0)
        prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else None
        counters.zero()
        pipe.start()
        try:
            with recording_io(pipe, "f") as (sizes, outs, _):
                if prof is not None:
                    prof.start()
                    time.sleep(0.5)  # margins: see cuda_kernels
                t0 = time.perf_counter()
                for i in range(n):
                    pipe["src"].push(images[i], pts=float(i))
                    if port is not None and i == n // 2:
                        mid = scrape(port)
                pipe["src"].end_of_stream()
                pipe.wait(timeout=600)
                wall = time.perf_counter() - t0
                if prof is not None:
                    time.sleep(0.5)
                    prof.stop()
            launches = counters.read()
            end = scrape(port) if port is not None else None
            f = pipe["f"]
            run = {"fps": n / wall, "sizes": list(sizes), "launches": launches, "mid": mid,
                   "end": end, "latency_us": f.latency_us, "throughput_fps": f.throughput_fps,
                   "module": f.backend._module,
                   "labels": np.array([fr.meta["label_index"] for fr in pipe["out"].frames]),
                   "out_bytes": sorted(
                       int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
                       for call in outs for shape, dt, _ in call)}
            if tracer is not None:
                rep = tracer.report()["f"]
                run |= {"proctime_us_p50": rep["proctime_us_p50"],
                        "proctime_us_p99": rep["proctime_us_p99"],
                        "filter_bytes": tracer._stats["f"].bytes}
        finally:
            pipe.stop()
        if prof is not None:
            run["d2h"] = d2h_copies(prof, work / "l1_profile.json")
        return run

    # untraced first: a process's first model call carries the card's lazy
    # set-up, which must not land in the traced run's proctime
    plain = one(False, True)
    traced = one(True, True)
    timed = {"untraced_fps": one(False, False)["fps"], "traced_fps": one(True, False)["fps"]}
    sizes, launches, end = traced["sizes"], traced["launches"], traced["end"]
    batches = len(sizes)
    for el in ("f", "out"):
        if series(end, "nns_element_frames", element=el, pipeline="l1") != n:
            raise AssertionError(f"l1: nns.element.frames of {el} is not {n}")
    invokes = series(end, "nns_filter_invokes", element="f", pipeline="l1")
    if not invokes == batches == launches["normalize_u8"] == launches["top1"]:
        raise AssertionError(f"l1: nns.filter.invokes {invokes}, {batches} micro-batches, "
                             f"launches {launches} (want all equal)")
    for key in ("nns_element_frames", "nns_filter_invokes", "nns_feed_lane_staged",
                "nns_pool_device_reused"):
        series(traced["mid"], key, pipeline="l1")
    want = np.concatenate([lab.top1_plain(logits)[0].cpu().numpy() for _, _, logits, _ in
                           direct_batches(torch, traced["module"], images, sizes)])
    for run in (traced, plain):
        if not np.array_equal(run["labels"], want):
            raise AssertionError(f"l1: {int((run['labels'] != want).sum())} labels differ from "
                                 "the direct call")
    frame_bytes = n * int(np.prod(images.shape[1:]))
    if traced["filter_bytes"] != frame_bytes:
        raise AssertionError(f"l1: the tracer counted {traced['filter_bytes']} bytes through the "
                             f"filter for {frame_bytes}")
    # the decoder brings each micro-batch's labels to the host, and nothing
    # else may cross, traced or not (each run in its own micro-batch sizes;
    # a copy of no bytes moves nothing)
    moved = {k: [b for b in r["d2h"] if b] for k, r in (("traced", traced), ("plain", plain))}
    if moved["traced"] != traced["out_bytes"] or moved["plain"] != plain["out_bytes"]:
        raise AssertionError(f"l1: device-to-host copies' bytes traced {traced['d2h']}, "
                             f"untraced {plain['d2h']}, the labels' {traced['out_bytes']}")
    x = torch.from_numpy(images[:128]).to("cuda")
    module = traced["module"]
    with torch.inference_mode():
        direct_ms = time_ms(lambda: module(x), reps=5, inner=4) / 128
    return {"launches": launches, "batches": batches, "frames": n,
            "fps_traced_profiled": traced["fps"], "fps_untraced_profiled": plain["fps"],
            "fps_traced": timed["traced_fps"], "fps_untraced": timed["untraced_fps"],
            "proctime_us_p50": traced["proctime_us_p50"],
            "proctime_us_p99": traced["proctime_us_p99"],
            "latency_us": traced["latency_us"], "throughput_fps": traced["throughput_fps"],
            "direct_device_ms_per_frame": direct_ms, "d2h_copies": len(moved["traced"]),
            "d2h_bytes": sum(moved["traced"]),
            "d2h_empty_copies": [traced["d2h"].count(0), plain["d2h"].count(0)],
            "filter_bytes": traced["filter_bytes"],
            "scrape_series": len(end)}


def run_l2(torch, np, counters, seed: int, images, labels, work) -> dict:
    """l2: ``trace=1``: the filter holds the process's ``torch.profiler``
    session; after ``stop()`` its Chrome trace must name the
    ``normalize_u8`` and ``top1`` kernels of the counted frames as often as
    their launch counters count them, and no session may remain.  A
    warm-up micro-batch goes first, and a marker (``annotate``) between it
    and the counted frames separates them in the trace: in full runs the
    first micro-batch's ``normalize_u8`` record went missing from its
    session (PERF.md, PR 17)."""
    import shutil
    import threading

    from nnstreamer_tpu_torch.core import profiler
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    trace_dir = work / "l2_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    if profiler.trace_active() or torch._C._autograd._profiler_enabled():
        raise AssertionError("l2: a profiler session is already active")
    pipe = parse_pipeline(labeling_text(MOBILENET_CUSTOM, seed, labels,
                                        f"trace=1 trace-dir={trace_dir}"))
    warm, arrived = 128, [0]
    warmed = threading.Event()

    def on_frame(_):
        arrived[0] += 1
        if arrived[0] == warm:
            warmed.set()

    pipe["out"].connect_new_data(on_frame)
    pipe.start()
    try:
        if not (pipe.health()["f"]["profiler_active"] and profiler.trace_active()):
            raise AssertionError("l2: trace=1 did not start a torch.profiler session")
        with recording_batches(pipe, "f") as sizes:
            for i in range(warm):
                pipe["src"].push(images[i], pts=float(i))
            if not warmed.wait(300):
                raise AssertionError("l2: the warm-up frames did not arrive")
            # margins around the marker (see cuda_kernels)
            time.sleep(0.5)
            counters.zero()
            warm_batches = len(sizes)
            with profiler.annotate("chip_smoke l2 counted frames"):
                pass
            time.sleep(0.5)
            for i in range(len(images)):
                pipe["src"].push(images[i], pts=float(warm + i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
        launches = counters.read()
        time.sleep(0.5)
    finally:
        pipe.stop()
    batches = len(sizes) - warm_batches
    files = sorted(trace_dir.glob("nns_trace_*.json"))
    if profiler.trace_active() or len(files) != 1:
        raise AssertionError(f"l2: after stop() trace_active {profiler.trace_active()}, "
                             f"trace files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    marks = [e["ts"] for e in events if e.get("name") == "chip_smoke l2 counted frames"]
    if len(marks) != 1:
        raise AssertionError(f"l2: the trace holds {len(marks)} markers")
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel" and e.get("ts", 0) > marks[0]]
    named = {k: sum(f"{k}_kernel" in name for name in kernels) for k in ("normalize_u8", "top1")}
    if any(named[k] != launches[k] or not launches[k] for k in named) or launches["top1"] != batches:
        # the trace goes to chiprun_out/ of the working directory for a look
        keep = Path.cwd() / "chiprun_out" / "l2_trace.json"
        keep.parent.mkdir(exist_ok=True)
        shutil.copy(files[0], keep)
        ours = sorted((e.get("ts"), e.get("cat"), e.get("name", "")[:40]) for e in events
                      if "normalize_u8" in e.get("name", "") or "top1" in e.get("name", ""))
        raise AssertionError(f"l2: after the marker ({marks[0]}) the trace names {named} for "
                             f"launches {launches} in {batches} micro-batches; our kernels "
                             f"{ours}; copied to {keep}")
    return {"launches": launches, "batches": batches, "trace_kernels": len(kernels),
            "named": named, "trace_bytes": files[0].stat().st_size,
            "warmup_batches": warm_batches}


def run_l3(torch, np, lab, counters, seed: int, images, labels, work) -> dict:
    """l3: k2's hang (``stall-policy=restart``) with a flight recorder: one
    dump holding the stalled filter's open span with its trace id and a
    thread profile of the named threads; every frame once, labels equal."""
    import shutil

    from nnstreamer_tpu_torch.core.resilience import FAULTS

    dump_dir = work / "l3_flight"
    shutil.rmtree(dump_dir, ignore_errors=True)
    bus = []

    def setup(pipe):
        pipe.enable_flight_recorder(dump_dir=str(dump_dir))
        pipe.add_bus_watcher(bus.append)

    text = labeling_text(MOBILENET_CUSTOM, seed, labels,
                         "stall-timeout=2 stall-policy=restart restart-backoff=0.01")
    try:
        run = supervised_run(
            torch, np, lab, counters, "l3", text, images, setup=setup,
            during=lambda pipe, i: FAULTS.arm("element.f.handle_frame", hang=True, times=1,
                                              after=2) if i == 0 else None)
    finally:
        FAULTS.reset()
    files = sorted(dump_dir.glob("nns_flight_*.json"))
    posted = [m.data["flight_dump"] for m in bus
              if isinstance(m.data, dict) and "flight_dump" in m.data]
    if len(files) != 1 or posted != [str(files[0])]:
        raise AssertionError(f"l3: dumps {files}, posted on the bus {posted} (want one)")
    dump = json.loads(files[0].read_text())
    stuck = [(t["trace_id"], s) for t in dump["traces"] for s in t["spans"] if s.get("open")]
    profiled = (dump["thread_profile"] or {}).get("threads", {})
    threads = sorted(profiled)
    if (dump["source"], dump["reason"]) != ("f", "watchdog_stall") or [
            s["element"] for _, s in stuck] != ["f"] or not stuck[0][0]:
        raise AssertionError(f"l3: dump {dump['source']} {dump['reason']}, open spans {stuck}")
    parked = [st["stack"] for st in profiled.get("f", {}).get("top_stacks", [])]
    if not any("pipeline.py:_supervised" in st for st in parked):
        raise AssertionError(f"l3: the dump's thread profile holds {threads}; the filter's "
                             f"thread f is not parked in its hung call: {parked}")
    h = run["health"]
    if h["restarts"] != 1 or h["stalls"] < 1 or h["dead_letters"]:
        raise AssertionError(f"l3: health {h} (want one stall, one restart)")
    return {"launches": run["launches"], "batches": run["batches"], "dump": files[0].name,
            "stuck_for_ms": stuck[0][1]["stuck_for_ms"], "trace_id": stuck[0][0],
            "threads": threads, "dump_bytes": files[0].stat().st_size}


def run_l4(torch, np, counters, seed: int, images) -> dict:
    """l4: ``output-combination=i0,o0`` with manual ``input``/``input-type``
    matching the model: each output frame is the pushed frame (byte-equal)
    and the logits of the direct call; a mismatching input or output
    declaration raises the JAX package's error text."""
    from nnstreamer_tpu_torch.core.types import StreamSpec
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    size = images.shape[1]
    caps = StreamSpec.from_string(
        f"tensors,format=static,num=1,dimensions=3:{size}:{size},types=uint8")
    base = (f"appsrc name=src ! tensor_filter name=f framework=torch-cuda model=zoo "
            f"custom={MOBILENET_CUSTOM},seed:{seed} max-batch=128 batch-timeout=20 ")
    pipe = parse_pipeline(base + f"output-combination=i0,o0 input=3:{size}:{size} "
                          "input-type=uint8 ! tensor_sink name=out")
    pipe["src"].set_spec(caps)
    counters.zero()
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            for i in range(len(images)):
                pipe["src"].push(images[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
        launches = counters.read()
        module = pipe["f"].backend._module
    finally:
        pipe.stop()
    out = pipe["out"].frames
    if [f.pts for f in out] != [float(i) for i in range(len(images))] or launches["top1"] or (
            launches["normalize_u8"] != len(sizes)):
        raise AssertionError(f"l4: {len(out)} frames back, launches {launches} for "
                             f"{len(sizes)} micro-batches")
    for i, f in enumerate(out):
        if not (isinstance(f.tensors[0], np.ndarray) and np.array_equal(f.tensors[0], images[i])):
            raise AssertionError(f"l4: i0 of frame {i} is not the pushed frame")
    want = np.concatenate([logits.float().cpu().numpy() for _, _, logits, _ in
                           direct_batches(torch, module, images, sizes)])
    got = np.stack([np.asarray(f.tensors[1], np.float32) for f in out])
    err = float(np.abs(got - want).max())
    if err != 0.0:
        raise AssertionError(f"l4: o0 differs from the direct call's logits by up to {err}")
    refusals = {}
    for props, expect in (
            (f"input=3:{size + 1}:{size + 1} input-type=uint8",
             "f: stream schema " + caps.to_string() + " does not match model input "
             f"tensors,format=static,num=1,dimensions=3:{size + 1}:{size + 1},types=uint8"),
            ("output=1000 output-type=float32",
             "f: output=1000/float32 does not match the model's output ")):
        bad = parse_pipeline(base + props + " ! tensor_sink name=out")
        bad["src"].set_spec(caps)
        try:
            bad.start()
        except Exception as e:  # noqa: BLE001 — the refusal is the check
            refusals[props] = f"{type(e).__name__}: {e}"
        else:
            bad.stop()
            raise AssertionError(f"l4: {props} was accepted")
        if not refusals[props].startswith(f"ElementError: {expect}"):
            raise AssertionError(f"l4: {props} raised {refusals[props]!r}")
    return {"launches": launches, "batches": len(sizes), "refusals": refusals,
            "max_abs_err": err}


def run_l5(torch, np, counters, seed: int) -> dict:
    """l5: path d's GPT-2 small through ``tensor_generator slots=4
    chunk=16`` (8 prompts of 128 tokens, 32 greedy tokens), once plain and
    once with the three ``slo-*`` objectives armed: equal tokens, 8 streams
    counted good, the ``nns.slo.*`` series in a scrape."""
    vocab = int(custom_props(LM_CUSTOM)["vocab"])
    rng = np.random.default_rng(seed + 17)
    prompts = [rng.integers(0, vocab, L5_TOKENS, dtype=np.int32) for _ in range(L5_PROMPTS)]
    custom = f"{LM_CUSTOM},seed:{seed}"
    counters.zero()
    plain = run_generator(np, custom, prompts, L5_NEW, 16, 4)[0]

    def keep(pipe):
        port = pipe.serve_metrics(0)
        return scrape(port), pipe.health()["g"]

    toks, _, _, wall, (metrics, health) = run_generator(np, custom, prompts, L5_NEW, 16, 4,
                                                        keep=keep, extra=L5_SLO)
    launches = counters.read()
    if any(not np.array_equal(a, b) for a, b in zip(toks, plain)):
        raise AssertionError("l5: tokens with the SLO objectives armed differ from the plain run")
    row = health["slo"]["_" if "_" in health["slo"] else ""]
    good = series(metrics, "nns_slo_good", element="g")
    ttft = series(metrics, "nns_slo_ttft_seconds_count", element="g")
    tokens = series(metrics, "nns_slo_token_seconds_count", element="g")
    for key in ("nns_slo_status", "nns_slo_availability", "nns_slo_ttft_burn",
                "nns_slo_token_burn", "nns_slo_availability_burn", "nns_slo_ttft_p95_ms"):
        series(metrics, key, element="g")
    if (good, ttft, row["good"]) != (L5_PROMPTS,) * 3 or tokens != L5_PROMPTS * (L5_NEW - 1):
        raise AssertionError(f"l5: nns.slo.good {good}, ttft observations {ttft}, token "
                             f"observations {tokens}, SLO row {row}")
    if any(launches.values()):
        raise AssertionError(f"l5: the KV-cache decode launched {launches}")
    return {"launches": launches, "batches": health["gen_decode_steps"], "slo": row,
            "seconds": wall}


def run_observability(torch, np, lab, counters, seed: int, card: str, work, labels) -> tuple:
    """Path l: l1-l5 (see their docstrings).  Returns (paths: each
    sub-path's launches and micro-batches, the summary line)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 18)
    size = int(custom_props(MOBILENET_CUSTOM).get("size", "224"))
    images = rng.integers(0, 256, (OBS_FRAMES, size, size, 3), dtype=np.uint8)
    short = images[:OBS_SHORT_FRAMES]
    secs = {}

    def timed(key, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        secs[key] = time.perf_counter() - t
        return out

    l1 = timed("l1", run_l1, torch, np, lab, counters, seed, images, labels, work)
    l2 = timed("l2", run_l2, torch, np, counters, seed, short, labels, work)
    l3 = timed("l3", run_l3, torch, np, lab, counters, seed, images, labels, work)
    l4 = timed("l4", run_l4, torch, np, counters, seed, short)
    torch.cuda.empty_cache()
    l5 = timed("l5", run_l5, torch, np, counters, seed)
    runs = {"l1": l1, "l2": l2, "l3": l3, "l4": l4, "l5": l5}
    paths = {f"observability_{k}": {"launches": r["launches"], "batches": r["batches"]}
             for k, r in runs.items()}
    summary = {"card": card,
               "seconds": {k: round(v, 3) for k, v in secs.items()} | {
                   "total": round(time.perf_counter() - t0, 3)}}
    for k, r in runs.items():
        summary[k] = {key: v for key, v in r.items() if key not in ("launches",)}
    print(f"path l: l1 {OBS_FRAMES} frames traced with a flight recorder and /metrics scraped "
          f"mid-run and after EOS ({l1['scrape_series']} series): {l1['fps_traced']:.1f} "
          f"frames/s traced, {l1['fps_untraced']:.1f} untraced (host clock, one run each; "
          f"under torch.profiler {l1['fps_traced_profiled']:.1f} and "
          f"{l1['fps_untraced_profiled']:.1f}); the filter's proctime p50 "
          f"{l1['proctime_us_p50']:.0f} us p99 {l1['proctime_us_p99']:.0f} us and latency_us "
          f"{l1['latency_us']:.1f} per frame (host wall around the backend call: launch time) "
          f"beside the direct call's {l1['direct_device_ms_per_frame'] * 1e3:.1f} us of device "
          f"time per frame at 128; device-to-host copies {l1['d2h_copies']} of "
          f"{l1['d2h_bytes']} bytes, traced as untraced, the labels' only (copies of no bytes, "
          f"traced and untraced: {l1['d2h_empty_copies']}); on {card}")
    print(f"path l: l2 trace=1 over {OBS_SHORT_FRAMES} frames: the Chrome trace names "
          f"{l2['named']} of {l2['trace_kernels']} kernels, equal to the launch counters; "
          f"l3 one dump {l3['dump']} with the stalled filter's open span (trace id "
          f"{l3['trace_id']}, stuck {l3['stuck_for_ms']:.0f} ms) and threads {l3['threads']}; "
          f"l4 output-combination=i0,o0: i0 the pushed frames, o0 the direct call's logits "
          f"(max abs err {l4['max_abs_err']}), refusals {sorted(l4['refusals'])}; l5 SLO row "
          f"{l5['slo']}; seconds {summary['seconds']}; on {card}")
    return paths, summary


QUERY_FRAMES = 1024
QUERY_V1_FRAMES = 256
QUERY_PROMPTS, QUERY_TOKENS, QUERY_NEW, QUERY_CHUNK = 8, 128, 32, 16
#: the in-process reference prefills the same pieces (bf16 sums differ by
#: piece size, and so would greedy tokens)
QUERY_PREFILL_CHUNK = 128
#: m2's long streams: the dead client and the short budget land mid-decode,
#: at the path's chunk: the engine cuts a decode call short so it ends
#: before the nearest deadline less ``EVICT_MARGIN_S`` (a 16-token call of
#: GPT-2 small at 16 slots outlasts that 50 ms margin)
QUERY_LONG_NEW = 768
QUERY_BUDGET_S = 1.0
#: m3a's corrupt fault: every k-th request gather-send gets one flipped bit
QUERY_FAULT_EVERY = 5
#: m3c: seconds the card tensor over the watermark is held
QUERY_HOLD_S = 0.5


def query_server_text(sid: int, seed: int, labels, extra: str = "") -> str:
    """Path a's labeling pipeline behind a raw-TCP query server."""
    return (f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type=tcp "
            f"block-ingress=true {extra} ! tensor_filter name=f framework=torch-cuda model=zoo "
            f"custom={MOBILENET_CUSTOM},seed:{seed} max-batch=128 batch-timeout=20 ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            f"tensor_query_serversink id={sid}")


def query_client_text(ports, extra: str = "") -> str:
    hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
    return (f"appsrc name=src ! tensor_query_client name=q hosts={hosts} connect-type=tcp "
            f"wire-batch=32 max-in-flight=8 timeout=60 {extra} ! tensor_sink name=out")


def drive_client(text: str, name: str, frames, during=None, keep=None) -> dict:
    """`frames` pushed (pts = index) through a query client pipeline;
    ``during(pipe, i)`` before frame i, ``keep(pipe)`` after EOS and before
    ``stop()``.  Fails unless every frame came back once, in order."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(text, name=name)
    arrived = {}
    pipe["out"].connect_new_data(
        lambda f: arrived.setdefault(int(f.pts), []).append(time.perf_counter()))
    pipe.start()
    try:
        pushed = []
        t0 = time.perf_counter()
        for i in range(len(frames)):
            if during is not None:
                during(pipe, i)
            pushed.append(time.perf_counter())
            pipe["src"].push(frames[i], pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=600)
        wall = time.perf_counter() - t0
        out = list(pipe["out"].frames)
        health = pipe.health()["q"]
        kept = keep(pipe) if keep is not None else None
    finally:
        pipe.stop()
    n = len(frames)
    if [f.pts for f in out] != [float(i) for i in range(n)] or any(
            len(v) != 1 for v in arrived.values()):
        raise AssertionError(f"{name}: {len(out)} answers for {n} frames, or some lost, twice or "
                             "out of order")
    return {"out": out, "pushed": pushed, "arrived": {k: v[0] for k, v in arrived.items()},
            "wall": wall, "health": health, "kept": kept}


@contextmanager
def timing(owner, attr: str):
    """Host ms of every call of ``owner.attr`` while the block runs."""
    inner, ms = getattr(owner, attr), []

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            ms.append((time.perf_counter() - t) * 1e3)

    with mock.patch.object(owner, attr, timed):
        yield ms


def check_spans(name: str, out) -> float:
    """Every answer's span: segments >= 0 that add up to its total exactly,
    the server's device compute decomposed; returns the largest total."""
    from nnstreamer_tpu_torch.core.telemetry import SPAN_META

    keys = ("client_queue", "wire", "server_queue", "device_dispatch", "device_compute")
    for f in out:
        s = f.meta[SPAN_META]
        total = s["client_queue"] + s["wire"] + s["server_queue"] + s["device_dispatch"] \
            + s["device_compute"]
        if total != s["total"] or min(s[k] for k in keys) < 0 or s["device_compute"] <= 0:
            raise AssertionError(f"{name}: span {s} does not add up to its total")
    return max(f.meta[SPAN_META]["total"] for f in out)


def run_m1(torch, np, lab, counters, seed: int, images, labels, work, beside) -> dict:
    """m1: MobileNet-v2 labeling served over raw TCP (see the docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.core.telemetry import SPAN_META
    from nnstreamer_tpu_torch.distributed.service import QueryServerCore
    from nnstreamer_tpu_torch.elements import filter as filter_mod
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    n = len(images)
    srv = parse_pipeline(query_server_text(181, seed, labels), name="m1srv")
    srv.start()
    try:
        port = srv["ssrc"].props["port"]
        mport = srv.serve_metrics(0)
        prof = profile(activities=[ProfilerActivity.CUDA])
        # the server's stacking: each request's rows into one block at
        # ingest (np.stack), then blocks into a micro-batch in the filter
        with recording_io(srv, "f") as (sizes, outs, _), \
                timing(QueryServerCore, "_ingress_items") as ingest_ms, \
                timing(filter_mod, "_batched_tensors") as concat_ms:
            counters.zero()
            prof.start()
            time.sleep(0.5)  # margins: see cuda_kernels
            run = drive_client(query_client_text([port]), "m1cli", images,
                               keep=lambda pipe: scrape(pipe.serve_metrics(0)))
            time.sleep(0.5)
            prof.stop()
            launches = counters.read()
        server_metrics = scrape(mport)
        feed = feed_stats(srv["f"])
        module = srv["f"].backend._module
        with recording_io(srv, "f") as (v1_sizes, _, _):
            v1 = drive_client(query_client_text([port], "wire-version=1"), "m1cli_v1",
                              images[:QUERY_V1_FRAMES])
        v1_delivered = v1["health"]["delivered"]
        srv_health = srv.health()["ssrc"]
    finally:
        srv.stop()
    batches = len(sizes)
    if not launches["normalize_u8"] == launches["top1"] == batches or launches["flash_attention"]:
        raise AssertionError(f"m1: launches {launches} for {batches} server micro-batches (want "
                             "normalize_u8 and top1 once each)")
    for name, got_run, got_sizes, frames in (("m1", run, sizes, images),
                                             ("m1 wire-version=1", v1, v1_sizes,
                                              images[:QUERY_V1_FRAMES])):
        got = np.array([f.meta["label_index"] for f in got_run["out"]])
        want = np.concatenate([lab.top1_plain(logits)[0].cpu().numpy() for _, _, logits, _ in
                               direct_batches(torch, module, frames, got_sizes)])
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: {int((got != want).sum())} labels differ from the "
                                 f"direct call in the server's micro-batch sizes")
    moved = [b for b in d2h_copies(prof, work / "m1_profile.json") if b]
    out_bytes = sorted(int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
                       for call in outs for shape, dt, _ in call)
    if moved != out_bytes:
        raise AssertionError(f"m1: device-to-host copies of {moved} bytes; the labels' are "
                             f"{out_bytes} (one copy a micro-batch, as path a)")
    longest = check_spans("m1", run["out"])
    requests = series(run["kept"], "nns_query_rtt_seconds_count", element="q")
    admitted = series(server_metrics, "nns_query_admitted", element="ssrc")
    delivered = series(run["kept"], "nns_query_delivered", element="q")
    tenant = series(server_metrics, "nns_query_tenant_admitted", element="ssrc", tenant="_")
    if (delivered, requests) != (n, admitted) or tenant != admitted or series(
            server_metrics, "nns_query_corrupt_requests", element="ssrc"):
        raise AssertionError(f"m1: /metrics delivered {delivered}, client requests {requests}, "
                             f"server admitted {admitted} (tenant row {tenant})")
    if v1_delivered != QUERY_V1_FRAMES:
        raise AssertionError(f"m1: the wire-version=1 client delivered {v1_delivered}")
    fps, p50, p99 = stream_numbers(run["pushed"], run["arrived"], sizes[0] - 1)
    return {"launches": launches, "batches": batches, "sizes": dict(Counter(sizes)),
            "fps": n / run["wall"], "fps_steady": fps, "latency_ms_p50": p50,
            "latency_ms_p99": p99, "requests": int(requests), "d2h_copies": len(moved),
            "d2h_bytes": sum(moved), "ingest_stack_ms_per_request": statistics.median(ingest_ms),
            "filter_concat_ms_per_batch": statistics.median(concat_ms),
            "lane_staged": feed["staged"], "longest_span_s": longest,
            "span": dict(run["out"][-1].meta[SPAN_META]),
            "server_admitted": srv_health["admitted"], "v1_sizes": dict(Counter(v1_sizes)),
            "beside_a": None if beside is None else {
                k: beside[k] for k in ("fps_steady", "latency_ms_p50", "latency_ms_p99")} | {
                "stack_ms_per_batch": beside["feed"]["stack_ms_per_batch"]}}


def generator_server(custom: str, sid: int, max_new: int, chunk: int = QUERY_CHUNK):
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    srv = parse_pipeline(
        f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type=tcp ! "
        f"tensor_generator name=gen custom={custom} slots=16 chunk={chunk} "
        f"prefill-chunk={QUERY_PREFILL_CHUNK} max-new={max_new} ! "
        f"tensor_query_serversink id={sid}", name=f"m2srv{sid}")
    srv.start()
    return srv, srv["ssrc"].props["port"]


def stream_client(port: int, name: str, extra: str = ""):
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_query_client name=q host=127.0.0.1 port={port} "
        f"connect-type=tcp stream=true timeout=120 {extra} ! tensor_sink name=out", name=name)
    pipe.start()
    return pipe


def run_m2(torch, np, counters, seed: int) -> dict:
    """m2: GPT-2 small generation streamed over raw TCP 'S' messages (see
    the docstring)."""
    import threading

    vocab = int(custom_props(LM_CUSTOM)["vocab"])
    rng = np.random.default_rng(seed + 19)
    prompts = [rng.integers(0, vocab, QUERY_TOKENS, dtype=np.int32) for _ in range(QUERY_PROMPTS)]
    custom = f"{LM_CUSTOM},seed:{seed}"
    want, *_ = run_generator(np, custom, prompts, QUERY_NEW, QUERY_CHUNK, 16,
                             prefill_chunk=QUERY_PREFILL_CHUNK)
    unslotted = run_generator(np, custom, prompts[:1], QUERY_NEW, QUERY_CHUNK, 0, keep=lambda p: [
        f.tensors[0].shape[1] for f in p["out"].frames])[4]
    srv, port = generator_server(custom, 182, QUERY_NEW)
    results, errors = {}, []

    def one(i):
        pipe = stream_client(port, f"m2cli{i}")
        try:
            pipe["src"].push(prompts[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=300)
            results[i] = list(pipe["out"].frames)
        except BaseException as e:  # surfaced below
            errors.append(e)
        finally:
            pipe.stop()

    try:
        counters.zero()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,), name=f"m2-client-{i}")
                   for i in range(QUERY_PROMPTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=330)
        wall = time.perf_counter() - t0
        launches = counters.read()
        gen = srv.health()["gen"]
    finally:
        srv.stop()
    if errors or sorted(results) != list(range(QUERY_PROMPTS)):
        raise AssertionError(f"m2: streams {sorted(results)} came back; errors {errors}")
    for i in range(QUERY_PROMPTS):
        sizes = [f.tensors[0].shape[1] for f in results[i]]
        if sizes != unslotted:
            raise AssertionError(f"m2: stream {i}'s chunks are {sizes}, the unslotted path's "
                                 f"{unslotted}")
        if not np.array_equal(stream_tokens(results[i], QUERY_NEW), want[i]):
            raise AssertionError(f"m2: stream {i}'s tokens differ from the in-process generator's")
    if any(launches.values()):
        raise AssertionError(f"m2: the KV-cache decode launched {launches}")
    if (gen["gen_joins"], gen["gen_completed"]) != (QUERY_PROMPTS, QUERY_PROMPTS):
        raise AssertionError(f"m2: joins {gen['gen_joins']}, completed {gen['gen_completed']}")
    # the long server: a client stopped mid-stream, then a budget shorter
    # than the decode
    srv, port = generator_server(custom, 183, QUERY_LONG_NEW)
    try:
        victim = stream_client(port, "m2victim")
        victim["src"].push(prompts[0], pts=0.0)
        deadline = time.perf_counter() + 60
        while len(victim["out"].frames) < 2 and time.perf_counter() < deadline:
            time.sleep(0.005)
        got_chunks = len(victim["out"].frames)
        before = srv.health()["gen"]["gen_cancelled"]
        t_stop = time.perf_counter()
        victim.stop()
        while (srv.health()["gen"]["gen_cancelled"] == before
               and time.perf_counter() - t_stop < 10):
            time.sleep(0.005)
        freed_s = time.perf_counter() - t_stop
        cancelled = srv.health()["gen"]["gen_cancelled"] - before
        evict = stream_client(port, "m2budget", f"timeout={QUERY_BUDGET_S} retries=0")
        arrived = []
        evict["out"].connect_new_data(lambda f: arrived.append(time.perf_counter()))
        cuts_before = srv["gen"]._engine.deadline_cut_calls
        t_push = time.perf_counter()
        evict["src"].push(prompts[1], pts=0.0)
        evict["src"].end_of_stream()
        try:
            evict.wait(timeout=60)
        finally:
            evict.stop()
        budget_frames = list(evict["out"].frames)
        expiry_s = arrived[-1] - t_push if arrived else float("nan")
        cut_calls = srv["gen"]._engine.deadline_cut_calls - cuts_before
        expired = evict.health()["q"]["deadline_expired"]
        deadline = time.perf_counter() + 10
        while srv.health()["gen"]["gen_occupied"] and time.perf_counter() < deadline:
            time.sleep(0.01)
        gen_long = srv.health()["gen"]
    finally:
        srv.stop()
    if got_chunks < 2 or cancelled != 1 or freed_s >= 1.0:
        raise AssertionError(f"m2: the stopped client's slot: cancelled {cancelled} after "
                             f"{freed_s:.3f} s (want 1 within 1 s; {got_chunks} chunks before)")
    last = budget_frames[-1].meta if budget_frames else {}
    n_tok = sum(f.tensors[0].shape[1] for f in budget_frames if f.tensors)
    if not (last.get("final") is True and last.get("deadline_expired") is True
            and last.get("evicted") == "deadline" and 0 < n_tok < QUERY_LONG_NEW
            and n_tok == last.get("tokens_done") and expired >= 1):
        raise AssertionError(f"m2: a {QUERY_BUDGET_S} s budget ended in {last} after {n_tok} "
                             "tokens (want the typed-expiry final chunk with its partial tokens)")
    if not expiry_s < QUERY_BUDGET_S:
        raise AssertionError(f"m2: the typed expiry reached the client {expiry_s:.3f} s after the "
                             f"push ({QUERY_BUDGET_S} s budget; {cut_calls} calls cut short)")
    prefix, *_ = run_generator(np, custom, prompts[1:2], n_tok, QUERY_CHUNK, 16,
                               prefill_chunk=QUERY_PREFILL_CHUNK)
    partial = np.concatenate([f.tensors[0] for f in budget_frames if f.tensors], axis=1)[0]
    if not np.array_equal(partial, prefix[0]):
        raise AssertionError("m2: the expired stream's partial tokens differ from the "
                             "in-process generator's")
    if gen_long["gen_occupied"] or gen_long["gen_evicted"] != 1:
        raise AssertionError(f"m2: the long server's slots: {gen_long}")
    return {"launches": launches, "batches": gen["gen_decode_steps"], "seconds": wall,
            "tokens_per_s": QUERY_PROMPTS * QUERY_NEW / wall, "chunk_sizes": unslotted,
            "freed_s": freed_s, "budget_tokens": n_tok, "expiry_s": expiry_s,
            "deadline_cut_calls": cut_calls,
            "tokens_per_step": gen["gen_tokens_per_step"]}


@contextmanager
def recording_reference(torch, np, lab):
    """Every ``TorchCuda.invoke_batch`` call's rows, keyed by their first 64
    bytes, mapped to the direct call's label in that call's size: the
    reference for frames that any of several servers served in any
    micro-batch.  (The extra module calls launch the kernels again: a run
    under this is not counted.)"""
    from nnstreamer_tpu_torch.backends.torch_cuda import TorchCuda

    inner, ref, served = TorchCuda.invoke_batch, {}, []

    def invoke_batch(self, inputs):
        out = inner(self, inputs)
        x = inputs[0]
        rows = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        (_, n, logits, _), = direct_batches(torch, self._module, rows, [len(rows)])
        labels = lab.top1_plain(logits)[0].cpu().numpy()
        for r, label in zip(rows, labels):
            ref[r.reshape(-1)[:64].tobytes()] = int(label)
        served.append(n)
        return out

    with mock.patch.object(TorchCuda, "invoke_batch", invoke_batch):
        yield ref, served


def check_reference(np, name: str, run: dict, images, ref, served) -> None:
    got = [f.meta["label_index"] for f in run["out"]]
    want = [ref.get(images[i].reshape(-1)[:64].tobytes()) for i in range(len(images))]
    if sum(served) != len(images) or got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"{name}: the servers ran {sum(served)} rows for {len(images)} "
                             f"frames; {len(bad)} labels differ from the direct call of the "
                             f"micro-batch that served them (first frames {bad[:8]})")


def run_m3(torch, np, lab, counters, seed: int, images, labels) -> dict:
    """m3: faults on the wire while the card serves (see the docstring)."""
    import threading

    from nnstreamer_tpu_torch.core.resilience import FAULTS
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    n = len(images)
    out = {}
    servers = [parse_pipeline(query_server_text(184 + k, seed, labels), name=f"m3srv{k}")
               for k in range(2)]
    for s in servers:
        s.start()
    ports = [s["ssrc"].props["port"] for s in servers]
    try:
        # (a) corrupt=bitflip at tcp_query.send
        site = "tcp_query.send"

        def arm(pipe, i):
            if i == 0:
                FAULTS.arm(site, corrupt="bitflip", every=QUERY_FAULT_EVERY, seed=11)

        try:
            with recording_reference(torch, np, lab) as (ref, served):
                run = drive_client(query_client_text(ports, "corrupt-retries=4"), "m3a", images,
                                   during=arm)
            fired = FAULTS.stats(site)["fired"]
        finally:
            FAULTS.reset()
        h = run["health"]
        refused = sum(s.health()["ssrc"]["corrupt_requests"] for s in servers)
        check_reference(np, "m3a", run, images, ref, served)
        if not fired or not h["corruption_detected"] == h["retried"] == refused == fired \
                or h["delivered"] != n:
            raise AssertionError(f"m3a: {fired} corruptions fired; client detected "
                                 f"{h['corruption_detected']}, retried {h['retried']}, delivered "
                                 f"{h['delivered']}; servers refused {refused}")
        out["a"] = {"fired": fired, "retried": h["retried"], "refused": refused,
                    "requests": sum(s.health()["ssrc"]["admitted"] for s in servers)}
        # (b) one server drained mid-stream
        drained = {}

        def drain(pipe, i):
            if i == n // 3:
                t = threading.Thread(target=lambda: drained.update(servers[0].drain(timeout=60)),
                                     name="m3-drain")
                t.start()
                drained["thread"] = t

        before = {k: s.health()["ssrc"]["goaway_sent"] for k, s in enumerate(servers)}
        with recording_reference(torch, np, lab) as (ref, served):
            run = drive_client(query_client_text(ports), "m3b", images, during=drain)
        drained.pop("thread").join(timeout=60)
        h = run["health"]
        goaway = servers[0].health()["ssrc"]["goaway_sent"] - before[0]
        trips = sum(b["trips"] for b in h["breakers"].values())
        check_reference(np, "m3b", run, images, ref, served)
        if drained.get("dropped") != 0 or not h["goaway_replies"] == goaway >= 1 or trips:
            raise AssertionError(f"m3b: drain {drained}, GOAWAY seen {h['goaway_replies']} of "
                                 f"{goaway} sent, breaker trips {trips}")
        out["b"] = {"drain": drained, "goaway": goaway, "breaker_trips": trips}
    finally:
        for s in servers:
            s.stop()
    # (c) a held card tensor over mem-high-watermark sheds BUSY
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    big = total // 4
    base = torch.cuda.memory_reserved()
    high, low = (base + 0.6 * big) / total, (base + 0.3 * big) / total
    srv = parse_pipeline(query_server_text(
        186, seed, labels, f"mem-high-watermark={high:.6f} mem-low-watermark={low:.6f} "
        "mem-sustain=60"), name="m3srv_mem")
    srv.start()
    held = {}

    def wait_for(pred, what):
        deadline = time.perf_counter() + 10
        while not pred():
            if time.perf_counter() > deadline:
                raise AssertionError(f"m3c: the monitor never {what}: "
                                     f"{srv.memory_monitor.snapshot()}")
            time.sleep(0.01)

    def release():
        del held["x"]
        torch.cuda.empty_cache()
        held["s"] = time.perf_counter() - held.pop("t")

    def squeeze(pipe, i):
        # a push can wait behind the shed (backpressure), so the release
        # runs on a timer, not at a later frame
        if i == n * 3 // 10:
            held["x"] = torch.empty(big, dtype=torch.uint8, device="cuda")
            wait_for(lambda: srv.memory_monitor.pressured, "entered pressure")
            held["t"] = time.perf_counter()
            held["timer"] = threading.Timer(QUERY_HOLD_S, release)
            held["timer"].start()

    try:
        with recording_reference(torch, np, lab) as (ref, served):
            run = drive_client(query_client_text(
                [srv["ssrc"].props["port"]], "busy-retries=60 retry-backoff=0.02"), "m3c", images,
                during=squeeze)
        held.pop("timer").join(timeout=10)
        wait_for(lambda: not srv.memory_monitor.pressured, "cleared")
        sh = srv.health()["ssrc"]
    finally:
        srv.stop()
    h = run["health"]
    check_reference(np, "m3c", run, images, ref, served)
    if not h["busy_replies"] == sh["memory_shed"] == sh["load_shed"] >= 1 or sh["mem_pressure"]:
        raise AssertionError(f"m3c: BUSY replies {h['busy_replies']}, memory sheds "
                             f"{sh['memory_shed']}, sheds {sh['load_shed']}, pressure now "
                             f"{sh['mem_pressure']}")
    out["c"] = {"busy_replies": h["busy_replies"], "memory_shed": sh["memory_shed"],
                "held_s": held["s"], "high": high, "low": low, "tensor_bytes": big}
    return out


def run_query(torch, np, lab, counters, seed: int, card: str, work, labels,
              beside=None) -> tuple:
    """Path m: m1-m3 (see their docstrings).  Returns (paths: m1's and m2's
    launches and micro-batches, the summary line)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 20)
    size = int(custom_props(MOBILENET_CUSTOM).get("size", "224"))
    images = rng.integers(0, 256, (QUERY_FRAMES, size, size, 3), dtype=np.uint8)
    secs = {}

    def timed(key, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        secs[key] = time.perf_counter() - t
        return r

    m1 = timed("m1", run_m1, torch, np, lab, counters, seed, images, labels, work, beside)
    torch.cuda.empty_cache()
    m2 = timed("m2", run_m2, torch, np, counters, seed)
    torch.cuda.empty_cache()
    m3 = timed("m3", run_m3, torch, np, lab, counters, seed, images, labels)
    paths = {"query_m1": {"launches": m1["launches"], "batches": m1["batches"]},
             "query_m2": {"launches": m2["launches"], "batches": m2["batches"]}}
    summary = {"card": card, "m1": {k: v for k, v in m1.items() if k != "launches"},
               "m2": {k: v for k, v in m2.items() if k != "launches"}, "m3": m3,
               "seconds": {k: round(v, 3) for k, v in secs.items()} | {
                   "total": round(time.perf_counter() - t0, 3)}}
    def ms(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    a = m1["beside_a"]
    beside_text = "not measured (path a did not run)" if a is None else (
        f"path a's {a['fps_steady']:.1f} frames/s, p50 {a['latency_ms_p50']:.2f} ms p99 "
        f"{a['latency_ms_p99']:.2f} ms, stacking {ms(a['stack_ms_per_batch'])} a batch")
    print(f"path m: m1 {QUERY_FRAMES} frames over 127.0.0.1 TCP in {m1['requests']} requests of "
          f"32, served in {m1['batches']} micro-batches (sizes {m1['sizes']}), labels equal to "
          f"the direct call, normalize_u8 and top1 once each a micro-batch, {m1['d2h_copies']} "
          f"device-to-host copies of {m1['d2h_bytes']} bytes (the labels'), spans exact; "
          f"{m1['fps_steady']:.1f} frames/s after the first micro-batch, push-to-sink p50 "
          f"{m1['latency_ms_p50']:.2f} ms p99 {m1['latency_ms_p99']:.2f} ms, server stacking "
          f"{ms(m1['ingest_stack_ms_per_request'])} a request at ingest and "
          f"{ms(m1['filter_concat_ms_per_batch'])} a micro-batch in the filter (block ingest "
          f"bypasses the lane: {m1['lane_staged']} staged), beside {beside_text} (host clock, "
          f"information); wire-version=1 client {QUERY_V1_FRAMES} frames equal; on {card}")
    print(f"path m: m2 {QUERY_PROMPTS} streams of {QUERY_NEW} tokens over 'S' equal to the "
          f"in-process generator, chunks {m2['chunk_sizes']}; {m2['tokens_per_s']:.1f} tokens/s; "
          f"a stopped client's slot freed after {m2['freed_s'] * 1e3:.0f} ms; a "
          f"{QUERY_BUDGET_S} s budget ended in the typed expiry after {m2['budget_tokens']} "
          f"tokens, {m2['expiry_s']:.3f} s after the push ({m2['deadline_cut_calls']} decode calls "
          f"cut short for the deadline); m3 a {m3['a']}, b {m3['b']}, c {m3['c']}; seconds {summary['seconds']}; "
          f"on {card}")
    return paths, summary


DIST_FRAMES = 1024
#: n1b: frames over MQTT itself (mqttsink qos=1 into mqttsrc qos=1)
DIST_MQTT_FRAMES = 256
#: n2: frames through the discovered servers, then through the standby broker
DIST_QUERY_FRAMES, DIST_FAILOVER_FRAMES = 512, 256
#: n2: frames of the client that discovers the servers during the drain
DIST_LATE_FRAMES = 64
#: n2: seconds one of the draining server's micro-batches is held, so its
#: listener is still open when the late client's discovery probes it
DIST_HOLD_S = 2.0


def dist_model_text(seed: int, labels, name: str = "f") -> str:
    """Path a's model and fused decoder, between a source and a sink."""
    return (f"tensor_filter name={name} framework=torch-cuda model=zoo "
            f"custom={MOBILENET_CUSTOM},seed:{seed} max-batch=128 batch-timeout=20 ! "
            f"tensor_decoder mode=image_labeling option1={labels}")


def wait_for(pred, what: str, timeout: float = 10.0) -> None:
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError(f"path n: {what} within {timeout} s")
        time.sleep(0.005)


def retained_announces(port: int, topic_filter: str = "nns/query/#") -> dict:
    """The retained announces on the broker at 127.0.0.1:`port`, decoded."""
    from nnstreamer_tpu_torch.distributed.mqtt import MqttClient

    got = {}
    c = MqttClient("127.0.0.1", port)
    try:
        c.subscribe(topic_filter, lambda t, p: got.__setitem__(t, json.loads(p) if p else None))
        time.sleep(0.1)
    finally:
        c.close()
    return {t: v for t, v in got.items() if v is not None}


def numbered(np, images):
    """Each frame a TensorFrame carrying its index in the meta (MQTT
    rebases pts into the receiver's clock)."""
    from nnstreamer_tpu_torch.core.buffer import TensorFrame

    return [TensorFrame([images[i]], pts=float(i), meta={"frame": i})
            for i in range(len(images))]


def batch_labels(torch, np, lab, module, images, sizes) -> "np.ndarray":
    """The direct call's labels in the given micro-batch sizes."""
    return np.concatenate([lab.top1_plain(logits)[0].cpu().numpy()
                           for _, _, logits, _ in direct_batches(torch, module, images, sizes)])


def check_once(name: str, out, n: int) -> list:
    """Every frame index of `out` once: returns the frames by index."""
    idx = sorted(f.meta["frame"] for f in out)
    if idx != list(range(n)):
        raise AssertionError(f"{name}: {len(out)} answers for {n} frames, or some lost or twice")
    return sorted(out, key=lambda f: f.meta["frame"])


def run_n1(torch, np, lab, counters, seed: int, images, labels, work) -> dict:
    """n1: camera to card over the raw-TCP edge, labels out over MQTT; then
    frames over MQTT itself (see the docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    n = len(images)
    frames = numbered(np, images)
    broker = MiniBroker()
    pipes = []

    def started(text, name, before=None):
        pipe = parse_pipeline(text, name=name)
        pipes.append(pipe)
        kept = before(pipe) if before is not None else None
        pipe.start()
        return pipe if before is None else (pipe, kept)

    try:
        cam = started("appsrc name=src ! edgesink name=es connect-type=tcp host=127.0.0.1 port=0 "
                      "topic=cam", "n1cam")
        listener = parse_pipeline(
            f"mqttsrc name=ms host=127.0.0.1 port={broker.port} sub-topic=labels qos=1 "
            f"num-buffers={n} sub-timeout=120000 max-msg-buf-size={n} ! tensor_sink name=out",
            name="n1listen")
        arrived = {}
        listener["out"].connect_new_data(
            lambda f: arrived.setdefault(f.meta["frame"], []).append(time.perf_counter()))
        pipes.append(listener)
        listener.start()
        srv, emitted = started(f"edgesrc name=esrc connect-type=tcp dest-host=127.0.0.1 "
                               f"dest-port={cam['es'].props['port']} topic=cam ! "
                               f"{dist_model_text(seed, labels)} ! mqttsink host=127.0.0.1 "
                               f"port={broker.port} pub-topic=labels qos=1", "n1srv",
                               before=lambda pipe: timed_source(pipe, "esrc"))
        wait_for(lambda: cam["es"]._tcp.subscriber_count("cam") == 1
                 and broker.has_subscriber("labels"), "n1's subscribers attached")
        prof = profile(activities=[ProfilerActivity.CUDA])
        with recording_io(srv, "f") as (sizes, outs, _):
            counters.zero()
            prof.start()
            time.sleep(0.5)  # margins: see cuda_kernels
            pushed = []
            t0 = time.perf_counter()
            epoch_off = time.time() - t0  # the MQTT header's wall clock -> perf_counter
            for f in frames:
                pushed.append(time.perf_counter())
                cam["src"].push(f)
            listener.wait(timeout=300)
            wall = time.perf_counter() - t0
            time.sleep(0.5)
            prof.stop()
            launches = counters.read()
        module = srv["f"].backend._module
        out = check_once("n1", listener["out"].frames, n)
        if any(len(v) != 1 for v in arrived.values()):
            raise AssertionError("n1: a label arrived twice")
        # n1b: the frames themselves over MQTT, QoS 1 both ways
        m = DIST_MQTT_FRAMES
        srv_b = started(f"mqttsrc name=ms host=127.0.0.1 port={broker.port} sub-topic=cam "
                        f"qos=1 num-buffers={m} sub-timeout=120000 max-msg-buf-size={m} ! "
                        f"{dist_model_text(seed, labels)} ! tensor_sink name=out", "n1bsrv")
        wait_for(lambda: broker.has_subscriber("cam"), "n1b's subscriber attached")
        tx_b = started(f"appsrc name=src ! mqttsink host=127.0.0.1 port={broker.port} "
                       "pub-topic=cam qos=1", "n1bcam")
        with recording_io(srv_b, "f") as (sizes_b, _, _):
            counters.zero()
            t0 = time.perf_counter()
            for f in numbered(np, images[:m]):
                tx_b["src"].push(f)
            srv_b.wait(timeout=300)
            wall_b = time.perf_counter() - t0
            launches_b = counters.read()
        module_b = srv_b["f"].backend._module
        out_b = check_once("n1b", srv_b["out"].frames, m)
        dropped = [p["ms"].health_info()["dropped_full"] for p in (listener, srv_b)]
    finally:
        for pipe in reversed(pipes):
            pipe.stop()
        broker.close()
    if dropped != [0, 0]:
        raise AssertionError(f"n1, n1b: the mqttsrcs dropped {dropped} messages for a full queue")
    for name, l, s in (("n1", launches, sizes), ("n1b", launches_b, sizes_b)):
        if not l["normalize_u8"] == l["top1"] == len(s) or l["flash_attention"]:
            raise AssertionError(f"{name}: launches {l} for {len(s)} micro-batches (want "
                                 "normalize_u8 and top1 once each)")
    for name, got, want in (
            ("n1", [f.meta["label_index"] for f in out],
             batch_labels(torch, np, lab, module, images, sizes)),
            ("n1b", [f.meta["label_index"] for f in out_b],
             batch_labels(torch, np, lab, module_b, images[:m], sizes_b))):
        if not np.array_equal(np.array(got), want):
            raise AssertionError(f"{name}: {int((np.array(got) != want).sum())} labels differ from "
                                 "the direct call in the server's micro-batch sizes")
    moved = [b for b in d2h_copies(prof, work / "n1_profile.json") if b]
    out_bytes = sorted(int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
                       for call in outs for shape, dt, _ in call)
    if moved != out_bytes:
        raise AssertionError(f"n1: device-to-host copies of {moved} bytes; the labels' are "
                             f"{out_bytes} (one copy a micro-batch, as path a)")
    fps, p50, p99 = stream_numbers(pushed, {i: v[0] for i, v in arrived.items()}, sizes[0] - 1)
    leg = sorted(f.meta["mqtt-latency-s"] * 1e3 for f in out)
    # where a frame's time goes (host clock, ms, p50): push to the server's
    # edgesrc (appsrc queue, edgesink encode, the socket, decode), the
    # server (filter and decoder to mqttsink's publish: the header's sent
    # epoch), the MQTT leg
    sent = [out[i].meta["mqtt-sent-epoch"] - epoch_off for i in range(n)]
    stages = {"to_server_src": [emitted[i] - pushed[i] for i in range(n)],
              "server": [sent[i] - emitted[i] for i in range(n)],
              "mqtt_leg": [arrived[i][0] - sent[i] for i in range(n)]}
    stages = {k: statistics.median(v) * 1e3 for k, v in stages.items()}
    return {"launches": launches, "batches": len(sizes), "sizes": dict(Counter(sizes)),
            "fps": n / wall, "fps_steady": fps, "latency_ms_p50": p50, "latency_ms_p99": p99,
            "mqtt_leg_ms_p50": leg[n // 2], "mqtt_leg_ms_p99": leg[min(n - 1, int(n * 0.99))],
            "stage_ms_p50": stages,
            "d2h_copies": len(moved), "d2h_bytes": sum(moved), "dropped_full": dropped,
            "b": {"launches": launches_b, "batches": len(sizes_b), "fps": m / wall_b,
                  "sizes": dict(Counter(sizes_b))}}


@contextmanager
def recording_rows(torch, np):
    """Every ``TorchCuda.invoke_batch`` call's module and input rows (on the
    host), for a reference computed after the launch counters are read (the
    module is kept: a server stopped since drops its backend's)."""
    from nnstreamer_tpu_torch.backends.torch_cuda import TorchCuda

    inner, calls = TorchCuda.invoke_batch, []

    def invoke_batch(self, inputs):
        x = inputs[0]
        calls.append((self._module,
                      x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)))
        return inner(self, inputs)

    with mock.patch.object(TorchCuda, "invoke_batch", invoke_batch):
        yield calls


def check_served(torch, np, lab, name: str, out, images, calls) -> None:
    """Each answer's label equals the direct call of the micro-batch that
    served its frame, on the server that served it."""
    ref = {}
    for module, rows in calls:
        for r, label in zip(rows, batch_labels(torch, np, lab, module, rows, [len(rows)])):
            ref[r.reshape(-1)[:64].tobytes()] = int(label)
    got = [f.meta["label_index"] for f in out]
    want = [ref.get(images[i].reshape(-1)[:64].tobytes()) for i in range(len(images))]
    if sum(len(rows) for _, rows in calls) != len(images) or got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"{name}: {len(bad)} labels differ from the direct call of the "
                             f"micro-batch that served them (first frames {bad[:8]})")


def crash(pipe) -> None:
    """Stop a server pipeline as a crash would: its retained announce stays."""
    src = pipe["ssrc"]
    ann, src._announcement = src._announcement, None
    ann._client.close()  # no tombstone
    pipe.stop()


def run_n2(torch, np, lab, counters, seed: int, images, labels) -> dict:
    """n2: discovery while the card serves (see the docstring)."""
    import threading

    from nnstreamer_tpu_torch.core.resilience import FAULTS
    from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    images, late_images = images[:DIST_QUERY_FRAMES], images[DIST_QUERY_FRAMES:]
    n = len(images)
    b1, b2 = MiniBroker(), MiniBroker()
    plane = (f"topic=lab dest-host=127.0.0.1 dest-port={b1.port} "
             f"dest-brokers=127.0.0.1:{b2.port}")

    def lab_server(k: int):
        text = query_server_text(190 + k, seed, labels, plane).replace(
            "name=f ", f"name=f{k} ", 1)
        pipe = parse_pipeline(text, name=f"n2srv{k}")
        pipe.start()
        return pipe

    servers, out = [lab_server(0), lab_server(1)], {}
    try:
        ports = [s["ssrc"].props["port"] for s in servers]
        stale = parse_pipeline(
            f"tensor_query_serversrc name=ssrc id=192 host=127.0.0.1 port=0 connect-type=tcp "
            f"{plane} ! tensor_filter framework=scaler custom=factor:2 accelerator=cpu ! "
            "tensor_query_serversink id=192", name="n2stale")
        stale.start()
        stale_port = stale["ssrc"].props["port"]
        crash(stale)
        wait_for(lambda: len(retained_announces(b1.port)) == 3, "three announces retained")
        seen, hold = {}, "element.f0.handle_frame"
        client = (f"appsrc name=src ! tensor_query_client name=q topic=lab dest-host=127.0.0.1 "
                  f"dest-port={b1.port} connect-type=tcp wire-batch=32 max-in-flight=8 "
                  "timeout=60 ! tensor_sink name=out")

        def discover_during_drain():
            """Server 0 drains while one of its micro-batches is held; a
            client that starts then discovers it draining and sends it
            nothing, while the running client meets its GOAWAYs."""
            wait_for(lambda: FAULTS.stats(hold)["fired"] == 1, "the held micro-batch started")
            t = threading.Thread(target=lambda: seen.update(drain=servers[0].drain(timeout=60)),
                                 name="n2-drain")
            t.start()
            seen["drain_thread"] = t
            wait_for(lambda: any(v.get("draining") for v in retained_announces(b1.port).values()),
                     "the draining announce")
            seen["admitted_at_drain"] = [s.health()["ssrc"]["admitted"] for s in servers]
            seen["late"] = drive_client(
                client, "n2late", numbered(np, late_images),
                during=lambda pipe, i: i or seen.update(
                    late_hints=pipe["q"].health_info()["endpoint_hints"]))

        def during(pipe, i):
            if i == 0:
                seen["targets"] = sorted(pipe["q"]._pstate.targets)
            if i == n // 3:
                FAULTS.arm(hold, delay=DIST_HOLD_S, times=1)
                t = threading.Thread(target=discover_during_drain, name="n2-late-client")
                t.start()
                seen["thread"] = t

        goaway_before = servers[0].health()["ssrc"]["goaway_sent"]
        try:
            with recording_rows(torch, np) as calls:
                counters.zero()
                t0 = time.perf_counter()
                run = drive_client(client, "n2cli", numbered(np, images), during=during)
                wall = time.perf_counter() - t0
                seen.pop("thread").join(timeout=60)
                launches = counters.read()
            seen.pop("drain_thread").join(timeout=60)
        finally:
            FAULTS.reset()
        late = seen["late"]
        check_served(torch, np, lab, "n2", run["out"] + late["out"],
                     np.concatenate([images, late_images]), calls)
        want_targets = sorted(("127.0.0.1", p) for p in ports)
        if seen["targets"] != want_targets or ("127.0.0.1", stale_port) in seen["targets"]:
            raise AssertionError(f"n2: discovered {seen['targets']} (want {want_targets}; the "
                                 f"stale announce of port {stale_port} skipped)")
        # what the clients did with the draining announce: the late client
        # ranked server 0 draining and sent it nothing, the running client
        # failed over on every GOAWAY, and server 0 admitted nothing new
        draining = f"127.0.0.1:{ports[0]}"
        h, hl = run["health"], late["health"]
        admitted = [s.health()["ssrc"]["admitted"] for s in servers]
        goaway = servers[0].health()["ssrc"]["goaway_sent"] - goaway_before
        if seen.get("late_hints") != {draining: {"draining": True, "degraded": False}} \
                or hl["goaway_replies"] or admitted[0] != seen["admitted_at_drain"][0] \
                or h["goaway_replies"] != goaway or seen["drain"].get("dropped") != 0:
            raise AssertionError(
                f"n2: during the drain the late client's hints were {seen.get('late_hints')} "
                f"(want {draining} draining), its GOAWAY replies {hl['goaway_replies']} (want 0); "
                f"server 0 admitted {seen['admitted_at_drain'][0]} requests at its draining "
                f"announce and {admitted[0]} at the end; the running client saw "
                f"{h['goaway_replies']} GOAWAYs of {goaway} sent; drain {seen.get('drain')}")
        if not launches["normalize_u8"] == launches["top1"] == len(calls):
            raise AssertionError(f"n2: launches {launches} for {len(calls)} server micro-batches")
        out["discovery"] = {"launches": launches, "batches": len(calls),
                            "fps": n / wall, "goaway_replies": h["goaway_replies"],
                            "late_client": {"frames": len(late_images),
                                            "hints": seen["late_hints"],
                                            "goaway_replies": hl["goaway_replies"],
                                            "admitted_by_server": [
                                                a - b for a, b in
                                                zip(admitted, seen["admitted_at_drain"])]},
                            "stale_port": stale_port}
        # degraded feedback on the other server
        servers[1].degraded_feedback("n2", "device lost (injected)")
        wait_for(lambda: [v.get("degraded") for v in retained_announces(b1.port).values()
                          if v["port"] == ports[1]] == [True], "the degraded announce")
        # broker failover: the drained server restarts, then the first broker dies
        servers[0].stop()
        servers[0] = lab_server(0)
        ports[0] = servers[0]["ssrc"].props["port"]
        b1.close()
        wait_for(lambda: all((s.health()["ssrc"]["reannounces"],
                              s.health()["ssrc"]["plane_reconnects"]) == (1, 1)
                             for s in servers), "one re-announce per server on the standby")
        wait_for(lambda: len(retained_announces(b2.port)) == 2, "both announces on the standby")
        fresh = client.replace(f"dest-port={b1.port}",
                               f"dest-port={b1.port} dest-brokers=127.0.0.1:{b2.port}")
        m = DIST_FAILOVER_FRAMES
        admitted = [s.health()["ssrc"]["admitted"] for s in servers]
        with recording_rows(torch, np) as calls_f:
            counters.zero()
            run_f = drive_client(fresh, "n2fresh", numbered(np, images[:m]),
                                 during=lambda pipe, i: seen.setdefault(
                                     "fresh", (sorted(pipe["q"]._pstate.targets),
                                               pipe["q"].health_info()["endpoint_hints"])))
            launches_f = counters.read()
        check_served(torch, np, lab, "n2 failover", run_f["out"], images[:m], calls_f)
        targets_f, hints_f = seen["fresh"]
        if targets_f != sorted(("127.0.0.1", p) for p in ports) or hints_f != {
                f"127.0.0.1:{ports[1]}": {"draining": False, "degraded": True}}:
            raise AssertionError(f"n2: through the standby the fresh client found {targets_f} "
                                 f"with hints {hints_f}")
        if not launches_f["normalize_u8"] == launches_f["top1"] == len(calls_f):
            raise AssertionError(f"n2 failover: launches {launches_f} for {len(calls_f)} "
                                 "micro-batches")
        health = [s.health()["ssrc"] for s in servers]
        out["failover"] = {"launches": launches_f, "batches": len(calls_f),
                           "reannounces": [x["reannounces"] for x in health],
                           "plane_reconnects": [x["plane_reconnects"] for x in health],
                           "admitted": [x["admitted"] - a for x, a in zip(health, admitted)]}
    finally:
        for s in servers:
            s.stop()
        b1.close()
        b2.close()
    return out


def grpc_modes() -> list:
    """Every element mode that needs ``grpc``."""
    modes = ["appsrc ! tensor_sink_grpc", "tensor_src_grpc ! tensor_sink"]
    for ct in ("server", "client", "hybrid"):
        modes += [f"appsrc ! edgesink connect-type={ct} dest-port=1",
                  f"edgesrc connect-type={ct} dest-port=1 ! tensor_sink"]
    return modes


def run_n3(torch, np, lab, counters, seed: int, images, labels) -> dict:
    """n3: no hidden fallback (see the docstring)."""
    import importlib.util
    import threading

    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    if importlib.util.find_spec("grpc") is None:
        before = {t.name for t in threading.enumerate()}
        refused = []
        for text in grpc_modes():
            pipe = parse_pipeline(text)
            try:
                pipe.start()
            except RuntimeError as e:
                if "requires the grpc package" not in str(e):
                    raise
                refused.append(text)
            else:
                raise AssertionError(f"n3: {text!r} started without grpc")
            finally:
                pipe.stop()
        left = {t.name for t in threading.enumerate()} - before
        if left:
            raise AssertionError(f"n3: refused starts left threads {sorted(left)}")
        return {"grpc": False, "refused": len(refused)}
    from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker

    n = len(images)
    broker = MiniBroker()
    cam = parse_pipeline(f"appsrc name=src ! edgesink name=es connect-type=hybrid "
                         f"dest-host=127.0.0.1 dest-port={broker.port} topic=cam host=127.0.0.1",
                         name="n3cam")
    srv = parse_pipeline(f"edgesrc connect-type=hybrid dest-host=127.0.0.1 dest-port={broker.port} "
                         f"topic=cam ! {dist_model_text(seed, labels)} ! tensor_sink name=out",
                         name="n3srv")
    try:
        cam.start()
        srv.start()
        wait_for(lambda: cam["es"]._broker.subscriber_count("cam") == 1, "n3's subscriber")
        with recording_io(srv, "f") as (sizes, _, _):
            counters.zero()
            for i, f in enumerate(numbered(np, images)):
                # the gRPC broker drops a frame for a full subscriber queue:
                # stay within its depth
                wait_for(lambda: i - len(srv["out"].frames) < 48, "n3's frames arriving", 60)
                cam["src"].push(f)
            wait_for(lambda: len(srv["out"].frames) == n, "n3's labels", 120)
            launches = counters.read()
        module = srv["f"].backend._module
        out = check_once("n3", srv["out"].frames, n)
        dropped = cam["es"].health_info()["dropped_full"]
    finally:
        srv.stop()
        cam.stop()
        broker.close()
    if dropped:
        raise AssertionError(f"n3: the gRPC edge broker dropped {dropped} frames")
    if not launches["normalize_u8"] == launches["top1"] == len(sizes) \
            or launches["flash_attention"]:
        raise AssertionError(f"n3: launches {launches} for {len(sizes)} micro-batches (want "
                             "normalize_u8 and top1 once each)")
    want = batch_labels(torch, np, lab, module, images, sizes)
    if not np.array_equal(np.array([f.meta["label_index"] for f in out]), want):
        raise AssertionError("n3: hybrid labels differ from the direct call")
    return {"grpc": True, "launches": launches, "batches": len(sizes), "dropped_full": dropped}


def run_distributed(torch, np, lab, counters, seed: int, card: str, work, labels,
                    beside=None) -> tuple:
    """Path n: n1-n3 (see their docstrings).  Returns (paths: the launches
    and micro-batches of n1, n1b and n2, the summary line)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 21)
    size = int(custom_props(MOBILENET_CUSTOM).get("size", "224"))
    images = rng.integers(0, 256, (DIST_FRAMES, size, size, 3), dtype=np.uint8)
    secs = {}

    def timed(key, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        secs[key] = time.perf_counter() - t
        return r

    n1 = timed("n1", run_n1, torch, np, lab, counters, seed, images, labels, work)
    torch.cuda.empty_cache()
    n2 = timed("n2", run_n2, torch, np, lab, counters, seed,
               images[:DIST_QUERY_FRAMES + DIST_LATE_FRAMES], labels)
    torch.cuda.empty_cache()
    n3 = timed("n3", run_n3, torch, np, lab, counters, seed, images[:DIST_MQTT_FRAMES], labels)
    paths = {"distributed_n1": {"launches": n1["launches"], "batches": n1["batches"]},
             "distributed_n1b": {"launches": n1["b"]["launches"], "batches": n1["b"]["batches"]},
             "distributed_n2": {"launches": n2["discovery"]["launches"],
                                "batches": n2["discovery"]["batches"]},
             "distributed_n2_failover": {"launches": n2["failover"]["launches"],
                                         "batches": n2["failover"]["batches"]}}
    if n3.get("grpc"):
        paths["distributed_n3"] = {"launches": n3["launches"], "batches": n3["batches"]}
    strip = ("launches",)
    summary = {"card": card,
               "n1": {k: v for k, v in n1.items() if k not in strip and k != "b"}
               | {"b": {k: v for k, v in n1["b"].items() if k not in strip}},
               "n2": {k: {kk: vv for kk, vv in v.items() if kk not in strip}
                      for k, v in n2.items()},
               "n3": {k: v for k, v in n3.items() if k not in strip},
               "beside": None if beside is None else beside,
               "seconds": {k: round(v, 3) for k, v in secs.items()} | {
                   "total": round(time.perf_counter() - t0, 3)}}
    side = "not measured (paths a and m did not run)" if beside is None else ", ".join(
        f"path {k}'s {v['fps_steady']:.1f} frames/s, p50 {v['latency_ms_p50']:.2f} ms"
        for k, v in beside.items())
    print(f"path n: n1 {DIST_FRAMES} frames camera -> edgesink tcp -> edgesrc -> MobileNet-v2 -> "
          f"mqttsink qos=1 -> mqttsrc, {n1['batches']} micro-batches (sizes {n1['sizes']}), every "
          f"label once and equal to the direct call, normalize_u8 and top1 once each a "
          f"micro-batch, {n1['d2h_copies']} device-to-host copies of {n1['d2h_bytes']} bytes (the "
          f"labels'); {n1['fps_steady']:.1f} frames/s after the first micro-batch, push-to-listener "
          f"p50 {n1['latency_ms_p50']:.2f} ms p99 {n1['latency_ms_p99']:.2f} ms, the MQTT leg "
          f"(header's sent epoch) p50 {n1['mqtt_leg_ms_p50']:.3f} ms p99 "
          f"{n1['mqtt_leg_ms_p99']:.3f} ms, stage p50s {n1['stage_ms_p50']}, beside {side} "
          f"(host clock); n1b {DIST_MQTT_FRAMES} "
          f"frames over mqttsink qos=1 -> mqttsrc qos=1 equal, {n1['b']['fps']:.1f} frames/s; "
          f"on {card}")
    d, f = n2["discovery"], n2["failover"]
    print(f"path n: n2 discovery found the two live servers and skipped the stale announce of "
          f"port {d['stale_port']}; {DIST_QUERY_FRAMES} frames labeled equal to the direct call "
          f"in {d['batches']} micro-batches, {d['fps']:.1f} frames/s; during one server's drain "
          f"the running client failed over on {d['goaway_replies']} GOAWAY replies, nothing "
          f"dropped, and a client that discovered then ({d['late_client']}) ranked it draining "
          f"and sent it nothing (its {DIST_LATE_FRAMES} labels equal too); degraded_feedback announced degraded:true; after the first "
          f"broker closed: reannounces {f['reannounces']}, plane_reconnects "
          f"{f['plane_reconnects']}, a fresh client discovered both through the standby and "
          f"labeled {DIST_FAILOVER_FRAMES} frames equal (admitted {f['admitted']}; the degraded "
          f"server ranked below); n3 {n3}; seconds {summary['seconds']}; on {card}")
    return paths, summary


# ---------------------------------------------------------------------------
# path o: stream continuity and the fleet's control loop
# ---------------------------------------------------------------------------
#: GPT-2 small in float32 (its float32 logits differ in the last bits between
#: an uninterrupted decode and a resume's prefill, where bfloat16 would
#: round whole ulps of the logits apart)
FLEET_LM_CUSTOM = LM_CUSTOM.replace("dtype:bfloat16", "dtype:float32")
FLEET_PROMPTS, FLEET_TOKENS, FLEET_NEW, FLEET_CHUNK, FLEET_SLOTS = 16, 128, 64, 8, 8
#: a divergence from the uninterrupted run is excused only where that run's
#: top-2 logit gap is at most this
FLEET_GAP = 1e-2
FLEET_FRAMES = 512         # o3's frames over the two MobileNet-v2 servers
FLEET_DRAIN_FRAMES = 512   # o4's frames while the leader drains one of them
FLEET_GEN_NEW = 256        # the fleet's GPT-2 server's max-new
FLEET_DIGEST_S = 0.5
FLEET_LEASE_TTL = 2.0
FLEET_TICK_S = 0.1


def fleet_gen_text(sid: int, custom: str, slots: int = FLEET_SLOTS, max_new: int = FLEET_NEW,
                   chunk: int = FLEET_CHUNK, extra: str = "") -> str:
    return (f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type=tcp "
            f"{extra} ! tensor_generator name=gen custom={custom} slots={slots} chunk={chunk} "
            f"prefill-chunk=128 prefill-priority={slots} max-new={max_new} ! "
            f"tensor_query_serversink id={sid}")


def start_pipeline(text: str, name: str):
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(text, name=name)
    pipe.start()
    return pipe


class StreamClients:
    """One stream client pipeline a prompt (a client streams its requests
    one after another), each pushing its prompt and ending on its own
    thread; ``frames[i]`` is stream i's chunks in arrival order."""

    def __init__(self, np, prompts, hosts_of, name: str, extra: str = ""):
        import threading

        self.frames = {i: [] for i in range(len(prompts))}
        self.errors, self.health, self.pipes = [], {}, []
        for i in range(len(prompts)):
            hosts = ",".join(f"127.0.0.1:{p}" for p in hosts_of(i))
            pipe = start_pipeline(
                f"appsrc name=src ! tensor_query_client name=q hosts={hosts} connect-type=tcp "
                f"stream=true timeout=120 retry-backoff=0.01 resume-retries=8 {extra} ! "
                f"tensor_sink name=out", f"{name}{i}")
            pipe["out"].connect_new_data(lambda f, i=i: self.frames[i].append(f))
            self.pipes.append(pipe)
        self.threads = [threading.Thread(target=self._one, args=(i, prompts[i]),
                                         name=f"{name}-{i}") for i in range(len(prompts))]
        for t in self.threads:
            t.start()

    def _one(self, i, prompt):
        pipe = self.pipes[i]
        try:
            pipe["src"].push(prompt, pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=300)
            self.health[i] = pipe.health()["q"]
        except BaseException as e:  # surfaced by join()
            self.errors.append((i, e))

    def tokens_seen(self) -> list:
        return [sum(f.tensors[0].shape[1] for f in self.frames[i] if f.tensors)
                for i in sorted(self.frames)]

    def join(self, what: str) -> None:
        for t in self.threads:
            t.join(timeout=330)
        for pipe in self.pipes:
            pipe.stop()
        if self.errors or any(t.is_alive() for t in self.threads):
            raise AssertionError(f"{what}: streams failed: {self.errors}")

    def counter(self, key: str) -> int:
        return sum(int(h[key]) for h in self.health.values())


def check_streams(torch, np, name: str, clients, want, prompts, lm) -> list:
    """Every stream: ``FLEET_NEW`` tokens once each, chunk indices contiguous in
    arrival order with one final chunk (``stream_tokens``), and tokens equal
    to the uninterrupted run's up to the first divergence, which must fall
    where that run's top-2 logit gap (full forward of the same weights) is
    at most ``FLEET_GAP``.  Returns per stream (first divergence or None,
    the gap there)."""
    out = []
    for i in sorted(clients.frames):
        frames = clients.frames[i]
        if [f.meta["chunk_index"] for f in frames] != list(range(len(frames))):
            raise AssertionError(f"{name}: stream {i}'s chunks arrived as "
                                 f"{[f.meta['chunk_index'] for f in frames]}")
        got = stream_tokens(frames, FLEET_NEW)
        diff = np.flatnonzero(got != want[i])
        if not diff.size:
            out.append((None, None))
            continue
        j = int(diff[0])
        seq = torch.from_numpy(np.concatenate([prompts[i], want[i]])[None].astype(np.int32))
        gap = float(full_forward_margins(torch, lm, seq.to(lm.lm_head.weight.device),
                                         len(prompts[i]))[j])
        out.append((j, gap))
        if gap > FLEET_GAP:
            raise AssertionError(f"{name}: stream {i} diverges from the uninterrupted run at "
                                 f"token {j}, where that run's top-2 gap is {gap:.4g} > "
                                 f"{FLEET_GAP}")
    return out


def divergence_line(divs) -> str:
    hit = [(i, j, g) for i, (j, g) in enumerate(divs) if j is not None]
    if not hit:
        return f"all {len(divs)} streams equal to the uninterrupted run"
    return (f"{len(divs) - len(hit)} of {len(divs)} equal; diverged (stream, token, top-2 gap): "
            + ", ".join(f"({i}, {j}, {g:.3g})" for i, j, g in hit))


def run_o1(torch, np, custom: str, prompts, want, lm) -> dict:
    """o1: a drain hands 8 live streams off to the other server; then one
    crash resume (see the docstring)."""
    srv_a = start_pipeline(fleet_gen_text(191, custom), "o1a")
    srv_b = start_pipeline(fleet_gen_text(192, custom), "o1b")
    pa, pb = srv_a["ssrc"].props["port"], srv_b["ssrc"].props["port"]
    try:
        # even streams try A first, odd ones B: 8 live streams on each
        clients = StreamClients(np, prompts, lambda i: (pa, pb) if i % 2 == 0 else (pb, pa),
                                "o1cli")
        wait_for(lambda: min(clients.tokens_seen()) >= 16, "o1: 16 tokens of every stream", 120)
        row_a = srv_a.health()["gen"]
        live_a = row_a["gen_occupied"] + row_a["gen_waiting"]
        t_drain = time.perf_counter()
        srv_a["ssrc"].request_drain()
        clients.join("o1")
        wall_drain = time.perf_counter() - t_drain
        gen_a, gen_b = srv_a.health()["gen"], srv_b.health()["gen"]
        migrations = clients.counter("stream_migrations")
        dups = clients.counter("duplicate_tokens_dropped")
        # every stream A took finished there or was handed off live, and
        # every hand-off resumed on B and was one client migration
        if not (gen_a["gen_goaway_evicted"] == gen_b["gen_resumes"] == migrations > 0
                and gen_a["gen_joins"] == gen_a["gen_completed"] + gen_a["gen_goaway_evicted"]):
            raise AssertionError(
                f"o1: A took {gen_a['gen_joins']} streams ({live_a} live just before the "
                f"drain), completed {gen_a['gen_completed']}, handed off "
                f"{gen_a['gen_goaway_evicted']}; B resumed {gen_b['gen_resumes']}, the clients "
                f"migrated {migrations}")
        if clients.counter("stream_resumes") or clients.counter("resume_failures"):
            raise AssertionError(f"o1: clients {clients.health}")
        divs = check_streams(torch, np, "o1", clients, want, prompts, lm)
        # the crash: A restarted (same port), a stream on B, B stopped without
        # a drain while the stream is on it; it resumes on A
        srv_a.stop()
        srv_a.start()
        crash_cli = StreamClients(np, prompts[:1], lambda i: (pb, pa), "o1crash")
        wait_for(lambda: crash_cli.tokens_seen()[0] >= 16, "o1: 16 tokens of the crash stream", 60)
        srv_b.stop()
        crash_cli.join("o1 crash")
        gen_a2 = srv_a.health()["gen"]
        crash = crash_cli.health[0]
        if (crash["stream_resumes"], crash["stream_migrations"], crash["resume_failures"],
                gen_a2["gen_resumes"]) != (1, 0, 0, 1):
            raise AssertionError(f"o1: the crash stream's client {crash}, restarted A's resumes "
                                 f"{gen_a2['gen_resumes']}")
        crash_div = check_streams(torch, np, "o1 crash", crash_cli, want, prompts, lm)
    finally:
        srv_a.stop()
        srv_b.stop()
    return {"live_on_a": live_a, "joins_a": gen_a["gen_joins"],
            "completed_on_a": gen_a["gen_completed"],
            "goaway_evicted": gen_a["gen_goaway_evicted"],
            "resumed_on_b": gen_b["gen_resumes"], "migrations": migrations,
            "duplicate_tokens_dropped": dups, "drain_to_last_token_s": wall_drain,
            "divergences": [j for j, _ in divs], "gaps": [g for _, g in divs],
            "crash": {"stream_resumes": crash["stream_resumes"],
                      "duplicate_tokens_dropped": crash["duplicate_tokens_dropped"],
                      "divergence": crash_div[0][0], "gap": crash_div[0][1]}}


def run_o2(torch, np, custom: str, prompts, want, lm) -> dict:
    """o2: ``request_resize(16)`` on a serving generator mid-stream (see the
    docstring)."""
    from nnstreamer_tpu_torch.core.slots import SlotEngine

    n = FLEET_SLOTS
    srv = start_pipeline(fleet_gen_text(193, custom), "o2srv")
    gen = srv["gen"]
    port = srv["ssrc"].props["port"]
    try:
        clients = StreamClients(np, prompts[:n], lambda i: (port,), "o2cli")
        wait_for(lambda: min(clients.tokens_seen()) >= 16, "o2: 16 tokens of every stream", 120)
        before = {a: getattr(gen._engine, a) for a in SlotEngine._LEDGER_ATTRS}
        row0 = srv.health()["gen"]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen.request_resize(2 * n)
        wait_for(lambda: not gen.resize_pending, "o2: the resize to land", 60)
        swap_s = time.perf_counter() - t0
        clients.join("o2")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        after = torch.cuda.memory_allocated()
        row = srv.health()["gen"]
        engine = gen._engine
    finally:
        srv.stop()
    migrations = clients.counter("stream_migrations")
    if (row["gen_slots"], row["gen_resizes"]) != (2 * n, 1) or not (
            row["gen_goaway_evicted"] == row["gen_resumes"] == migrations > 0):
        raise AssertionError(f"o2: slots {row['gen_slots']}, resizes {row['gen_resizes']}, "
                             f"handed off {row['gen_goaway_evicted']}, resumed "
                             f"{row['gen_resumes']}, migrations {migrations}")
    back = [a for a in SlotEngine._LEDGER_ATTRS if getattr(engine, a) < before[a]]
    if back:
        raise AssertionError(f"o2: the ledger went backwards across the resize: {back}")
    layers = int(custom_props(custom)["layers"])
    width = int(custom_props(custom)["d_model"])
    seq = int(custom_props(custom)["seq"])
    cache_b = {s: 2 * layers * s * seq * width * 4 for s in (n, 2 * n)}
    # the old width's cache is freed before the new one's is allocated: the
    # peak stays below base + the new cache (both at once would add it whole)
    if peak - base > cache_b[2 * n] - cache_b[n] + (256 << 20):
        raise AssertionError(f"o2: peak {peak} B is {peak - base} B over the {base} B before the "
                             f"resize; the caches are {cache_b} B (both held at once?)")
    divs = check_streams(torch, np, "o2", clients, want, prompts, lm)
    return {"migrations": migrations, "goaway_evicted": row["gen_goaway_evicted"],
            "resumes": row["gen_resumes"], "joins": [row0["gen_joins"], row["gen_joins"]],
            "tokens": [row0["gen_tokens"], row["gen_tokens"]], "swap_s": swap_s,
            "mem_before_b": base, "mem_peak_b": peak, "mem_after_b": after,
            "cache_b": {str(k): v for k, v in cache_b.items()},
            "divergences": [j for j, _ in divs], "gaps": [g for _, g in divs]}


class InProcessActuator:
    """o4's actuator (``core/autoscale.py``'s three verbs, each returning a
    ticket at once): drain -> ``serversrc.request_drain(epoch)``, and the
    drained pipeline stopped once the drain completes (its announce
    tombstoned); resize -> ``generator.request_resize(slots, epoch)``;
    spawn -> one more MobileNet-v2 server on the card.  A stale epoch raises
    at the call, before the target is touched."""

    def __init__(self, servers: dict, spawn_text):
        self.servers, self.spawn_text = servers, spawn_text
        self.threads, self.spawned = [], []

    def _in_thread(self, work):
        import threading

        from nnstreamer_tpu_torch.core.autoscale import ActionTicket

        ticket = ActionTicket()

        def run():
            try:
                work()
                ticket.resolve(True)
            except BaseException as e:  # the ticket carries it
                ticket.resolve(False, repr(e))

        t = threading.Thread(target=run, name="o4-actuation", daemon=True)
        self.threads.append(t)
        t.start()
        return ticket

    def spawn(self, epoch: int = 0):
        def start():
            pipe = start_pipeline(self.spawn_text(), f"o4spawn{len(self.spawned)}")
            self.spawned.append(pipe)
            self.servers[pipe["ssrc"]._announcement.topic] = pipe

        return self._in_thread(start)

    def drain(self, target: str, epoch: int = 0):
        pipe = self.servers[target]
        pipe["ssrc"].request_drain(epoch)

        def finish():
            wait_for(lambda: pipe["ssrc"].drain_complete, "o4: the drain to complete", 60)
            pipe.stop()

        return self._in_thread(finish)

    def resize(self, target: str, slots: int, epoch: int = 0):
        gen = self.servers[target]["gen"]
        gen.request_resize(slots, epoch)
        return self._in_thread(
            lambda: wait_for(lambda: not gen.resize_pending, "o4: the resize to land", 60))

    def join(self) -> None:
        for t in self.threads:
            t.join(timeout=60)


class Ticker:
    """Ticks a controller every ``FLEET_TICK_S`` on a thread of its own (the
    lease renews in the tick) until stopped."""

    def __init__(self, ctl, name: str):
        import threading

        self.ctl, self.stop_ev = ctl, threading.Event()
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop_ev.wait(FLEET_TICK_S):
            self.ctl.tick()

    def stop(self):
        self.stop_ev.set()
        self.thread.join(timeout=10)


def run_o3_o4(torch, np, lab, counters, seed: int, labels, custom: str, images, prompts) -> dict:
    """o3, the observatory over three announcing servers, and o4, two
    controllers contending for the lease (see the docstring)."""
    from nnstreamer_tpu_torch.core import autoscale as asc
    from nnstreamer_tpu_torch.core.fleet import FleetObservatory
    from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker

    broker = MiniBroker()
    bp = broker.port
    announce = (f"topic=fleet dest-host=127.0.0.1 dest-port={bp} "
                f"digest-interval={FLEET_DIGEST_S}")
    sid = iter(range(194, 210))

    def mobilenet():
        return query_server_text(next(sid), seed, labels, announce)


    pipes, obs, ctls, chans, acts, tickers, gen_clis = [], None, [], [], [], [], []
    try:
        obs = FleetObservatory(topic="fleet", stale_fraction=0.9).start("127.0.0.1", bp)
        mport = obs.serve_metrics(0)
        m1 = start_pipeline(mobilenet(), "o3m1")
        m2 = start_pipeline(mobilenet(), "o3m2")
        g = start_pipeline(fleet_gen_text(next(sid), custom, max_new=FLEET_GEN_NEW, chunk=16,
                                          extra=announce), "o3g")
        pipes += [m1, m2, g]
        wait_for(lambda: len(obs.servers()) == 3, "o3: the observatory to see three servers")
        # ---- o3: traffic, exact rollups, a tombstone
        n = FLEET_FRAMES
        with recording_rows(torch, np) as calls:
            counters.zero()
            t0 = time.perf_counter()
            run = drive_client(query_client_text([m1["ssrc"].props["port"],
                                                  m2["ssrc"].props["port"]]), "o3cli",
                               images[:n])
            launches = counters.read()
            o3_fps = n / (time.perf_counter() - t0)
        check_served(torch, np, lab, "o3", run["out"], images[:n], calls)
        if not launches["normalize_u8"] == launches["top1"] == len(calls) or \
                launches["flash_attention"]:
            raise AssertionError(f"o3: launches {launches} for {len(calls)} micro-batches")
        gcli = StreamClients(np, prompts[:4], lambda i: (g["ssrc"].props["port"],), "o3gen")
        gcli.join("o3 generation")

        def ledgers():
            rows = [p.health() for p in (m1, m2, g)]
            return (sum(r["ssrc"]["admitted"] for r in rows), rows[2]["gen"]["gen_tokens"])

        admitted, tokens = ledgers()
        wait_for(lambda: (obs.rollup()["admitted"], obs.rollup()["tokens"]) == (admitted, tokens),
                 "o3: the rollup to reach the servers' ledgers", 10)
        m2.stop()  # a last digest, then the tombstone
        wait_for(lambda: obs.rollup()["retired"] == 1, "o3: the stopped server retired", 10)
        roll = obs.rollup()
        if (roll["servers"], roll["admitted"], roll["tokens"]) != (2, admitted, tokens):
            raise AssertionError(f"o3: rollup {roll} against the ledgers admitted {admitted}, "
                                 f"tokens {tokens}")
        metrics = scrape(mport)
        scraped = {k: series(metrics, f"nns_fleet_{k}", fleet="fleet")
                   for k in ("admitted", "tokens", "retired", "servers")}
        if scraped != {"admitted": admitted, "tokens": tokens, "retired": 1, "servers": 2}:
            raise AssertionError(f"o3: /metrics nns.fleet.* {scraped}")
        o3 = {"frames": n, "batches": len(calls), "launches": launches, "fps": o3_fps,
              "admitted": admitted, "tokens": tokens, "rollup": {
                  k: roll[k] for k in ("servers", "retired", "digests", "admitted", "tokens",
                                       "tokens_per_s", "slots", "plane_connected")}}
        # ---- o4: two controllers, one lease
        servers = {p["ssrc"]._announcement.topic: p for p in (m1, g)}
        g_topic = g["ssrc"]._announcement.topic
        leases = [asc.LeaderLease(f"ctl-{c}", ttl_s=FLEET_LEASE_TTL) for c in "ab"]
        chans = [asc.LeaseChannel("127.0.0.1", bp, "fleet", ls) for ls in leases]
        acts = [InProcessActuator(servers, mobilenet) for _ in leases]
        # stale rows never freeze this run's plane (its sweepers are busy)
        knobs = dict(max_servers=4, plane_stale_fraction_max=1.0)
        floor = asc.FleetPolicy(min_servers=3, up_streak=1, cooldown_up_s=0.0, **knobs)
        hold = asc.FleetPolicy(min_servers=1, down_streak=10 ** 6, **knobs)
        drain_once = asc.FleetPolicy(min_servers=1, down_streak=2, cooldown_down_s=600.0,
                                     **knobs)
        ctls = [asc.FleetController(obs, act, pol, lease=ls).start()
                for act, ls, pol in zip(acts, leases, (floor, drain_once))]
        ctl_a, ctl_b = ctls
        lease_a, lease_b = leases
        wait_for(lambda: all(c.connected for c in chans), "o4: the lease channels to connect")
        # a busy generator is never the least loaded, so the drains pick a
        # MobileNet-v2 server
        gen_clis.append(StreamClients(np, prompts[4:6], lambda i: (g["ssrc"].props["port"],),
                                      "o4gen"))
        t0 = time.perf_counter()
        tickers.append(Ticker(ctl_a, "o4-ctl-a"))
        wait_for(lambda: lease_a.held, "o4: controller a to take the lease", 20)
        wait_for(lambda: lease_b._seen is not None, "o4: the standby to see the lease")
        tickers.append(Ticker(ctl_b, "o4-ctl-b"))
        # the floor (3 servers) spawns one more MobileNet-v2 server
        wait_for(lambda: ctl_a.scale_ups == 1, "o4: the floor to spawn a server", 20)
        ctl_a.policy = hold
        wait_for(lambda: len(acts[0].spawned) == 1 and not ctl_a.inflight(),
                 "o4: the spawned server to start", 60)
        m3 = acts[0].spawned[0]
        pipes.append(m3)
        wait_for(lambda: len(obs.servers()) == 3, "o4: the observatory to see the spawned server")
        if lease_b.held or ctl_b.scale_ups or lease_b.refusals < 1:
            raise AssertionError(f"o4: the standby took the held lease or acted "
                                 f"(refusals {lease_b.refusals})")
        # the leader drains an idle MobileNet-v2 server while a client sends
        # frames to both
        def during(pipe, i):
            if i == FLEET_DRAIN_FRAMES // 4:
                ctl_a.policy = drain_once
                wait_for(lambda: ctl_a.scale_downs == 1, "o4: the leader to drain a server", 20)

        mports = [m1["ssrc"].props["port"], m3["ssrc"].props["port"]]
        with recording_rows(torch, np) as calls4:
            counters.zero()
            run4 = drive_client(query_client_text(mports), "o4cli",
                                images[:FLEET_DRAIN_FRAMES], during=during)
            launches4 = counters.read()
        check_served(torch, np, lab, "o4", run4["out"], images[:FLEET_DRAIN_FRAMES], calls4)
        if not launches4["normalize_u8"] == launches4["top1"] == len(calls4):
            raise AssertionError(f"o4: launches {launches4} for {len(calls4)} micro-batches")
        wait_for(lambda: not ctl_a.inflight(), "o4: the drain ticket to complete", 60)
        drained = [a for _, a, status in ctl_a.recent if a.kind == asc.SCALE_DOWN]
        drained_pipe = servers[drained[0].target]
        if drained_pipe is g or not drained_pipe["ssrc"].drain_complete or ctl_a.actions_failed:
            raise AssertionError(f"o4: drained {drained}, failed actions {ctl_a.actions_failed}")
        survivor = m3 if drained_pipe is m1 else m1
        s_topic = survivor["ssrc"]._announcement.topic
        # the leader stops; the standby takes the lease at a higher epoch and
        # drains the survivor, then widens the generator under live streams
        gen_cli2 = StreamClients(np, prompts[6:8], lambda i: (g["ssrc"].props["port"],),
                                 "o4gen2")
        gen_clis.append(gen_cli2)
        tickers[0].stop()
        ctl_a.stop()
        chans[0].close()
        t_stop = time.perf_counter()
        wait_for(lambda: ctl_b.scale_downs == 1, "o4: the standby to take over and drain", 30)
        takeover_s = time.perf_counter() - t_stop
        targets_b = [a.target for _, a, _ in ctl_b.recent if a.kind == asc.SCALE_DOWN]
        if targets_b != [s_topic] or lease_b.epoch <= lease_a.epoch or not lease_b.held:
            raise AssertionError(f"o4: the new leader drained {targets_b}; epochs a "
                                 f"{lease_a.epoch} b {lease_b.epoch}")
        t_rs = acts[1].resize(g_topic, 2 * FLEET_SLOTS, epoch=lease_b.epoch)
        if not t_rs.wait(60) or not t_rs.ok:
            raise AssertionError(f"o4: the new leader's resize failed: {t_rs.detail}")
        # the deposed leader's commands, refused before anything is touched
        state = lambda: (g.health()["gen"]["gen_goaway_evicted"],  # noqa: E731
                         g["gen"].resize_pending, survivor["ssrc"]._drain_requested.is_set(),
                         g.health()["gen"]["gen_slots"])
        before = state()
        stale = []
        for verb, args in (("drain", (s_topic,)), ("resize", (g_topic, FLEET_SLOTS))):
            try:
                getattr(acts[0], verb)(*args, epoch=lease_a.epoch)
            except asc.StaleEpochError as e:
                stale.append(str(e))
        after = state()
        rejects = (survivor.health()["ssrc"]["stale_epoch_rejects"],
                   g.health()["gen"]["gen_stale_epoch_rejects"])
        if len(stale) != 2 or rejects != (1, 1) or before != after:
            raise AssertionError(f"o4: deposed commands: {stale}, rejects {rejects}, state "
                                 f"{before} -> {after}")
        wait_for(lambda: not ctl_b.inflight(), "o4: the new leader's drain to complete", 60)
        for cli in gen_clis:
            cli.join("o4 generation")
            for i in cli.frames:
                stream_tokens(cli.frames[i], FLEET_GEN_NEW)
        gen_row = g.health()["gen"]
        migrations = sum(cli.counter("stream_migrations") for cli in gen_clis)
        if gen_row["gen_goaway_evicted"] != migrations or gen_row["gen_resumes"] != migrations:
            raise AssertionError(f"o4: the resize handed off {gen_row['gen_goaway_evicted']}, "
                                 f"resumed {gen_row['gen_resumes']}, migrations {migrations}")
        metrics = scrape(mport)
        auto = {k: series(metrics, f"nns_autoscale_{k}", fleet="fleet")
                for k in ("lease_epoch", "lease_held", "scale_downs", "ticks")}
        if (auto["lease_epoch"], auto["lease_held"], auto["scale_downs"]) != (lease_b.epoch, 1, 1):
            raise AssertionError(f"o4: /metrics nns.autoscale.* {auto}")
        o4 = {"frames": FLEET_DRAIN_FRAMES, "batches": len(calls4), "launches": launches4,
              "epochs": [lease_a.epoch, lease_b.epoch], "spawned": len(acts[0].spawned),
              "standby_refusals": lease_b.refusals, "takeover_s": takeover_s,
              "stale_rejects": list(rejects), "gen_slots": gen_row["gen_slots"],
              "gen_resizes": gen_row["gen_resizes"], "gen_migrations": migrations,
              "autoscale_scrape": auto,
              "goaway_replies": run4["health"]["goaway_replies"],
              "retried": run4["health"]["retried"],
              "seconds": time.perf_counter() - t0}
    finally:
        for tk in tickers:
            tk.stop()
        for cli in gen_clis:
            for pipe in cli.pipes:
                pipe.stop()
        for c in ctls:
            c.stop()
        for c in chans:
            c.close()
        for act in acts:
            act.join()
            pipes += [p for p in act.spawned if p not in pipes]
        for p in pipes:
            p.stop()
        if obs is not None:
            obs.stop()
        broker.close()
    return o3, o4


def run_fleet(torch, np, lab, counters, seed: int, card: str, labels) -> tuple:
    """Path o: o1-o4 (see their docstrings).  Returns (paths: o3's and o4's
    launches and micro-batches, the summary line)."""
    from nnstreamer_tpu_torch.models import transformer as tr

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 23)
    custom = f"{FLEET_LM_CUSTOM},seed:{seed}"
    vocab = int(custom_props(custom)["vocab"])
    prompts = [rng.integers(0, vocab, FLEET_TOKENS, dtype=np.int32) for _ in range(FLEET_PROMPTS)]
    size = int(custom_props(MOBILENET_CUSTOM).get("size", "224"))
    images = rng.integers(0, 256, (max(FLEET_FRAMES, FLEET_DRAIN_FRAMES), size, size, 3),
                          dtype=np.uint8)
    secs = {}
    t = time.perf_counter()
    counters.zero()
    want, *_ = run_generator(np, custom, prompts, FLEET_NEW, FLEET_CHUNK, FLEET_SLOTS)
    secs["reference"] = time.perf_counter() - t
    props = custom_props(custom)
    props["attn"] = "xla"
    lm = tr.lm_from_props(props, "cuda")
    t = time.perf_counter()
    o1 = run_o1(torch, np, custom, prompts, want, lm)
    secs["o1"] = time.perf_counter() - t
    print(f"path o: o1 {FLEET_PROMPTS} GPT-2-small float32 streams of {FLEET_NEW} tokens over two "
          f"slots={FLEET_SLOTS} servers; A drained with {o1['live_on_a']} live: handed off "
          f"{o1['goaway_evicted']}, resumed on B {o1['resumed_on_b']}, client migrations "
          f"{o1['migrations']}, duplicate tokens dropped {o1['duplicate_tokens_dropped']}; "
          f"{divergence_line(list(zip(o1['divergences'], o1['gaps'])))}; crash resume on the "
          f"restarted A {o1['crash']}; on {card}")
    t = time.perf_counter()
    o2 = run_o2(torch, np, custom, prompts, want, lm)
    secs["o2"] = time.perf_counter() - t
    print(f"path o: o2 request_resize({2 * FLEET_SLOTS}) mid-stream: {o2['migrations']} "
          f"migrations = {o2['goaway_evicted']} hand-offs = {o2['resumes']} resumes, swap "
          f"{o2['swap_s']:.3f} s, card memory before {o2['mem_before_b']} B, peak "
          f"{o2['mem_peak_b']} B, after {o2['mem_after_b']} B (KV caches {o2['cache_b']} B); "
          f"{divergence_line(list(zip(o2['divergences'], o2['gaps'])))}; on {card}")
    gen_launches = counters.read()
    if any(gen_launches.values()):
        raise AssertionError(f"o1/o2: the KV-cache decode launched {gen_launches}")
    del lm
    torch.cuda.empty_cache()
    t = time.perf_counter()
    o3, o4 = run_o3_o4(torch, np, lab, counters, seed, labels, custom, images, prompts)
    secs["o3_o4"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    paths = {"fleet_o3": {"launches": o3.pop("launches"), "batches": o3["batches"]},
             "fleet_o4": {"launches": o4.pop("launches"), "batches": o4["batches"]}}
    summary = {"card": card, "o1": o1, "o2": o2, "o3": o3, "o4": o4,
               "seconds": {k: round(v, 3) for k, v in secs.items()} | {
                   "total": round(time.perf_counter() - t0, 3)}}
    print(f"path o: o3 {o3['frames']} frames over two MobileNet-v2 servers in {o3['batches']} "
          f"micro-batches, labels equal, normalize_u8 and top1 once each a micro-batch, "
          f"{o3['fps']:.1f} frames/s; rollup after a tombstone {o3['rollup']} = the ledgers; "
          f"o4 epochs {o4['epochs']}, spawned {o4['spawned']}, {o4['frames']} frames labeled "
          f"through the leader's drain (client GOAWAY replies {o4['goaway_replies']}, resends "
          f"{o4['retried']}), takeover {o4['takeover_s']:.3f} s, stale rejects "
          f"{o4['stale_rejects']}, generator slots {o4['gen_slots']}; seconds "
          f"{summary['seconds']}; on {card}")
    return paths, summary


# -- path p: user filters, framework=auto, native mailboxes, the launch CLI ----------------

USER_FRAMES = 256          # p1's frames per file, p3's, p4's and p6's
USER_EASY_FRAMES = 512     # p2's
MAILBOX_AB_FRAMES = 2048   # p5's runs (path a's frames)
MAILBOX_AB_PAIRS = 5       # p5's alternating queue.Queue / NativeMailbox pairs
IIO_FRAMES, IIO_SAMPLES = 64, 4


def block_run(np, counters, text: str, frames, block: int = 128) -> dict:
    """`frames` pushed as blocks of `block` (so every run hands its filter
    ``f`` the same micro-batches) through `text` (sink ``out``): labels,
    launches, micro-batch sizes, the framework ``auto`` resolved, the
    backend's module."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    pipe = parse_pipeline(text)
    counters.zero()
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            for k in range(0, len(frames), block):
                pipe["src"].push_block(frames[k:k + block],
                                       pts=[float(i) for i in range(k, min(k + block,
                                                                          len(frames)))])
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
        launches = counters.read()
        framework = pipe["f"]._framework
        module = pipe["f"].backend._module
        out = pipe["out"].frames
    finally:
        pipe.stop()
    if [f.pts for f in out] != [float(i) for i in range(len(frames))]:
        raise AssertionError(f"{len(out)} of {len(frames)} frames came back, or out of order")
    return {"labels": np.array([f.meta["label_index"] for f in out]), "launches": launches,
            "sizes": list(sizes), "framework": framework, "module": module}


def run_p1(torch, np, counters, seed: int, card: str, work, labels) -> dict:
    """p1: ``framework=auto`` on path j1's uint8 ``.tflite`` (``custom=int8:true``)
    and path j3's ``.onnx``, USER_FRAMES frames each in blocks of 128, after
    the same frames through the explicit framework: the framework resolved,
    labels and every launch count equal to the explicit run's."""
    paths = _MODEL_FILES.get(seed) or write_model_files(torch, np, seed, work)[0]
    torch.cuda.empty_cache()
    frames = np.random.default_rng(seed + 29).integers(0, 256, (USER_FRAMES, 1, 224, 224, 3),
                                                       dtype=np.uint8)
    out = {}
    for kind, path, custom in (("tflite", paths["uint8"], "custom=int8:true"),
                               ("onnx", paths["onnx"], "")):
        runs = [(fw, block_run(np, counters, (
            f"appsrc name=src ! tensor_filter name=f framework={fw} model={path} {custom} "
            f"max-batch=128 ! tensor_decoder mode=image_labeling option1={labels} ! "
            f"tensor_sink name=out"), frames)) for fw in (kind, "auto")]
        explicit, auto = runs[0][1], runs[1][1]
        b = len(auto["sizes"])
        for fw, r in runs:
            if r["framework"] != kind:
                raise AssertionError(f"p1: framework={fw} on {path.name} resolved {r['framework']}")
            if not np.array_equal(r["labels"], explicit["labels"]):
                bad = np.flatnonzero(r["labels"] != explicit["labels"])
                raise AssertionError(f"p1 {kind}: {len(bad)} labels of framework={fw} differ from "
                                     f"framework={kind}'s (first frames {bad[:8]})")
            if r["launches"] != explicit["launches"] or r["sizes"] != explicit["sizes"]:
                raise AssertionError(f"p1 {kind}: framework={fw}'s launches {r['launches']} in "
                                     f"{r['sizes']} vs {explicit['launches']} in "
                                     f"{explicit['sizes']}")
        if auto["launches"]["top1"] != b or (kind == "tflite" and not auto["launches"]["int8_conv"]):
            raise AssertionError(f"p1 {kind}: launches {auto['launches']} for {b} micro-batches")
        out[kind] = {"launches": auto["launches"], "batches": b}
        print(f"path p: p1 framework=auto on {path.name} resolved {kind}: {USER_FRAMES} frames "
              f"in {b} micro-batches, labels and launches equal to framework={kind}'s "
              f"({ {k: v for k, v in auto['launches'].items() if v} }); on {card}", flush=True)
    return out


def run_p2(torch, np, lab, counters, seed: int, card: str, labels) -> dict:
    """p2: path a's MobileNet-v2 (224, width 1.0, 1001 classes, bf16) as a
    batched ``custom-easy`` callable that moves each micro-batch to the card
    and runs the module (``normalize_u8``, then the body), the labeling
    decoder on the host (custom-easy fuses no device half); USER_EASY_FRAMES
    frames pushed one by one at ``max-batch=128``: labels equal to the
    module called directly in the same micro-batch sizes, then
    ``top1_plain``; ``normalize_u8`` once per invoke, ``top1`` never."""
    from nnstreamer_tpu_torch.backends import register_custom_easy, unregister_custom_easy
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    module, in_spec, out_spec = build("mobilenet_v2", custom_props(f"{MOBILENET_CUSTOM},seed:{seed}"))
    module = module.cuda().eval()

    def fn(inputs):
        with torch.inference_mode():
            return [module(torch.from_numpy(inputs[0]).to("cuda"))]

    register_custom_easy("p2_mobilenet_v2", fn, in_spec, out_spec, batched=True)
    images = np.random.default_rng(seed).integers(0, 256, (USER_EASY_FRAMES, 224, 224, 3),
                                                  dtype=np.uint8)
    pipe = parse_pipeline(
        "appsrc name=src ! tensor_filter name=f framework=custom-easy model=p2_mobilenet_v2 "
        f"max-batch=128 batch-timeout=20 ! tensor_decoder mode=image_labeling option1={labels} "
        "! tensor_sink name=out")
    counters.zero()
    pipe.start()
    try:
        with recording_batches(pipe, "f") as sizes:
            for i in range(USER_EASY_FRAMES):
                pipe["src"].push(images[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
        launches = counters.read()
        out = pipe["out"].frames
    finally:
        pipe.stop()
        unregister_custom_easy("p2_mobilenet_v2")
    b = len(sizes)
    if [f.pts for f in out] != [float(i) for i in range(USER_EASY_FRAMES)]:
        raise AssertionError(f"p2: {len(out)} of {USER_EASY_FRAMES} frames back, or out of order")
    if launches["normalize_u8"] != b or launches["top1"] != 0:
        raise AssertionError(f"p2: launches {launches} for {b} invokes (want normalize_u8 once "
                             "each and no top1: the decoder runs on the host)")
    got = np.array([f.meta["label_index"] for f in out])
    want, k = [], 0
    with torch.inference_mode():
        for n in sizes:
            want.append(lab.top1_plain(module(torch.from_numpy(images[k:k + n]).cuda()))[0]
                        .cpu().numpy())
            k += n
    if not np.array_equal(got, np.concatenate(want)):
        raise AssertionError("p2: the custom-easy pipeline's labels differ from the module called "
                             "directly in the same micro-batch sizes")
    print(f"path p: p2 custom-easy MobileNet-v2 {USER_EASY_FRAMES} frames in {b} invokes (sizes "
          f"{sorted(set(sizes))}), labels equal to the direct call; normalize_u8 launched "
          f"{launches['normalize_u8']} times ({launches['normalize_u8'] / b:g} per invoke), top1 "
          f"{launches['top1']} (the decoder on the host); on {card}", flush=True)
    return {"launches": launches, "batches": b}


def run_p3(torch, np, counters, seed: int, card: str, work) -> dict:
    """p3: path a's model body traced on the card with ``torch.jit.trace`` on
    float input (the frames already normalized, so ``normalize_u8`` is not
    in the graph), saved, and served by ``framework=auto model=<x>.pt``
    (TorchScript: the ``torch`` backend, on the card): USER_FRAMES frames,
    outputs equal bit for bit to the loaded module called directly in the
    same micro-batch sizes.  TorchScript's fusers are off for the phase, so
    the profiling executor cannot change the arithmetic between calls."""
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    module = build("mobilenet_v2", custom_props(f"{MOBILENET_CUSTOM},seed:{seed}"))[0]
    module = module.cuda().eval()
    u8 = np.random.default_rng(seed + 31).integers(0, 256, (USER_FRAMES, 224, 224, 3),
                                                  dtype=np.uint8)
    x = u8.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)
    path = work / "mobilenet_v2_body.pt"
    with torch.no_grad():
        traced = torch.jit.trace(module, torch.from_numpy(x[:8]).cuda(), check_trace=False)
    torch.jit.save(traced, str(path))
    del traced, module
    prev = torch.jit.set_fusion_strategy([("STATIC", 0), ("DYNAMIC", 0)])
    try:
        pipe = parse_pipeline(f"appsrc name=src ! tensor_filter name=f framework=auto "
                              f"model={path} max-batch=128 batch-timeout=20 ! tensor_sink "
                              "name=out")
        counters.zero()
        pipe.start()
        try:
            loaded, framework = pipe["f"].backend._module, pipe["f"]._framework
            with recording_batches(pipe, "f") as sizes:
                for i in range(USER_FRAMES):
                    pipe["src"].push(x[i], pts=float(i))
                pipe["src"].end_of_stream()
                pipe.wait(timeout=600)
            launches = counters.read()
            out = pipe["out"].frames
        finally:
            pipe.stop()
        if framework != "torch" or len(out) != USER_FRAMES:
            raise AssertionError(f"p3: framework=auto resolved {framework}; {len(out)} frames")
        got = np.stack([np.asarray(f.tensors[0]) for f in out])
        want, k = [], 0
        with torch.inference_mode():
            for n in sizes:
                want.append(loaded(torch.from_numpy(x[k:k + n]).cuda()).cpu().numpy())
                k += n
        want = np.concatenate(want)
    finally:
        torch.jit.set_fusion_strategy(prev)
    if got.dtype != want.dtype or not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("p3: the TorchScript pipeline's logits differ from the traced "
                             "module called directly (bit for bit)")
    print(f"path p: p3 TorchScript {path.name} ({path.stat().st_size / 2**20:.1f} MiB) through "
          f"framework=auto -> torch: {USER_FRAMES} frames in {len(sizes)} micro-batches, logits "
          f"bit-equal to the traced module called directly; launches "
          f"{ {k: v for k, v in launches.items() if v} }; on {card}", flush=True)
    return {"batches": len(sizes)}


def run_p4(np, seed: int, card: str, work) -> dict:
    """p4: ``framework=custom`` on ``libscaler.so`` (g++ from the port's copy of
    ``native/examples/scaler_custom.cc``, ``custom=mult:2.0``) and
    ``framework=python3`` on a doubling script, USER_FRAMES float32 frames
    of (224, 224, 3) each: every output equal to ``2 * x`` exactly.  A
    missing g++ fails the phase."""
    import shutil

    from nnstreamer_tpu_torch.native import runtime
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    gxx = shutil.which("g++")
    print(f"path p: p4 g++ {'found: ' + gxx if gxx else 'NOT found'}", flush=True)
    if gxx is None:
        raise AssertionError("p4: g++ not found: the custom filter's subplugin cannot be built")
    t = time.perf_counter()
    so = runtime.build_example("scaler_custom")
    build_s = time.perf_counter() - t
    script = work / "double_filter.py"
    script.write_text("def invoke(inputs):\n    return [x * 2 for x in inputs]\n")
    frames = np.random.default_rng(seed + 37).standard_normal((USER_FRAMES, 224, 224, 3),
                                                              dtype=np.float32)
    out = {"build_s": build_s}
    for fw, model, custom in (("custom", so, "custom=mult:2.0"), ("python3", script, "")):
        pipe = parse_pipeline(f"appsrc name=src ! tensor_filter name=f framework={fw} "
                              f"model={model} {custom} ! tensor_sink name=out")
        pipe.start()
        try:
            for i in range(USER_FRAMES):
                pipe["src"].push(frames[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
            got = pipe["out"].frames
        finally:
            pipe.stop()
        if len(got) != USER_FRAMES or not all(
                np.array_equal(np.asarray(f.tensors[0]), 2 * frames[i]) for i, f in enumerate(got)):
            raise AssertionError(f"p4: framework={fw}'s outputs are not 2 * x exactly")
    print(f"path p: p4 framework=custom on {so.name} (g++ {build_s:.1f} s) and framework=python3 "
          f"on {script.name}: {USER_FRAMES} float32 frames of (224, 224, 3) each equal to 2 * x "
          f"exactly; on {card}", flush=True)
    return out


def mailbox_kinds(pipe) -> dict:
    """Every non-leaky mailbox's type name (and the appsrc queues')."""
    kinds = {el.name: type(el._mailbox).__name__ for el in pipe.elements.values()
             if el._mailbox is not None and not getattr(el, "leaky_policy", "")}
    kinds.update({el.name: type(el._q).__name__ for el in pipe.elements.values()
                  if hasattr(el, "_q")})
    return kinds


@contextmanager
def native_mailboxes():
    """While open, the pipelines built and started take ``NativeMailbox``
    where the port's scheduler and ``appsrc`` take ``queue.Queue`` (the
    JAX package's default): both modules' ``queue`` name is swapped for one
    whose ``Queue`` is the native class (the exceptions stay the
    stdlib's).  A measurement's switch, nothing of the program."""
    import queue
    from types import SimpleNamespace

    from nnstreamer_tpu_torch.elements import basic
    from nnstreamer_tpu_torch.native.runtime import NativeMailbox
    from nnstreamer_tpu_torch.pipeline import pipeline

    native = SimpleNamespace(Queue=NativeMailbox, Empty=queue.Empty, Full=queue.Full)
    with mock.patch.object(pipeline, "queue", native), mock.patch.object(basic, "_queue", native):
        yield


def mailbox_run(np, counters, text: str, images, native: bool) -> dict:
    """One run of path a's pipeline `text` on `images` (pushed one by one),
    its non-leaky mailboxes ``queue.Queue`` (the port's) or, with `native`,
    ``NativeMailbox``: labels, launches, micro-batches, the mailbox types,
    frames/s after the first micro-batch."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    with (native_mailboxes() if native else nullcontext()):
        pipe = parse_pipeline(text)
        arrived = {}
        pipe["out"].connect_new_data(lambda f: arrived.__setitem__(int(f.pts),
                                                                   time.perf_counter()))
        counters.zero()
        pipe.start()
    try:
        kinds = mailbox_kinds(pipe)
        with recording_batches(pipe, "f") as sizes:
            for i in range(len(images)):
                pipe["src"].push(images[i], pts=float(i))
            pipe["src"].end_of_stream()
            pipe.wait(timeout=600)
        launches = counters.read()
        out = pipe["out"].frames
    finally:
        pipe.stop()
    if [f.pts for f in out] != [float(i) for i in range(len(images))]:
        raise AssertionError(f"p5: {len(out)} of {len(images)} frames came back, or out of order")
    first = sizes[0] - 1
    span = max(arrived.values()) - arrived[first]
    return {"labels": np.array([f.meta["label_index"] for f in out]), "launches": launches,
            "batches": len(sizes), "kinds": kinds,
            "fps_steady": (len(images) - first - 1) / span if span > 0 else float("nan")}


def run_p5(np, counters, seed: int, card: str, labels, beside=None) -> dict:
    """p5: path a's pipeline (MAILBOX_AB_FRAMES frames, ``max-batch=128``, the
    decoder's device half fused) on the port's ``queue.Queue`` mailboxes and
    on the port's ``NativeMailbox`` (the JAX package's default, the core
    built with g++ here: a missing g++ fails), in MAILBOX_AB_PAIRS
    alternating pairs in this process (native first in even pairs,
    ``queue.Queue`` first in odd ones): labels equal across the runs (and to
    path a's on the same frames where it ran), ``normalize_u8`` and
    ``top1`` once per micro-batch in each; frames/s after the first
    micro-batch of each run, and the pairs' ratios."""
    from nnstreamer_tpu_torch.native import runtime

    t = time.perf_counter()
    if not runtime.available():
        raise AssertionError("p5: the native core did not build (g++)")
    build_s = time.perf_counter() - t
    text = labeling_text(MOBILENET_CUSTOM, seed, labels)
    images = np.random.default_rng(seed).integers(0, 256, (MAILBOX_AB_FRAMES, 224, 224, 3),
                                                  dtype=np.uint8)
    runs = {"native": [], "queue": []}
    for pair in range(MAILBOX_AB_PAIRS):
        for kind in (("native", "queue") if pair % 2 == 0 else ("queue", "native")):
            runs[kind].append(mailbox_run(np, counters, text, images, kind == "native"))
    ref = runs["queue"][0]
    if beside is not None and len(beside["labels"]) >= MAILBOX_AB_FRAMES and not np.array_equal(
            ref["labels"], beside["labels"][:MAILBOX_AB_FRAMES]):
        raise AssertionError("p5: labels differ from path a's on the same frames")
    for kind, want in (("native", {"NativeMailbox"}), ("queue", {"Queue"})):
        for r in runs[kind]:
            if set(r["kinds"].values()) != want:
                raise AssertionError(f"p5 {kind}: mailboxes {r['kinds']} (want {want})")
            if not np.array_equal(r["labels"], ref["labels"]):
                raise AssertionError(f"p5 {kind}: labels differ from the first queue.Queue run's")
            b = r["batches"]
            if r["launches"]["normalize_u8"] != b or r["launches"]["top1"] != b:
                raise AssertionError(f"p5 {kind}: launches {r['launches']} for {b} micro-batches")
    fps = {k: [r["fps_steady"] for r in v] for k, v in runs.items()}
    ratios = [n / q for n, q in zip(fps["native"], fps["queue"])]
    print(f"path p: p5 MobileNet-v2 {MAILBOX_AB_FRAMES} frames, {MAILBOX_AB_PAIRS} alternating "
          f"pairs in this process (core built in {build_s:.1f} s; {len(ref['kinds'])} "
          f"mailboxes): frames/s after the first micro-batch on queue.Queue "
          f"{[round(v, 1) for v in fps['queue']]}, on NativeMailbox "
          f"{[round(v, 1) for v in fps['native']]}; native / queue.Queue per pair "
          f"{[round(v, 4) for v in ratios]}, median {statistics.median(ratios):.4f}; labels "
          f"equal{' and equal to path a' if beside is not None else ''}; normalize_u8 and top1 "
          f"once per micro-batch in every run (host clock, findings only); on {card}",
          flush=True)
    return {"launches": ref["launches"], "batches": ref["batches"],
            "fps_steady_native": fps["native"], "fps_steady_queue": fps["queue"],
            "ratio_median": statistics.median(ratios)}


def iio_tree(np, root: Path, seed: int):
    """A fake sysfs IIO tree under `root`: channel 0 ``le:s12/16>>4`` (scale
    0.5, offset 2), channel 1 ``be:u16/16``, IIO_FRAMES x IIO_SAMPLES seeded
    records; returns (base dir, dev dir, the float32 (frames, 2, samples)
    a numpy decode of the bytes gives)."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    dev = root / "sys" / "iio:device0"
    (dev / "scan_elements").mkdir(parents=True)
    (dev / "buffer").mkdir()
    (dev / "name").write_text("card_accel\n")
    (dev / "in_accel_x_scale").write_text("0.5")
    (dev / "in_accel_x_offset").write_text("2")
    for name, idx, spec in (("in_accel_x", 0, "le:s12/16>>4"), ("in_accel_y", 1, "be:u16/16")):
        (dev / "scan_elements" / f"{name}_en").write_text("1")
        (dev / "scan_elements" / f"{name}_index").write_text(str(idx))
        (dev / "scan_elements" / f"{name}_type").write_text(spec)
    (dev / "buffer" / "enable").write_text("0")
    n = IIO_FRAMES * IIO_SAMPLES
    raw = np.zeros(n, np.dtype([("x", "<u2"), ("y", ">u2")]))
    rng = np.random.default_rng(seed + 41)
    raw["x"], raw["y"] = rng.integers(0, 1 << 16, n), rng.integers(0, 1 << 16, n)
    (root / "dev").mkdir()
    (root / "dev" / "iio:device0").write_bytes(raw.tobytes())
    x = (raw["x"].astype(np.int64) >> 4) & 0xFFF
    x = np.where(x >= 2048, x - 4096, x)
    xs = ((x.astype(np.float64) + 2.0) * 0.5).astype(np.float32).reshape(IIO_FRAMES, IIO_SAMPLES)
    ys = raw["y"].astype(np.float32).reshape(IIO_FRAMES, IIO_SAMPLES)
    return root / "sys", root / "dev", np.stack([xs, ys], axis=1)


def run_p6(torch, np, counters, seed: int, card: str, work, labels) -> dict:
    """p6: ``cli.launch.main`` in process on ``videotestsrc`` (USER_FRAMES random
    frames) ``! tensor_converter ! tensor_filter framework=torch-cuda`` (path
    a's MobileNet-v2) ``! tensor_decoder ! tensor_sink``: exit 0, launches
    once per invoke; then the same text through ``python -m
    nnstreamer_tpu_torch.cli.launch`` in a child process, exiting 0 in its
    timeout; then
    ``tensor_src_iio`` on a fake sysfs tree in the work directory, its
    values equal to a numpy decode of the bytes."""
    import nnstreamer_tpu_torch.pipeline as pipeline_pkg
    from nnstreamer_tpu_torch.cli import launch

    text = (f"videotestsrc num-buffers={USER_FRAMES} pattern=random seed={seed} ! "
            f"tensor_converter ! tensor_filter name=f framework=torch-cuda model=mobilenet_v2 "
            f"custom={MOBILENET_CUSTOM},seed:{seed} max-batch=128 batch-timeout=20 ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! tensor_sink name=out "
            f"max-stored=1")
    made = []
    parse = pipeline_pkg.parse_pipeline
    counters.zero()
    t0 = time.perf_counter()
    with mock.patch.object(pipeline_pkg, "parse_pipeline",
                           lambda *a, **k: made.append(parse(*a, **k)) or made[-1]):
        rc = launch.main(["-q", "--timeout", "300", text])
    wall = time.perf_counter() - t0
    launches = counters.read()
    b = made[0]["f"].invokes if made else 0
    if rc != 0 or not b or launches["normalize_u8"] != b or launches["top1"] != b:
        raise AssertionError(f"p6: launch.main returned {rc}; launches {launches} for {b} invokes")
    t = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch.cli.launch", "-q",
                            "--timeout", "300", text], cwd=ROOT, timeout=400,
                           capture_output=True, text=True)
    child_s = time.perf_counter() - t
    if child.returncode != 0:
        raise AssertionError(f"p6: python -m nnstreamer_tpu_torch.cli.launch exited "
                             f"{child.returncode}:\n{child.stderr[-3000:]}")
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    base, dev, want = iio_tree(np, work / "iio", seed)
    pipe = parse_pipeline(f"tensor_src_iio device=card_accel iio-base-dir={base} dev-dir={dev} "
                          f"buffer-capacity={IIO_SAMPLES} num-buffers={IIO_FRAMES} "
                          "poll-timeout=500 ! tensor_sink name=out")
    pipe.start()
    try:
        pipe.wait(timeout=60)
    finally:
        pipe.stop()
    got = [np.asarray(f.tensors[0]) for f in pipe["out"].frames]
    if len(got) != IIO_FRAMES or not np.array_equal(np.stack(got), want):
        raise AssertionError(f"p6: tensor_src_iio gave {len(got)} frames, or values that differ "
                             "from the numpy decode")
    print(f"path p: p6 cli.launch in process: {USER_FRAMES} videotestsrc frames in {b} invokes, "
          f"exit 0, normalize_u8 and top1 {launches['top1']} each, {wall:.1f} s; python -m "
          f"nnstreamer_tpu_torch.cli.launch exit 0 in {child_s:.1f} s; tensor_src_iio "
          f"{IIO_FRAMES} frames of 2 x {IIO_SAMPLES} (le:s12/16>>4, be:u16/16) equal to the "
          f"numpy decode; on {card}", flush=True)
    return {"launches": launches, "batches": b, "seconds": wall, "child_s": child_s}


def run_user_filters(torch, np, lab, counters, seed: int, card: str, work, labels,
                     beside=None) -> tuple:
    """Path p: p1-p6 (see their docstrings).  Returns (paths: the launches
    and micro-batches of p1's two auto runs, p2, p5 and p6; the summary)."""
    t0 = time.perf_counter()
    secs = {}
    t = time.perf_counter()
    p1 = run_p1(torch, np, counters, seed, card, work, labels)
    secs["p1"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    p2 = run_p2(torch, np, lab, counters, seed, card, labels)
    secs["p2"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    p3 = run_p3(torch, np, counters, seed, card, work)
    secs["p3"] = time.perf_counter() - t
    t = time.perf_counter()
    p4 = run_p4(np, seed, card, work)
    secs["p4"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    p5 = run_p5(np, counters, seed, card, labels, beside=beside)
    secs["p5"] = time.perf_counter() - t
    t = time.perf_counter()
    p6 = run_p6(torch, np, counters, seed, card, work, labels)
    secs["p6"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    paths = {"auto_tflite_p1": {"launches": p1["tflite"].pop("launches"),
                                "batches": p1["tflite"]["batches"]},
             "auto_onnx_p1": {"launches": p1["onnx"].pop("launches"),
                              "batches": p1["onnx"]["batches"]},
             "custom_easy_p2": {"launches": p2.pop("launches"), "batches": p2["batches"]},
             "native_mailbox_p5": {"launches": p5.pop("launches"), "batches": p5["batches"]},
             "launch_cli_p6": {"launches": p6.pop("launches"), "batches": p6["batches"]}}
    summary = {"card": card, "p1": p1, "p2": p2, "p3": p3, "p4": p4, "p5": p5, "p6": p6,
               "seconds": {k: round(v, 3) for k, v in secs.items()} | {
                   "total": round(time.perf_counter() - t0, 3)}}
    print(f"path p: seconds {summary['seconds']}; on {card}", flush=True)
    return paths, summary


# -- path q: converted and exported models as .pt2 programs --------------------------

EXPORT_FILE_FRAMES = 512      # q1's frames through each program and framework
EXPORT_ZOO_FRAMES = 512       # q2's MobileNet-v2 frames
EXPORT_VIT_FRAMES = 256       # q2's ViT-B/16 frames
EXPORT_INT8_FRAMES = 128      # q2's MobileNet-v2 quantize:int8 frames
EXPORT_SIZES = (1, 7, 128)    # q3's micro-batches of the batch-polymorphic program
EXPORT_FIXED_FRAMES = 7       # q3's micro-batch against the --fixed program
CLI_FRAMES = 16               # q4's frames through each generated filter
ALL_KERNELS = ("normalize_u8", "top1", "flash_attention", "quantize_i8", "int8_conv",
               "int8_dwconv")

#: q5's child: every kernel built into (or found in) NNS_TPU_CUDA_CACHE_DIR,
#: then one micro-batch of 128 frames through a program; prints the nvcc
#: runs and the seconds from its start
CACHE_CHILD = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import numpy as np
import torch
from nnstreamer_tpu_torch.backends.torch_cuda import TorchCuda
from nnstreamer_tpu_torch.ops import _build
imported = time.perf_counter() - t0
_build.build({kernels!r})
built = time.perf_counter() - t0
be = TorchCuda()
be.open({program!r}, {{}})
opened = time.perf_counter() - t0
shape = be.get_model_info()[0].tensors[0].shape
x = np.random.default_rng(0).integers(0, 256, (128, *shape), dtype=np.uint8)
out = be.invoke_batch([x])
torch.cuda.synchronize()
print("Q5 " + json.dumps({{"compiles": _build.COMPILES, "import_s": imported, "build_s": built,
                          "open_s": opened, "first_batch_s": time.perf_counter() - t0,
                          "dir": str(_build._lib_path("top1").parent),
                          "shape": list(out[0].shape)}}))
"""


def start_child(args, env=None) -> subprocess.Popen:
    """A child ``python`` of this checkout, its output captured."""
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish_child(proc, what: str, timeout: float) -> str:
    """The child's standard output once it exited 0; raises otherwise."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: no exit in {timeout:.0f} s") from None
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n{err[-3000:]}")
    return out


def program_text(framework: str, program, labels) -> str:
    return (f"appsrc name=src ! tensor_filter name=f framework={framework} model={program} "
            f"max-batch=128 ! tensor_decoder mode=image_labeling option1={labels} ! "
            f"tensor_sink name=out")


def near_tie_labels(np, name: str, got, want, logits) -> int:
    """`got` labels equal `want` except where the reference's top two logits
    lie within 1e-4 of its largest magnitude (counted); returns the count
    of labels off at near-ties."""
    top = logits.topk(2, dim=1).values
    ties = ((top[:, 0] - top[:, 1]) < 1e-4 * logits.abs().amax(dim=1)).cpu().numpy()
    bad = np.flatnonzero(got != want)
    if not ties[bad].all():
        raise AssertionError(f"{name}: {len(bad)} labels differ from the direct call, "
                             f"{int((~ties[bad]).sum())} of them away from a near-tie")
    return len(bad)


def run_q1(torch, np, lab, q, counters, seed: int, card: str, labels, files, programs,
           graphs) -> dict:
    """q1: path j's uint8 ``.tflite`` converted with ``--int8`` and its
    ``.onnx``, each ``.pt2`` served at ``max-batch=128`` on EXPORT_FILE_FRAMES
    frames pushed in blocks of 128 through ``framework=auto`` and
    ``framework=torch-cuda``: the framework resolved to ``torch-cuda``;
    labels equal to path j's eager graph called directly in the same
    micro-batch sizes (the ``.onnx``: except at counted near-ties); the int8
    kernels' and ``top1``'s launches per micro-batch as path j1's
    (``reckon_file_int8``: the file's reckoning); both frameworks' runs equal;
    ms per 128 frames of each program beside its eager graph (CUDA events)."""
    from nnstreamer_tpu_torch.backends.torch_cuda import ExportedModule

    frames = np.random.default_rng(seed + 31).integers(
        0, 256, (EXPORT_FILE_FRAMES, 1, 224, 224, 3), dtype=np.uint8)
    out, summary = {}, {}
    for kind in ("tflite", "onnx"):
        graph = graphs[kind]
        per_batch = (reckon_file_int8(q, graph.lowering) if kind == "tflite" else
                     {"int8_conv": 0, "int8_dwconv": 0})
        runs = {}
        for fw in ("auto", "torch-cuda"):
            t = time.perf_counter()
            r = block_run(np, counters, program_text(fw, programs[kind], labels), frames)
            r["wall_s"] = time.perf_counter() - t
            if r["framework"] != "torch-cuda":
                raise AssertionError(f"q1 {kind}: framework={fw} resolved {r['framework']}")
            b = len(r["sizes"])
            want, logits = direct_labels(torch, np, lab, graph, frames, r["sizes"])
            if kind == "tflite" and not np.array_equal(r["labels"], want):
                bad = np.flatnonzero(r["labels"] != want)
                raise AssertionError(f"q1 tflite framework={fw}: {len(bad)} labels differ from "
                                     f"path j's graph called directly (first frames {bad[:8]})")
            r["off_at_ties"] = (0 if kind == "tflite" else
                                near_tie_labels(np, f"q1 onnx framework={fw}", r["labels"],
                                                want, logits))
            want_launches = {k: v * b for k, v in per_batch.items()} | {
                "top1": b, "normalize_u8": 0, "quantize_i8": 0, "flash_attention": 0}
            got = {k: r["launches"][k] for k in want_launches}
            if got != want_launches:
                raise AssertionError(f"q1 {kind} framework={fw}: launches {got} in {b} "
                                     f"micro-batches (want {want_launches}: path j1's)")
            runs[fw] = r
        auto, explicit = runs["auto"], runs["torch-cuda"]
        if not np.array_equal(auto["labels"], explicit["labels"]) or \
                auto["launches"] != explicit["launches"] or auto["sizes"] != explicit["sizes"]:
            raise AssertionError(f"q1 {kind}: framework=auto and framework=torch-cuda differ")
        program = auto.pop("module")
        explicit.pop("module")
        if not isinstance(program, ExportedModule):
            raise AssertionError(f"q1 {kind}: the filter runs {type(program).__name__}")
        x = torch.from_numpy(frames[:128]).cuda()
        with torch.inference_mode():
            ms = {"program": time_ms(lambda: program(x), reps=7, inner=3),
                  "eager_graph": time_ms(lambda: graph(x), reps=7, inner=3)}
        del program
        b = len(auto["sizes"])
        out[f"exported_{kind}_q1"] = {"launches": auto["launches"], "batches": b}
        summary[kind] = {"frames": len(frames), "micro_batches": b,
                         "launches_per_micro_batch": {
                             k: auto["launches"][k] // b for k in ("int8_conv", "int8_dwconv",
                                                                   "quantize_i8", "top1")},
                         "wall_s": {fw: r["wall_s"] for fw, r in runs.items()},
                         "labels_off_at_near_ties": auto["off_at_ties"],
                         "ms_per_128": ms, "program_bytes": programs[kind].stat().st_size}
        print(f"path q: q1 {programs[kind].name} ({programs[kind].stat().st_size / 2**20:.1f} "
              f"MiB): framework=auto and torch-cuda, {len(frames)} frames in {b} micro-batches "
              f"each, labels equal to path j's graph"
              + ("" if kind == "tflite" else f" but {auto['off_at_ties']} at near-ties")
              + f"; launches per micro-batch {summary[kind]['launches_per_micro_batch']} as "
              f"path j1's; ms per 128 frames (direct, "
              f"CUDA events) program {ms['program']:.3f}, eager graph {ms['eager_graph']:.3f}; "
              f"wall of each run (start-up included) {runs['auto']['wall_s']:.2f} and "
              f"{runs['torch-cuda']['wall_s']:.2f} s; on {card}", flush=True)
    return {"paths": out, "summary": summary}


def run_q2(torch, np, lab, counters, seed: int, card: str, labels, exported) -> dict:
    """q2: the zoo's MobileNet-v2 (bf16; uint8 frames through ``normalize_u8``,
    the port's counterpart of the JAX zoo's ``pallas:1``), its
    ``quantize:int8`` build (path h1's) and ViT-B/16 (``attn:flash``) saved
    by ``export_model`` (traced on the CPU, loaded onto the card), served
    through ``framework=torch-cuda model=<x>.pt2`` with the labeling decoder
    (EXPORT_ZOO_FRAMES / EXPORT_INT8_FRAMES / EXPORT_VIT_FRAMES frames in
    blocks of 128): labels equal to the module called directly in the same
    micro-batch sizes; ``normalize_u8`` once a call, flash 12 times a call
    (all on the tensor cores), the int8 build's kernels as h1's a call but
    ``quantize_i8`` also once a layer for its weight (a program has no
    weight version to cache on), ``top1`` once, counted from inside the
    program; ms per 128 frames beside the module's; the eager host ms of a
    kernel call through its registered operator beside the wrapper."""
    from nnstreamer_tpu_torch.ops import labeling, preprocess

    out, summary = {}, {}
    layers = int(custom_props(VIT_CUSTOM)["layers"])
    for name, (module, path, export_s, n, per_call) in exported.items():
        frames = np.random.default_rng(seed + 37).integers(0, 256, (n, 224, 224, 3),
                                                           dtype=np.uint8)
        t = time.perf_counter()
        r = block_run(np, counters, program_text("torch-cuda", path, labels), frames)
        wall = time.perf_counter() - t
        b = len(r["sizes"])
        want, _ = direct_labels(torch, np, lab, module, frames, r["sizes"])
        if not np.array_equal(r["labels"], want):
            bad = np.flatnonzero(r["labels"] != want)
            raise AssertionError(f"q2 {name}: {len(bad)} labels differ from the module called "
                                 f"directly (first frames {bad[:8]})")
        want_launches = {k: v * b for k, v in per_call.items()}
        got = {k: r["launches"][k] for k in want_launches}
        if got != want_launches:
            raise AssertionError(f"q2 {name}: launches {got} in {b} micro-batches (want "
                                 f"{want_launches})")
        x = torch.from_numpy(frames[:128]).cuda()
        program = r.pop("module")
        with torch.inference_mode():
            ms = {"program": time_ms(lambda: program(x), reps=7, inner=3),
                  "module": time_ms(lambda: module(x), reps=7, inner=3)}
        del program
        out[f"exported_{name}_q2"] = {"launches": r["launches"], "batches": b}
        summary[name] = {"frames": n, "micro_batches": b, "export_s": export_s,
                         "launches_per_call": per_call, "wall_s": wall, "ms_per_128": ms,
                         "program_bytes": path.stat().st_size}
        print(f"path q: q2 {name} exported in {export_s:.1f} s ({path.stat().st_size / 2**20:.1f} "
              f"MiB): {n} frames in {b} micro-batches, labels equal to the module's, launches "
              f"per call {per_call}; ms per 128 frames (direct, CUDA events) program "
              f"{ms['program']:.3f}, module {ms['module']:.3f}; on {card}", flush=True)
    del layers
    # the eager host cost of the operator's dispatch, beside the wrapper
    x1 = torch.zeros((1, 224, 224, 3), dtype=torch.uint8).cuda()
    logits = torch.zeros((128, 1001), dtype=torch.float32).cuda()
    scale, bias = 2.0 / 255.0, -1.0
    host = {
        "normalize_u8": host_ms(torch, lambda: preprocess.normalize_u8(x1, scale, bias)),
        "normalize_u8_op": host_ms(torch, lambda: torch.ops.nns_torch.normalize_u8(
            x1, scale, bias, torch.bfloat16)),
        "top1_packed": host_ms(torch, lambda: labeling.top1_packed(logits)),
        "top1_packed_op": host_ms(torch, lambda: torch.ops.nns_torch.top1_packed(logits)),
    }
    summary["host_ms_per_call"] = host
    print("path q: q2 eager host ms per call (100 calls behind a device sleep, median of 7): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()) + f"; on {card}", flush=True)
    return {"paths": out, "summary": summary}


def run_q3(torch, np, q, counters, seed: int, card: str, programs, graphs) -> dict:
    """q3: the ``--int8`` batch-polymorphic program through the backend
    (``TorchCuda.invoke_batch``, which pads a micro-batch to a power of two)
    at EXPORT_SIZES frames, and the ``.onnx``'s ``--fixed`` program at
    EXPORT_FIXED_FRAMES: outputs bit-equal to path j's eager graphs on the
    same padded rows; the program called once a micro-batch (the int8
    launches of one call), the fixed one once a (padded) frame, the calls
    counted around the loaded program."""
    from nnstreamer_tpu_torch.backends.torch_cuda import TorchCuda

    per_call = reckon_file_int8(q, graphs["tflite"].lowering)
    frames = np.random.default_rng(seed + 41).integers(0, 256, (128, 1, 224, 224, 3),
                                                       dtype=np.uint8)
    summary = {}
    for kind, sizes in (("polymorphic", EXPORT_SIZES), ("fixed", (EXPORT_FIXED_FRAMES,))):
        graph = graphs["tflite" if kind == "polymorphic" else "onnx"]
        be = TorchCuda()
        be.open(str(programs["tflite" if kind == "polymorphic" else "fixed"]), {})
        program = be._module.__dict__["_gm"]
        seen = []
        be._module.__dict__["_gm"] = lambda *xs: seen.append(1) or program(*xs)
        try:
            for n in sizes:
                bucket = 1 << (n - 1).bit_length()
                counters.zero()
                seen.clear()
                with torch.inference_mode():
                    (got,) = be.invoke_batch([frames[:n]])
                    launches = counters.read()
                    x = torch.from_numpy(frames[:n]).cuda()
                    x = torch.cat([x, x[-1:].expand((bucket - n,) + tuple(x.shape[1:]))])
                    want = (graph(x)[0] if kind == "polymorphic" else
                            torch.stack([graph(x[i])[0] for i in range(bucket)]))[:n]
                if not torch.equal(got, want):
                    raise AssertionError(f"q3 {kind} program at {n} frames differs from path j's "
                                         "graph on the same rows")
                calls = len(seen)
                if calls != (1 if kind == "polymorphic" else bucket):
                    raise AssertionError(f"q3 {kind} at {n} frames: {calls} program calls")
                if kind == "polymorphic" and (launches["int8_conv"] != per_call["int8_conv"]
                                              or launches["int8_dwconv"] != per_call["int8_dwconv"]):
                    raise AssertionError(f"q3 at {n} frames: launches {launches} (want one call "
                                         f"of {per_call})")
                summary[f"{kind}_{n}"] = {"calls": calls, "shape": list(got.shape)}
        finally:
            be.close()
    print(f"path q: q3 the --int8 program at {', '.join(map(str, EXPORT_SIZES))} frames in one "
          f"call each, the .onnx's --fixed one at {EXPORT_FIXED_FRAMES} frames in "
          f"{summary[f'fixed_{EXPORT_FIXED_FRAMES}']['calls']} calls: outputs bit-equal to path "
          f"j's graph; on {card}", flush=True)
    return summary


def run_q4(torch, np, counters, seed: int, card: str, work, labels) -> dict:
    """q4: the port's command-line tools on the card: ``confchk``'s report names
    the card and every kernel library built; ``inspect`` lists 44 element
    classes; path a's text through ``pbtxt`` and back, both texts labeling
    128 frames alike with the same launches; ``codegen --lang c`` built with
    g++ against the port's header and run as ``framework=custom``,
    ``codegen --lang python`` as ``framework=python3``, CLI_FRAMES frames
    each passed through unchanged."""
    import contextlib
    import io

    from nnstreamer_tpu_torch.cli import codegen, confchk, pbtxt
    from nnstreamer_tpu_torch.cli import inspect as inspect_cli
    from nnstreamer_tpu_torch.native import runtime
    from nnstreamer_tpu_torch.pipeline import parse_pipeline
    from nnstreamer_tpu_torch.pipeline.element import ELEMENT_TYPES

    report = confchk.report()
    name = torch.cuda.get_device_name(0)
    missing = [k for k in ALL_KERNELS if f"  {k:<16} built lib{k}-" not in report]
    if name not in report or missing:
        raise AssertionError(f"q4: confchk's report lacks the card {name!r} or the built "
                             f"libraries of {missing}:\n{report[:3000]}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = inspect_cli.main([])
    first = buf.getvalue().splitlines()[0]
    classes = len({c for c in ELEMENT_TYPES.values()
                   if c.__module__.startswith("nnstreamer_tpu_torch.")})
    if rc != 0 or classes != 44 or f"({len(set(ELEMENT_TYPES.values()))} classes)" not in first:
        raise AssertionError(f"q4: inspect returned {rc}, listed {first!r} ({classes} classes)")
    text = labeling_text(MOBILENET_CUSTOM, seed, labels)
    pb = pbtxt.pipeline_text_to_pbtxt(text)
    back = pbtxt.pbtxt_to_pipeline_text(pb)
    if pbtxt.pipeline_text_to_pbtxt(back) != pb:
        raise AssertionError("q4: path a's text through pbtxt and back gives another pbtxt")
    frames = np.random.default_rng(seed + 43).integers(0, 256, (128, 224, 224, 3),
                                                       dtype=np.uint8)
    a, b = (block_run(np, counters, t.replace(" max-batch=128 batch-timeout=20", " max-batch=128"),
                      frames) for t in (text, back))
    if not np.array_equal(a["labels"], b["labels"]) or a["launches"] != b["launches"]:
        raise AssertionError("q4: path a's text and its pbtxt round trip label or launch apart")
    gen = work / "codegen"
    shutil.rmtree(gen, ignore_errors=True)
    cfile, _ = codegen.generate("q_native", "c", str(gen))
    so = gen / "q_native.so"
    cc = subprocess.run(["g++", "-O2", "-fPIC", "-Wall", f"-I{runtime.INCLUDE_DIR}", "-shared",
                         "-o", str(so), cfile], capture_output=True, text=True, timeout=120)
    if cc.returncode != 0:
        raise AssertionError(f"q4: g++ failed on the generated C filter:\n{cc.stderr[-3000:]}")
    (pyfile,) = codegen.generate("q_python", "python", str(gen))
    x = np.random.default_rng(seed + 47).integers(0, 256, (CLI_FRAMES, 3, 224, 224),
                                                  dtype=np.uint8)
    for fw, model in (("custom", so), ("python3", pyfile)):
        pipe = parse_pipeline(f"appsrc name=src ! tensor_filter framework={fw} model={model} ! "
                              "tensor_sink name=out")
        pipe.start()
        try:
            for f in x:
                pipe["src"].push(f)
            pipe["src"].end_of_stream()
            pipe.wait(timeout=120)
        finally:
            pipe.stop()
        got = [np.asarray(f.tensors[0]) for f in pipe["out"].frames]
        if len(got) != CLI_FRAMES or not np.array_equal(np.stack(got), x):
            raise AssertionError(f"q4: the generated {fw} filter did not pass {CLI_FRAMES} "
                                 "frames through unchanged")
    print(f"path q: q4 confchk names {name} and the {len(ALL_KERNELS)} kernel libraries built; "
          f"inspect: {first}; path a's text through pbtxt and back labels 128 frames alike "
          f"({ {k: v for k, v in a['launches'].items() if v} }); codegen C (g++) and Python "
          f"filters pass {CLI_FRAMES} frames through; on {card}", flush=True)
    return {"elements": first, "launches": a["launches"], "batches": len(a["sizes"])}


def check_cache_children(cold: dict, warm: dict, where: Path) -> None:
    if cold["compiles"] != len(ALL_KERNELS) or warm["compiles"] != 0:
        raise AssertionError(f"q5: nvcc ran {cold['compiles']} times in the first child and "
                             f"{warm['compiles']} in the second (want {len(ALL_KERNELS)} and 0)")
    if not cold["dir"] == warm["dir"] == str(where / "kernels"):
        raise AssertionError(f"q5: the children built into {cold['dir']} and {warm['dir']}, not "
                             f"{where / 'kernels'}")


def run_exported(torch, np, lab, counters, seed: int, card: str, work, labels) -> tuple:
    """Path q: q1-q5 (see their docstrings; q5: a child process with a fresh
    ``NNS_TPU_CUDA_CACHE_DIR`` builds every kernel and runs a micro-batch of
    128 frames through the ``--int8`` program, a second child on the same
    directory runs no ``nvcc``; both times to the first micro-batch).  The
    two conversions of q1 run in child processes beside this process's
    exports and its ``--fixed`` conversion.
    Returns (paths: launches and micro-batches of q1, q2 and q4; the summary)."""
    from nnstreamer_tpu_torch.backends._importer_common import ImportedGraph
    from nnstreamer_tpu_torch.backends.torch_cuda import export_model
    from nnstreamer_tpu_torch.importers.onnx_lower import _Lowering as OnnxLowering
    from nnstreamer_tpu_torch.importers.onnx_reader import read_onnx
    from nnstreamer_tpu_torch.importers.tflite_lower import _Lowering
    from nnstreamer_tpu_torch.importers.tflite_reader import read_tflite
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.ops import quantize as q

    t0 = time.perf_counter()
    secs = {}
    files = _MODEL_FILES.get(seed) or write_model_files(torch, np, seed, work)[0]
    qdir = work / "exported"
    shutil.rmtree(qdir, ignore_errors=True)
    qdir.mkdir(parents=True)
    programs = {"tflite": qdir / "mobilenet_v2_uint8_int8.pt2",
                "onnx": qdir / "mobilenet_v2_float32.pt2",
                "fixed": qdir / "mobilenet_v2_float32_fixed.pt2"}
    convert = ["-m", "nnstreamer_tpu_torch.cli.convert"]
    children = {
        "tflite": start_child(convert + [str(files["uint8"]), str(programs["tflite"]), "--int8"]),
        "onnx": start_child(convert + [str(files["onnx"]), str(programs["onnx"])]),
    }
    # q2's exports (on the CPU) while the converters run
    exported = {}
    t = time.perf_counter()
    for name, custom, n, per_call in (
            ("mobilenet_v2", MOBILENET_CUSTOM, EXPORT_ZOO_FRAMES, {"normalize_u8": 1, "top1": 1}),
            ("mobilenet_v2_int8", INT8_CUSTOM, EXPORT_INT8_FRAMES, {
                "normalize_u8": 1, "top1": 1, "int8_conv": MOBILENET_INT8["int8_conv"],
                "int8_dwconv": MOBILENET_INT8["int8_dwconv"],
                "quantize_i8": MOBILENET_INT8["quantize_i8"]}),
            ("vit", VIT_CUSTOM, EXPORT_VIT_FRAMES, {
                "flash_attention": int(custom_props(VIT_CUSTOM)["layers"]),
                "flash_attention_tensor_cores": int(custom_props(VIT_CUSTOM)["layers"]),
                "top1": 1, "normalize_u8": 0})):
        props = custom_props(custom) | {"seed": str(seed)}
        module, in_spec, _ = build(props.pop("arch"), props)
        module.eval()
        if "quantize_i8" in per_call:  # the program quantizes each layer's weight a call
            per_call["quantize_i8"] += len(quant_layers(module))
        te = time.perf_counter()
        path = qdir / f"{name}.pt2"
        export_model(module, [(s.shape, s.dtype) for s in in_spec.tensors], str(path))
        exported[name] = (module.cuda(), path, time.perf_counter() - te, n, per_call)
    secs["q2_exports"] = time.perf_counter() - t
    # q3's --fixed program: the same CLI, in this process, while the
    # children convert; of the .onnx, whose float graph traces in a fraction
    # of the int8 one's time
    from nnstreamer_tpu_torch.cli import convert as convert_cli

    t = time.perf_counter()
    if convert_cli.main([str(files["onnx"]), str(programs["fixed"]), "--fixed"]):
        raise AssertionError("q3: nns-tpu-torch-convert --fixed returned non-zero")
    secs["q3_convert"] = time.perf_counter() - t
    # path j's eager graphs on the card: q1's and q3's reference
    low = _Lowering(read_tflite(str(files["uint8"])), int8_compute=True)
    graphs = {"tflite": ImportedGraph(low, low.params(), [4], low.int8_params()).cuda().eval()}
    olow = OnnxLowering(read_onnx(str(files["onnx"])))
    graphs["onnx"] = ImportedGraph(olow, olow.params(), [4]).cuda().eval()
    for kind, proc in children.items():
        finish_child(proc, f"q1 nns-tpu-torch-convert ({kind})", timeout=600)
    secs["q1_converts"] = time.perf_counter() - t0
    cache = qdir / "kernel_cache"
    cache_env = dict(os.environ, NNS_TPU_CUDA_CACHE_DIR=str(cache))
    child_src = CACHE_CHILD.format(root=str(ROOT), kernels=list(ALL_KERNELS),
                                   program=str(programs["tflite"]))
    t_cold = time.perf_counter()
    cold_proc = start_child(["-c", child_src], env=cache_env)
    t = time.perf_counter()
    q1 = run_q1(torch, np, lab, q, counters, seed, card, labels, files, programs, graphs)
    secs["q1"] = time.perf_counter() - t
    cold = json.loads(finish_child(cold_proc, "q5 first child", 900).split("Q5 ", 1)[1])
    cold["wall_s"] = time.perf_counter() - t_cold
    t_warm = time.perf_counter()
    warm_proc = start_child(["-c", child_src], env=cache_env)
    t = time.perf_counter()
    q2 = run_q2(torch, np, lab, counters, seed, card, labels, exported)
    del exported
    torch.cuda.empty_cache()
    secs["q2"] = time.perf_counter() - t
    t = time.perf_counter()
    q3 = run_q3(torch, np, q, counters, seed, card, programs, graphs)
    secs["q3"] = time.perf_counter() - t
    del graphs
    torch.cuda.empty_cache()
    t = time.perf_counter()
    q4 = run_q4(torch, np, counters, seed, card, work, labels)
    secs["q4"] = time.perf_counter() - t
    warm = json.loads(finish_child(warm_proc, "q5 second child", 600).split("Q5 ", 1)[1])
    warm["wall_s"] = time.perf_counter() - t_warm
    check_cache_children(cold, warm, cache)
    print(f"path q: q5 a child with a fresh NNS_TPU_CUDA_CACHE_DIR ran nvcc {cold['compiles']} "
          f"times, a second on the same directory {warm['compiles']}; seconds from each one's "
          f"start (imports, kernels built or found, {programs['tflite'].name} opened, first "
          "micro-batch of 128 done): "
          + "; ".join(f"{n} " + ", ".join(f"{r[k]:.2f}" for k in (
              "import_s", "build_s", "open_s", "first_batch_s")) for n, r in (("cold", cold),
                                                                             ("warm", warm)))
          + f"; the first while q1 ran, the second while q2-q4 ran; on {card}", flush=True)
    paths = q1["paths"] | q2["paths"] | {"pbtxt_q4": {"launches": q4.pop("launches"),
                                                      "batches": q4.pop("batches")}}
    summary = {"card": card, "q1": q1["summary"], "q2": q2["summary"], "q3": q3, "q4": q4,
               "q5": {"cold": cold, "warm": warm},
               "seconds": {k: round(v, 3) for k, v in secs.items()} | {
                   "total": round(time.perf_counter() - t0, 3)}}
    print(f"path q: seconds {summary['seconds']}; on {card}", flush=True)
    return paths, summary


# -- path r: in-pipeline training ----------------------------------------------------------

TRAIN_SAMPLES = 2048          # r1's training samples per epoch
TRAIN_VALID = 256             # r1's validation samples per epoch
TRAIN_EPOCHS = 3
TRAIN_BATCH = 32
TRAIN_LR = 1e-3
TRAIN_VAL_FLOOR = 0.9         # r1: the last epoch's validation accuracy at least this
TRAIN_CPU_ATOL, TRAIN_CPU_RTOL = 1e-3, 1e-2   # r1: first-epoch losses, card against CPU
TRAIN_CKPT_STEPS = 16         # r2's checkpoint grain
TRAIN_KILL_AFTER = 40         # r2: the 41st step raises (after the checkpoint at step 32)
VIT_TRAIN_STEPS = 16          # r3's optimizer steps, each on the same batch
TRAIN_WARM_STEPS = 2          # steps a trainer's step times leave out at the start
VIT_DIRECT_STEPS = 20         # r3's direct steps timed outside the trainer
FEED_SAMPLES = 256            # r1's card-tensor feed: samples (8 steps of 32)
FEED_SPIN_S = 2.0             # the default stream's spin before it writes those samples
VIT_TRAIN_BATCH = 32
VIT_TRAIN_LR = 1e-4
# r3: one step's gradients, flash against xla on the same weights, relative L2 of each
# parameter's and of all of them together.  In bf16 each of the two is itself 1.5-3% off
# the float32 gradient (measured on the CPU at 32 and 256 wide), so they may differ by
# the sum; in float32 (batch 2, TF32 off) only the forward's last bits differ.
VIT_GRAD_BF16_RTOL = (6e-2, 3e-2)
VIT_GRAD_F32_RTOL = (1e-4, 1e-4)
SERVE_TRAINED_FRAMES = 64     # r4's frames through each served artifact

TRAIN_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.use_deterministic_algorithms(True)
import chip_smoke
print("R2 " + json.dumps(chip_smoke.resume_child({work!r}, {seed})))
"""


def mnist_bands(np, n: int, seed: int):
    """The JAX trainer's synthetic MNIST-shaped task (class = the brightest
    of 10 row bands), `n` (image, label) pairs from `seed`."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        label = i % 10
        img = rng.normal(0.2, 0.05, (28, 28, 1)).astype(np.float32)
        img[label * 2:label * 2 + 3, :, :] += 0.8
        yield img, np.int64([label])


def write_mnist_repo(np, work: Path, seed: int) -> tuple:
    """r1's repo through ``appsrc ! datareposink``; (data, meta, config)."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    d = work / "training"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    data, meta, cfg = d / "mnist.bin", d / "mnist.json", d / "mnist_cnn.json"
    pipe = parse_pipeline(f"appsrc name=src ! datareposink location={data} json={meta}")
    pipe.start()
    try:
        for img, label in mnist_bands(np, TRAIN_SAMPLES + TRAIN_VALID, seed):
            pipe["src"].push([img, label])
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    cfg.write_text(json.dumps({
        "arch": "mnist_cnn", "arch_props": {"dtype": "float32", "classes": "10",
                                            "seed": str(seed)},
        "optimizer": "adam", "learning_rate": TRAIN_LR, "batch_size": TRAIN_BATCH}))
    return data, meta, cfg


def mnist_train_text(data, meta, cfg, seed: int, epochs: int, extra: str = "") -> str:
    return (f"datareposrc location={data} json={meta} epochs={epochs} is-shuffle=true "
            f"shuffle-seed={seed} ! tensor_trainer name=t framework=torch model-config={cfg} "
            f"num-inputs=1 num-labels=1 num-training-samples={TRAIN_SAMPLES} "
            f"num-validation-samples={TRAIN_VALID} epochs={epochs} {extra} ! tensor_sink name=out")


def run_trainer(text: str, pushes=(), fail: bool = False) -> dict:
    """Run a training pipeline to its end: the stats frames with their
    arrival times, the backend's sample ledger and the element's health;
    with `fail`, the run must end in the trainer's error."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline
    from nnstreamer_tpu_torch.pipeline.element import ElementError

    pipe = parse_pipeline(text)
    arrivals = []
    pipe["out"].connect_new_data(lambda f: arrivals.append(time.perf_counter()))
    t = time.perf_counter()
    pipe.start()
    try:
        for frame in pushes:
            pipe["src"].push(frame)
        if pushes:
            pipe["src"].end_of_stream()
        try:
            pipe.wait(timeout=600)
        except ElementError as e:
            if not fail:
                raise
            error = str(e)
        else:
            if fail:
                raise AssertionError(f"the faulted training run ended without an error: {text}")
            error = None
        wall = time.perf_counter() - t
        be = pipe["t"].backend
        ends = list(be.step_ends)
        if ends:
            ends[-1].synchronize()
        out = {"stats": [f.tensors[0].tolist() for f in pipe["out"].frames],
               "arrivals": arrivals, "wall_s": wall, "error": error,
               "step_ms": [a.elapsed_time(b) for a, b in zip(ends, ends[1:])],
               "trained_log": list(be.trained_log), "module": be.module,
               "health": pipe["t"].health_info()}
    finally:
        pipe.stop()
    return out


def spread(np, ms: list) -> dict:
    """Median, least and most of per-step times after the warm-up steps."""
    steady = ms[TRAIN_WARM_STEPS - 1:]
    return {"median_ms": float(np.median(steady)), "min_ms": float(min(steady)),
            "max_ms": float(max(steady)), "steps": len(steady)}


def spread_text(sp: dict) -> str:
    return (f"{sp['median_ms']:.3f} ms a step (median of {sp['steps']}, "
            f"{sp['min_ms']:.3f}-{sp['max_ms']:.3f})")


def state_leaves(torch, tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in state_leaves(torch, tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in state_leaves(torch, x)]
    return []


def resume_child(work: str, seed: int) -> dict:
    """r2, in a child process whose parent set deterministic algorithms and
    ``CUBLAS_WORKSPACE_CONFIG``: r1's run uninterrupted, killed by
    ``FAULTS`` at ``trainer.step`` after the checkpoint at step 32 and
    resumed, and torn at ``trainer.checkpoint.commit`` of step 32 and
    resumed.  The resumed runs' final weights, optimizer state and model
    file must be bit-identical to the uninterrupted run's, the replay skip
    equal to the cursor's stream position, and every (epoch, sample) trained
    exactly once in the uninterrupted run's order."""
    import torch

    from nnstreamer_tpu_torch.core import checkpoint as ckpt
    from nnstreamer_tpu_torch.core.resilience import FAULTS

    if not torch.are_deterministic_algorithms_enabled():
        raise AssertionError("r2: the child runs with deterministic algorithms on")
    d = Path(work) / "training"
    data, meta, cfg = d / "mnist.bin", d / "mnist.json", d / "mnist_cnn.json"
    steps = TRAIN_EPOCHS * (TRAIN_SAMPLES // TRAIN_BATCH)

    def run(name: str, resume: bool = False, fail: bool = False) -> dict:
        extra = (f"checkpoint-path={d / ('ck_' + name)} checkpoint-steps={TRAIN_CKPT_STEPS} "
                 f"model-save-path={d / (name + '.pt')} resume={str(resume).lower()}")
        return run_trainer(mnist_train_text(data, meta, cfg, seed, TRAIN_EPOCHS, extra),
                           fail=fail)

    def final(name: str) -> tuple:
        path = str(d / ("ck_" + name))
        if ckpt.latest_step(path) != steps:
            raise AssertionError(f"r2 {name}: newest durable step {ckpt.latest_step(path)}, "
                                 f"want {steps}")
        state = ckpt.restore_state(path, steps)
        model = torch.load(d / (name + ".pt"), weights_only=True)
        return state_leaves(torch, state) + state_leaves(torch, model)

    t0 = time.perf_counter()
    control = run("control")
    want = final("control")
    out = {"control_s": control["wall_s"], "leaves": len(want)}
    for site, after, durable in (("trainer.step", TRAIN_KILL_AFTER, 32),
                                 ("trainer.checkpoint.commit", 1, TRAIN_CKPT_STEPS)):
        name = site.split(".")[-1]
        FAULTS.arm(site, exc=RuntimeError(f"r2: injected kill at {site}"), times=1, after=after)
        try:
            killed = run(name, fail=True)
        finally:
            FAULTS.reset()
        path = str(d / ("ck_" + name))
        if ckpt.latest_step(path) != durable:
            raise AssertionError(f"r2 {site}: newest durable step {ckpt.latest_step(path)}, "
                                 f"want {durable}")
        torn = (d / ("ck_" + name) / f"step_{durable + TRAIN_CKPT_STEPS}" / "state.pt").is_file()
        if site.endswith("commit") and not torn:
            raise AssertionError("r2: the torn save left no state file behind its marker")
        cursor = ckpt.load_meta(path, durable)["cursor"]
        resumed = run(name, resume=True)
        h = resumed["health"]
        if h["train_resumes"] != 1 or h["train_replay_skipped"] != cursor["stream_pos"]:
            raise AssertionError(f"r2 {site}: resumes {h['train_resumes']}, replay skipped "
                                 f"{h['train_replay_skipped']}, cursor {cursor['stream_pos']}")
        ledger = killed["trained_log"][:cursor["stream_pos"]] + resumed["trained_log"]
        if ledger != control["trained_log"]:
            raise AssertionError(f"r2 {site}: the samples trained before the checkpoint and "
                                 "after the resume are not the uninterrupted run's, once each")
        got = final(name)
        same = len(got) == len(want) and all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, want))
        if not same:
            raise AssertionError(f"r2 {site}: the resumed run's weights or optimizer state "
                                 "differ from the uninterrupted run's")
        out[name] = {"durable_step": durable, "replay_skipped": h["train_replay_skipped"],
                     "killed_steps_run": killed["health"]["train_steps"],
                     "torn_state_left": torn, "resumed_s": resumed["wall_s"],
                     "bit_identical": same}
    out["seconds"] = time.perf_counter() - t0
    return out


def run_r1(torch, np, counters, seed: int, card: str, work: Path) -> dict:
    """r1: the MNIST CNN (float32, 10 classes) trained through
    ``datareposrc epochs=3 is-shuffle=true ! tensor_trainer framework=torch``
    on 2048 + 256 samples a epoch, batch 32, adam: per-epoch loss and
    accuracy, the validation floor, the first epoch's 64 per-step losses
    against the same run on the CPU, ms per step and the card's busy share."""
    data, meta, cfg = write_mnist_repo(np, work, seed)
    d = data.parent
    per_epoch = TRAIN_SAMPLES // TRAIN_BATCH
    extra = f"checkpoint-path={d / 'ck_r1'} checkpoint-steps={per_epoch}"
    counters.zero()
    card_run = run_trainer(mnist_train_text(data, meta, cfg, seed, TRAIN_EPOCHS, extra))
    launches = counters.read()
    check_launches("r1", launches, {})  # the model scales uint8 itself: no ported kernel
    stats = card_run["stats"]
    if [int(s[0]) for s in stats] != list(range(1, TRAIN_EPOCHS + 1)) or not all(
            np.isfinite(s).all() for s in stats):
        raise AssertionError(f"r1: epoch stats {stats}")
    if stats[-1][4] < TRAIN_VAL_FLOOR:
        raise AssertionError(f"r1: validation accuracy {stats[-1][4]:.4f} < {TRAIN_VAL_FLOOR}")
    arr = card_run["arrivals"]
    step_ms = (arr[-1] - arr[0]) / ((TRAIN_EPOCHS - 1) * per_epoch) * 1e3
    steps = spread(np, card_run["step_ms"])
    busy = whole_run_busy(mnist_train_text(data, meta, cfg, seed, 1))
    cpu_run = run_trainer(mnist_train_text(
        data, meta, cfg, seed, 1,
        f"accelerator=cpu checkpoint-path={d / 'ck_r1_cpu'} checkpoint-steps={per_epoch}"))
    from nnstreamer_tpu_torch.core import checkpoint as ckpt

    got = np.array(ckpt.load_meta(str(d / "ck_r1"), per_epoch)["cursor"]["ep_losses"])
    want = np.array(ckpt.load_meta(str(d / "ck_r1_cpu"), per_epoch)["cursor"]["ep_losses"])
    diff = np.abs(got - want)
    if len(got) != per_epoch or not (diff <= TRAIN_CPU_ATOL + TRAIN_CPU_RTOL * np.abs(want)).all():
        raise AssertionError(f"r1: the card's first-epoch losses are off the CPU's by up to "
                             f"{diff.max():.3g} (losses {got[:4]}... against {want[:4]}...)")
    for s in stats:
        print(f"path r1: epoch {int(s[0])}: training loss {s[1]:.4f} accuracy {s[2]:.4f}, "
              f"validation loss {s[3]:.4f} accuracy {s[4]:.4f}")
    print(f"path r1: MNIST CNN float32 {TRAIN_EPOCHS} epochs of {TRAIN_SAMPLES}+{TRAIN_VALID} "
          f"(batch {TRAIN_BATCH}, adam {TRAIN_LR}): validation accuracy {stats[-1][4]:.4f} >= "
          f"{TRAIN_VAL_FLOOR}; first epoch's {per_epoch} step losses within "
          f"{TRAIN_CPU_ATOL:g} + {TRAIN_CPU_RTOL:g}*|cpu| of the CPU run's (max abs diff "
          f"{diff.max():.3g}, max rel {(diff / np.abs(want)).max():.3g}); {step_ms:.3f} ms per "
          f"step ({1e3 / step_ms:.1f} steps/s, epochs 2-{TRAIN_EPOCHS} by the stats frames' "
          f"arrivals, validation and the data path included); by the trainer's step events "
          f"{spread_text(steps)}; {busy_text(busy)}, a 1-epoch run; whole 3-epoch run "
          f"{card_run['wall_s']:.2f} s; on {card}", flush=True)
    return {"launches": launches, "batches": TRAIN_EPOCHS * per_epoch, "summary": {
        "epochs": stats, "val_accuracy_floor": TRAIN_VAL_FLOOR, "ms_per_step": step_ms,
        "trainer_step_events": steps,
        "steps_per_s": 1e3 / step_ms, "busy_share_1_epoch_run": busy,
        "wall_s": card_run["wall_s"], "cpu_first_epoch_max_abs_diff": float(diff.max()),
        "cpu_first_epoch_max_rel_diff": float((diff / np.abs(want)).max()),
        "cpu_wall_s_1_epoch": cpu_run["wall_s"]}}


def run_card_feed(torch, np, seed: int, card: str, work: Path) -> dict:
    """r1's model fed card tensors: FEED_SAMPLES of r1's samples pushed as
    card tensors that the default stream writes only after a FEED_SPIN_S
    spin (``torch.cuda._sleep``), so a trainer that did not wait for their
    producer would train on unwritten memory.  Per-step losses against the
    same samples pushed as numpy arrays, within r1's CPU tolerance."""
    from nnstreamer_tpu_torch.core import checkpoint as ckpt

    d = work / "training"
    samples = list(mnist_bands(np, FEED_SAMPLES, seed + 26))
    images = np.stack([s[0] for s in samples])
    targets = np.stack([s[1] for s in samples])
    steps = FEED_SAMPLES // TRAIN_BATCH
    losses, pending = {}, None
    for name in ("numpy", "card"):
        if name == "card":
            src = [torch.from_numpy(a).cuda() for a in (images, targets)]
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(int(FEED_SPIN_S * 2e9))  # cycles: 2 s at the H100's top clock
            x, y = (torch.empty_like(a) for a in src)
            x.copy_(src[0])
            y.copy_(src[1])
            written = torch.cuda.Event(enable_timing=True)
            written.record()
            pushes = [[x[i], y[i]] for i in range(FEED_SAMPLES)]
        else:
            pushes = [[images[i], targets[i]] for i in range(FEED_SAMPLES)]
        ck = d / f"ck_feed_{name}"
        shutil.rmtree(ck, ignore_errors=True)
        text = (f"appsrc name=src ! tensor_trainer name=t framework=torch "
                f"model-config={d / 'mnist_cnn.json'} num-inputs=1 num-labels=1 "
                f"num-training-samples={FEED_SAMPLES} epochs=1 checkpoint-path={ck} "
                f"checkpoint-steps={steps} ! tensor_sink name=out")
        if name == "card":
            pending = not written.query()  # still unwritten once the run starts
        run_trainer(text, pushes)
        losses[name] = np.array(ckpt.load_meta(str(ck), steps)["cursor"]["ep_losses"])
    spin_ms = start.elapsed_time(written)
    diff = np.abs(losses["card"] - losses["numpy"])
    if not pending or spin_ms < FEED_SPIN_S * 500:
        raise AssertionError(f"r1 card feed: the samples were written before the trainer "
                             f"started (spin {spin_ms:.1f} ms), so the case shows nothing")
    if len(diff) != steps or not (
            diff <= TRAIN_CPU_ATOL + TRAIN_CPU_RTOL * np.abs(losses["numpy"])).all():
        raise AssertionError(f"r1 card feed: losses {losses['card']} against the numpy "
                             f"feed's {losses['numpy']}")
    print(f"path r1: {FEED_SAMPLES} samples pushed as card tensors that the default stream "
          f"wrote after a {spin_ms:.1f} ms spin (unwritten when the run started): {steps} step "
          f"losses within {TRAIN_CPU_ATOL:g} + {TRAIN_CPU_RTOL:g}*|numpy| of the numpy feed's "
          f"(max abs diff {diff.max():.3g}); on {card}", flush=True)
    return {"spin_ms": spin_ms, "max_abs_diff": float(diff.max()), "steps": steps}


def vit_batch(np, seed: int, n: int, size: int, classes: int) -> tuple:
    rng = np.random.default_rng(seed + 24)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, classes, (n, 1), dtype=np.int32))


def grad_check(torch, np, props: dict, images, labels, rtol: tuple) -> tuple:
    """One step's gradients of ViT-B/16 with ``attn:flash`` against the same
    weights with ``attn:xla``: the largest relative L2 difference of a
    parameter's and that of all of them together; raises above `rtol`'s."""
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.trainer.torch_trainer import make_loss_fn

    x = torch.from_numpy(images).cuda()
    y = torch.from_numpy(labels).cuda()
    grads = []
    for attn in ("flash", "xla"):
        module = build("vit", props | {"attn": attn})[0].cuda().eval()
        loss, _ = make_loss_fn(module, "softmax_ce")([x], [y])
        loss.backward()
        grads.append({n: p.grad.float() for n, p in module.named_parameters()})
        del module
    worst = max(((grads[0][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                for n, g in grads[1].items())
    whole = (torch.cat([(grads[0][n] - g).flatten() for n, g in grads[1].items()]).norm()
             / torch.cat([g.flatten() for g in grads[1].values()]).norm()).item()
    if not (worst <= rtol[0] and whole <= rtol[1]):
        raise AssertionError(f"r3: {props['dtype']} gradients, flash against xla, relative L2 "
                             f"up to {worst:.3g} a parameter (<= {rtol[0]:g}), {whole:.3g} in "
                             f"all (<= {rtol[1]:g})")
    return worst, whole


def profile_vit_steps(torch, np, props: dict, images, labels) -> dict:
    """ViT-B/16 ``attn:flash`` stepped directly, outside the trainer and
    its data path, by the trainer's own step (``make_steps``: loss,
    backward, adam on float32 masters) on a batch already on the card:
    VIT_DIRECT_STEPS steps timed by CUDA events, their peak card memory,
    and over 2 profiled steps the device ms of the flash kernel and of the
    recompute backward's range (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.ops import flash_attention as fa
    from nnstreamer_tpu_torch.trainer.torch_trainer import FloatMasters, make_steps

    module = build("vit", props)[0].cuda().eval()
    opt, train_step, _ = make_steps(FloatMasters(module), {
        "optimizer": "adam", "learning_rate": VIT_TRAIN_LR})
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()

    def step():
        train_step([x], [y])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(VIT_DIRECT_STEPS + 1)]
    ends[0].record()
    for e in ends[1:]:
        step()
        e.record()
    torch.cuda.synchronize()
    direct = spread(np, [a.elapsed_time(b) for a, b in zip(ends, ends[1:])])
    step_ms = direct["median_ms"]
    peak = torch.cuda.max_memory_allocated()
    flash_ms = recompute_ms = None
    for _ in range(2):  # a process's first profile may record no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            time.sleep(0.2)
        rows = prof.key_averages()

        def dev_ms(row):
            return getattr(row, "device_time_total", getattr(row, "cuda_time_total", 0)) / 1e3

        flash = [r for r in rows if "flash_fwd" in r.key]
        rng = [r for r in rows if r.key == fa.RECOMPUTE_RANGE]
        if flash and rng and dev_ms(rng[0]) > 0:
            flash_ms = sum(dev_ms(r) for r in flash) / 2
            recompute_ms = dev_ms(rng[0]) / 2
            break
    del module, opt
    torch.cuda.empty_cache()
    return {"direct_steps": direct, "direct_peak_bytes": peak,
            "flash_forward_ms_per_step": flash_ms, "recompute_backward_ms_per_step": recompute_ms}


def run_r3(torch, np, counters, seed: int, work: Path) -> dict:
    """r3's pipeline: ViT-B/16 (bf16, ``attn:flash``) at full width trained
    8 adam steps through ``appsrc ! tensor_trainer``, each on the same
    seeded batch of 32, with a step checkpoint and a model file: 12 flash
    launches a forward, all on the tensor cores; the loss falling."""
    from nnstreamer_tpu_torch.core import checkpoint as ckpt

    d = work / "training"
    d.mkdir(parents=True, exist_ok=True)
    props = custom_props(VIT_CUSTOM) | {"seed": str(seed)}
    props.pop("arch")
    layers = int(props["layers"])
    cfg = d / "vit.json"
    cfg.write_text(json.dumps({"arch": "vit", "arch_props": props, "optimizer": "adam",
                               "learning_rate": VIT_TRAIN_LR, "batch_size": VIT_TRAIN_BATCH}))
    images, targets = vit_batch(np, seed, VIT_TRAIN_BATCH, int(props["size"]),
                                int(props["classes"]))
    n = VIT_TRAIN_STEPS * VIT_TRAIN_BATCH
    ck_dir, model_file = d / "ck_vit", d / "vit.pt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    text = (f"appsrc name=src ! tensor_trainer name=t framework=torch model-config={cfg} "
            f"num-inputs=1 num-labels=1 num-training-samples={n} epochs=1 "
            f"checkpoint-path={ck_dir} checkpoint-steps={VIT_TRAIN_STEPS} "
            f"model-save-path={model_file} ! tensor_sink name=out")
    pushes = [[images[i % VIT_TRAIN_BATCH], targets[i % VIT_TRAIN_BATCH]] for i in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.zero()
    run = run_trainer(text, pushes)
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated()
    check_launches("r3", launches, {"flash_attention": layers * VIT_TRAIN_STEPS,
                                    "flash_attention_tensor_cores": layers * VIT_TRAIN_STEPS})
    losses = ckpt.load_meta(str(ck_dir), VIT_TRAIN_STEPS)["cursor"]["ep_losses"]
    if len(losses) != VIT_TRAIN_STEPS or not losses[-1] < losses[0]:
        raise AssertionError(f"r3: the loss on the repeated batch did not fall: {losses}")
    return {"props": props, "images": images, "targets": targets, "launches": launches,
            "losses": losses, "module": run["module"], "wall_s": run["wall_s"],
            "steps": spread(np, run["step_ms"]), "peak_bytes": peak,
            "artifacts": {"checkpoint_dir": ck_dir, "model_file": model_file}}


def run_r4(torch, np, lab, counters, seed: int, r3: dict, labels) -> dict:
    """r4: r3's ``checkpoint-path`` directory and ``model-save-path`` file
    served by ``tensor_filter framework=torch-cuda`` with the labeling
    decoder's fused half: labels equal to a direct call on the trained
    module, 12 flash launches and one ``top1`` a micro-batch.  Returns the
    two servings' launches and micro-batches."""
    from nnstreamer_tpu_torch.pipeline import parse_pipeline

    layers, size = int(r3["props"]["layers"]), int(r3["props"]["size"])
    images = np.random.default_rng(seed + 25).integers(
        0, 256, (SERVE_TRAINED_FRAMES, size, size, 3), dtype=np.uint8)
    paths = {}
    for name, model in r3["artifacts"].items():
        pipe = parse_pipeline(
            f"appsrc name=src ! tensor_filter name=f framework=torch-cuda model={model} "
            f"custom={VIT_CUSTOM},seed:{seed + 1} max-batch=32 ! tensor_decoder "
            f"mode=image_labeling option1={labels} ! tensor_sink name=out")
        counters.zero()
        pipe.start()
        try:
            with recording_batches(pipe, "f") as sizes:
                for i in range(SERVE_TRAINED_FRAMES):
                    pipe["src"].push(images[i], pts=float(i))
                pipe["src"].end_of_stream()
                pipe.wait(timeout=600)
            launches = counters.read()
            got = np.array([f.meta["label_index"] for f in pipe["out"].frames])
        finally:
            pipe.stop()
        batches = len(sizes)
        check_launches(f"r4 {name}", launches, {
            "top1": batches, "flash_attention": layers * batches,
            "flash_attention_tensor_cores": layers * batches})
        want = np.concatenate([lab.top1_plain(logits)[0].cpu().numpy() for _, _, logits, _ in
                               direct_batches(torch, r3["module"], images, sizes)])
        if len(got) != SERVE_TRAINED_FRAMES or not np.array_equal(got, want):
            raise AssertionError(f"r4 {name}: served labels differ from the trained module's")
        paths[f"vit_trained_{name}"] = {"launches": launches, "batches": batches}
    return paths


def run_training(torch, np, lab, counters, seed: int, card: str, work: Path, labels) -> tuple:
    """Path r: r1; r3's pipeline; r2's child process beside r3's gradient
    checks and r4 (neither timed); then r3's timed steps alone on the card.
    Returns (paths: launches and batches of r1, r3 and r4's two servings;
    the summary)."""
    t0 = time.perf_counter()
    r1 = run_r1(torch, np, counters, seed, card, work)
    feed = run_card_feed(torch, np, seed, card, work)
    torch.cuda.empty_cache()
    r3 = run_r3(torch, np, counters, seed, work)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child = start_child(["-c", TRAIN_CHILD.format(root=str(ROOT), work=str(work), seed=seed)],
                        env=env)
    props, images, targets = r3["props"], r3["images"], r3["targets"]
    bf16_err = grad_check(torch, np, props, images, targets, VIT_GRAD_BF16_RTOL)
    f32_err = grad_check(torch, np, props | {"dtype": "float32"}, images[:2], targets[:2],
                         VIT_GRAD_F32_RTOL)
    torch.cuda.empty_cache()
    paths = run_r4(torch, np, lab, counters, seed, r3, labels)
    print(f"path r4: r3's checkpoint directory (step {VIT_TRAIN_STEPS}) and model file served "
          f"by torch-cuda with the decoder's fused half: {SERVE_TRAINED_FRAMES} frames each, "
          f"labels equal to the trained module called directly; {props['layers']} flash "
          f"launches and one top1 a micro-batch; on {card}", flush=True)
    r2 = json.loads(finish_child(child, "r2 (deterministic resume child)", 600)
                    .split("R2 ", 1)[1])
    print(f"path r2: deterministic algorithms on, CUBLAS_WORKSPACE_CONFIG=:4096:8 (a child "
          f"process beside r3's gradient checks and r4): killed at trainer.step after step "
          f"{TRAIN_KILL_AFTER} and resumed from step {r2['step']['durable_step']} (replay "
          f"skipped {r2['step']['replay_skipped']}); torn at trainer.checkpoint.commit, resumed "
          f"from step {r2['commit']['durable_step']} (replay skipped "
          f"{r2['commit']['replay_skipped']}): {r2['leaves']} weight, optimizer and model-file "
          f"tensors bit-identical to the uninterrupted run's, every sample trained once in its "
          f"order; child {r2['seconds']:.1f} s of runs; on {card}", flush=True)
    del r3["module"]
    torch.cuda.empty_cache()
    prof = profile_vit_steps(torch, np, props, images, targets)

    def share(ms):
        if ms is None:
            return "not measured"
        return f"{ms:.3f} ms ({ms / prof['direct_steps']['median_ms']:.1%})"

    launches = r3["launches"]
    print(f"path r3: ViT-B/16 bf16 attn:flash {VIT_TRAIN_STEPS} adam steps of {VIT_TRAIN_BATCH} "
          f"through tensor_trainer: losses {[round(v, 4) for v in r3['losses']]}; flash "
          f"launches {launches['flash_attention']} ({props['layers']} a forward, "
          f"{launches['flash_attention_tensor_cores']} on the tensor cores); gradients against "
          f"attn:xla relative L2 up to {bf16_err[0]:.3g} a parameter and {bf16_err[1]:.3g} in "
          f"all (bf16, <= {VIT_GRAD_BF16_RTOL}), {f32_err[0]:.3g} and {f32_err[1]:.3g} (float32 "
          f"batch 2, <= {VIT_GRAD_F32_RTOL}); the trainer's steps by its step events "
          f"{spread_text(r3['steps'])}, peak {r3['peak_bytes'] / 2**30:.2f} GiB in the "
          f"pipeline run ({r3['wall_s']:.2f} s: model build, {VIT_TRAIN_STEPS} steps, "
          f"checkpoint and model file); direct steps outside the trainer (batch on the card, "
          f"no data path) {spread_text(prof['direct_steps'])}, flash forward "
          f"{share(prof['flash_forward_ms_per_step'])}, recompute backward "
          f"{share(prof['recompute_backward_ms_per_step'])} of the direct step's median "
          f"(torch.profiler device time), peak {prof['direct_peak_bytes'] / 2**30:.2f} GiB; "
          f"on {card}", flush=True)
    paths["vit_training"] = {"launches": launches, "batches": VIT_TRAIN_STEPS}
    paths["mnist_training"] = {"launches": r1["launches"], "batches": r1["batches"]}
    summary = {"card": card, "r1": r1["summary"] | {"card_feed": feed}, "r2": r2, "r3": {
        "losses": r3["losses"], "grad_rel_l2_bf16": bf16_err, "grad_rel_l2_f32": f32_err,
        "pipeline_wall_s": r3["wall_s"], "trainer_steps": r3["steps"],
        "trainer_peak_bytes": r3["peak_bytes"], **prof,
        "served": {k: v["batches"] for k, v in paths.items() if k.startswith("vit_trained")}},
        "seconds": round(time.perf_counter() - t0, 3)}
    print(f"path r: {summary['seconds']} s; on {card}", flush=True)
    return paths, summary


def fill_launches(kernels: list, paths: dict) -> None:
    """Each kernel entry's launches from the paths' counted runs: the total,
    by path, by route, the micro-batches of the paths that launched it."""
    for k in kernels:
        by_path = {name: p["launches"][k["name"]] for name, p in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        k["microbatches_by_path"] = {name: p["batches"] for name, p in paths.items()
                                     if by_path[name]}
        k["kernel_ms"] = k["ms"]
        routes = {"quantize_i8": ("onepass", "twopass"), "int8_conv": ("gemm", "gather")}
        for route in routes.get(k["name"], ()):
            k.setdefault("launches_by_route", {})[route] = sum(
                p["launches"][f"{k['name']}_{route}"] for p in paths.values())
        if k["name"] == "flash_attention":
            k["launches_tensor_cores_by_path"] = {
                name: p["launches"]["flash_attention_tensor_cores"] for name, p in paths.items()}


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


def run_only(torch, np, lab, counters, args, card: str, work, labels) -> int:
    """``--only``: the int8 kernels' explicit-pad edges when path j runs, then
    the named paths, each summary a JSON line."""
    from nnstreamer_tpu_torch.ops import quantize as q

    only = {p.strip() for p in args.only.split(",") if p.strip()}
    if not only <= set("ijklmnopqr"):
        raise SystemExit(f"chip_smoke.py: --only takes i, j, k, l, m, n, o, p, q and r, not "
                         f"{sorted(only - set('ijklmnopqr'))}")
    if "j" in only:
        check_pad_edges(torch, q)
        _, files = run_files(torch, np, lab, counters, args.seed, card, work, labels)
        print(json.dumps({"model_files": files}))
    if "i" in only:
        print(json.dumps({"prefix_cache": run_prefix_path(torch, np, counters, args.seed,
                                                          card)["summary"]}))
    if "k" in only:
        print(json.dumps({"supervision": run_supervision(torch, np, lab, counters, args.seed,
                                                         card, work, labels)[1]}))
    if "l" in only:
        print(json.dumps({"observability": run_observability(torch, np, lab, counters,
                                                             args.seed, card, work, labels)[1]}))
    if "m" in only:
        print(json.dumps({"query": run_query(torch, np, lab, counters, args.seed, card, work,
                                             labels)[1]}))
    if "n" in only:
        print(json.dumps({"distributed": run_distributed(torch, np, lab, counters, args.seed,
                                                         card, work, labels)[1]}))
    if "o" in only:
        print(json.dumps({"fleet": run_fleet(torch, np, lab, counters, args.seed, card,
                                             labels)[1]}))
    if "p" in only:
        print(json.dumps({"user_filters": run_user_filters(torch, np, lab, counters, args.seed,
                                                           card, work, labels)[1]}))
    if only & set("qr"):
        # every kernel checked and timed as the whole run does, its launches
        # those of paths q and r
        from nnstreamer_tpu_torch.ops import flash_attention as fa
        from nnstreamer_tpu_torch.ops import preprocess as pre

        kernels = [check_normalize(torch, pre), check_top1(torch, lab), check_flash(torch, fa),
                   *time_int8(torch, q)]
        paths = {}
        if "q" in only:
            q_paths, exported = run_exported(torch, np, lab, counters, args.seed, card, work,
                                             labels)
            paths.update(q_paths)
            print(json.dumps({"exported": exported}))
            torch.cuda.empty_cache()
        if "r" in only:
            r_paths, training = run_training(torch, np, lab, counters, args.seed, card, work,
                                             labels)
            paths.update(r_paths)
            print(json.dumps({"training": training}))
        fill_launches(kernels, paths)
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    print(card)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2048, help="frames through MobileNet-v2")
    ap.add_argument("--vit-frames", type=int, default=1024, help="frames through ViT-B/16")
    ap.add_argument("--prompts", type=int, default=16, help="1024-token prompts through GPT-2 small")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the inputs")
    ap.add_argument("--only", default="",
                    help="comma-separated paths to run alone after the kernel build: i, j, k, l, "
                         "m, n, o, p, q, r (prints their summaries; without it every path runs)")
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

    counters = kernel_counters()
    work = work_dir()
    labels = work / "labels.txt"
    if args.only:
        return run_only(torch, np, lab, counters, args, card, work, labels)
    kernels = [check_normalize(torch, pre), check_top1(torch, lab), check_flash(torch, fa)]

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
    torch.cuda.empty_cache()
    prefix = run_prefix_path(torch, np, counters, args.seed, card)
    paths["gpt2_small_prefix_cache"] = prefix
    file_paths, files = run_files(torch, np, lab, counters, args.seed, card, work, labels)
    paths.update(file_paths)
    torch.cuda.empty_cache()
    supervision_paths, supervision = run_supervision(torch, np, lab, counters, args.seed, card,
                                                     work, labels)
    paths.update(supervision_paths)
    torch.cuda.empty_cache()
    observability_paths, observability = run_observability(torch, np, lab, counters, args.seed,
                                                           card, work, labels)
    paths.update(observability_paths)
    torch.cuda.empty_cache()
    query_paths, query = run_query(torch, np, lab, counters, args.seed, card, work, labels,
                                   beside=paths["mobilenet_v2"])
    paths.update(query_paths)
    torch.cuda.empty_cache()
    beside = {k: {"fps_steady": v["fps_steady"], "latency_ms_p50": v["latency_ms_p50"]}
              for k, v in (("a", paths["mobilenet_v2"]), ("m", query["m1"]))}
    dist_paths, distributed = run_distributed(torch, np, lab, counters, args.seed, card, work,
                                              labels, beside=beside)
    paths.update(dist_paths)
    torch.cuda.empty_cache()
    fleet_paths, fleet = run_fleet(torch, np, lab, counters, args.seed, card, labels)
    paths.update(fleet_paths)
    torch.cuda.empty_cache()
    user_paths, user = run_user_filters(
        torch, np, lab, counters, args.seed, card, work, labels,
        beside=paths["mobilenet_v2"] if args.frames >= MAILBOX_AB_FRAMES else None)
    paths.update(user_paths)
    torch.cuda.empty_cache()
    exported_paths, exported = run_exported(torch, np, lab, counters, args.seed, card, work,
                                            labels)
    paths.update(exported_paths)
    torch.cuda.empty_cache()
    training_paths, training = run_training(torch, np, lab, counters, args.seed, card, work,
                                            labels)
    paths.update(training_paths)
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
    print(json.dumps({"prefix_cache": prefix.pop("summary")}))
    print(json.dumps({"model_files": files}))
    print(json.dumps({"supervision": supervision}))
    print(json.dumps({"observability": observability}))
    print(json.dumps({"query": query}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"user_filters": user}))
    print(json.dumps({"exported": exported}))
    print(json.dumps({"training": training}))

    fill_launches(kernels, paths)
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
