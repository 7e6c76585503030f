"""nnstreamer_tpu_torch — the PyTorch/CUDA port of nnstreamer_tpu.

A second package beside ``nnstreamer_tpu`` that runs the same streaming
pipelines on an NVIDIA GPU (Hopper, ``sm_90a``).  Module layout and names
follow the JAX package, so each module here has its counterpart there;
every TPU kernel on a ported path is a hand-written CUDA kernel under
``csrc/``.  This package imports ``torch`` and numpy, never JAX and never
``nnstreamer_tpu``.

Ported so far: image labeling (MobileNet-v2, ViT), transformer-LM
scoring, detection, pose and segmentation through ``tensor_filter
framework=torch-cuda``; KV-cache generation (``generate:<N>`` through
the filter, ``tensor_generator`` streaming one request at a time or
continuous batching with ``slots=N``); the stream elements; and media,
audio and text in and out (file sources, converter subplugins, host
decoders, model files and ``model://`` repositories, the KWS CNN)::

    appsrc ! tensor_filter framework=torch-cuda model=zoo
        custom=arch:mobilenet_v2 max-batch=128 !
    tensor_decoder mode=image_labeling ! tensor_sink
"""

__version__ = "0.1.0"

from .core import StreamSpec, TensorFrame, TensorSpec  # noqa: F401


def __getattr__(name):  # lazy: the element registry loads on first use
    if name == "parse_pipeline":
        from .pipeline import parse_pipeline

        return parse_pipeline
    raise AttributeError(name)
