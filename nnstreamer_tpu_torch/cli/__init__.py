"""Command-line tools of the port: ``launch`` (the ``gst-launch``
counterpart), ``confchk``, ``inspect``, ``pbtxt``, ``codegen`` and
``convert`` (a ``.tflite`` or ``.onnx`` model to a ``.pt2`` program), each
``python -m nnstreamer_tpu_torch.cli.<tool>`` or ``nns-tpu-torch-<tool>``
(``confchk`` is ``nns-tpu-torch-check``)."""
