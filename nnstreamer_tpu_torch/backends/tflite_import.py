"""tflite: run ``.tflite`` models on the card.

Port of ``nnstreamer_tpu/backends/tflite_import.py``.  The flatbuffer is
read in-process (``importers/tflite_reader.py``: ``struct``, no TensorFlow)
and the graph lowered to torch (``importers/tflite_lower.py``); the
``torch-cuda`` backend's plumbing runs it (placement, micro-batches padded
to powers of two, fused decoder halves, the ingest lane).  A micro-batch is
one pass over the graph with the frames folded into the file's leading
dimension (``backends/_importer_common.py``).

Custom props:

* ``fake_quant:false``: quantized models skip the requantization at op
  boundaries and keep only its range clamps (default on).
* ``int8:true``: quantized convolutions, depthwise convolutions and dense
  layers run as integer arithmetic on the port's int8 kernels
  (``int8_conv``, ``int8_dwconv``) with the zero-point expansion.
"""

from __future__ import annotations

from typing import Optional

from .base import register_backend
from .torch_cuda import TorchCuda


class TFLiteBackend(TorchCuda):
    NAME = "tflite"

    def _resolve_model(self, model_path: Optional[str]):
        from ..importers.tflite_lower import _Lowering
        from ..importers.tflite_reader import read_tflite
        from ._importer_common import ImportedGraph, spec_from_shapes

        if not model_path:
            raise ValueError("tflite backend requires model=<file.tflite>")
        model = read_tflite(model_path)
        fake_quant = self.custom_props.get("fake_quant", "true").lower() not in (
            "0", "false", "no")
        int8_compute = self.custom_props.get("int8", "").lower() in ("1", "true", "yes")
        lowering = _Lowering(model, fake_quant=fake_quant, int8_compute=int8_compute)
        module = ImportedGraph(lowering, lowering.params(),
                               [len(model.tensors[i].shape) for i in model.inputs],
                               lowering.int8_params())
        lowering.drop_host_consts()  # the module's buffers hold them
        specs = [spec_from_shapes([(model.tensors[i].shape, model.tensors[i].dtype)
                                   for i in idx]) for idx in (model.inputs, model.outputs)]
        return module, specs[0], specs[1], False


register_backend(TFLiteBackend)
