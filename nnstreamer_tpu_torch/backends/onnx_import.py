"""onnx: run ``.onnx`` models on the card.

Port of ``nnstreamer_tpu/backends/onnx_import.py``.  The protobuf is read
in-process (``importers/onnx_reader.py``: ``struct``, no ``onnx`` package)
and the graph lowered to torch (``importers/onnx_lower.py``); the
``torch-cuda`` backend's plumbing runs it, a micro-batch folded into the
file's leading dimension as ``tflite`` does (``_importer_common.py``).
"""

from __future__ import annotations

from typing import Optional

from .base import register_backend
from .torch_cuda import TorchCuda


class OnnxBackend(TorchCuda):
    NAME = "onnx"

    def _resolve_model(self, model_path: Optional[str]):
        from ..importers.onnx_lower import _Lowering
        from ..importers.onnx_reader import read_onnx
        from ._importer_common import ImportedGraph, spec_from_shapes

        if not model_path:
            raise ValueError("onnx backend requires model=<file.onnx>")
        model = read_onnx(model_path)
        lowering = _Lowering(model)
        module = ImportedGraph(lowering, lowering.params(),
                               [len(vi.shape) if vi.shape is not None else -1
                                for vi in model.inputs])
        lowering.drop_host_consts()  # the module's buffers hold the weights
        return (module, spec_from_shapes([(vi.shape, vi.dtype) for vi in model.inputs]),
                spec_from_shapes([(vi.shape, vi.dtype) for vi in model.outputs]), False)


register_backend(OnnxBackend)
