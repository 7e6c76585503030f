"""Model importers: read third-party model files and lower them to torch.

Port of ``nnstreamer_tpu/importers``: ``.tflite`` flatbuffers
(``tflite_reader``, ``tflite_lower``) and ``.onnx`` protobufs
(``onnx_reader``, ``onnx_lower``), read with ``struct`` and numpy alone,
lowered to functions of torch tensors that the ``tflite`` and ``onnx``
filter backends run on the card.
"""

from .tflite_reader import TFLiteModel, read_tflite
from .tflite_lower import lower_tflite
from .onnx_reader import OnnxModel, read_onnx
from .onnx_lower import lower_onnx

__all__ = ["TFLiteModel", "read_tflite", "lower_tflite",
           "OnnxModel", "read_onnx", "lower_onnx"]
