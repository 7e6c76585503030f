"""Converter subplugins (≙ ext/nnstreamer/tensor_converter/).

Importing registers every external converter in the port's subplugin
registry (kind "converter") under the JAX package's names;
``tensor_converter mode=custom:<name>`` selects one.
"""

from ..core import registry

for _name, _target in (
    ("flexbuf", "serialize:FlexbufConverter"),
    ("flatbuf", "serialize:FlatbufConverter"),
    ("protobuf", "serialize:ProtobufConverter"),
    ("python3", "python3:Python3Converter"),
    ("tokenizer", "tokenizer:TokenizerConverter"),
):
    registry.register_lazy(registry.KIND_CONVERTER, _name,
                           f"nnstreamer_tpu_torch.converters.{_target}")
