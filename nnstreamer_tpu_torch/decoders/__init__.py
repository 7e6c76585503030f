"""Decoder subplugins.  Importing registers every decoder mode of the JAX
package (12 of 12) under its name."""

from ..core import registry

for _mode, _target in (
    ("direct_video", "direct_video:DirectVideo"),
    ("image_labeling", "image_label:ImageLabeling"),
    ("bounding_boxes", "bounding_box:BoundingBoxes"),
    ("pose_estimation", "pose:PoseEstimation"),
    ("image_segment", "segment:ImageSegment"),
    ("tensor_region", "tensor_region:TensorRegion"),
    ("octet_stream", "octet:OctetStream"),
    ("flexbuf", "serialize:FlexbufDecoder"),
    ("flatbuf", "serialize:FlatbufDecoder"),
    ("protobuf", "serialize:ProtobufDecoder"),
    ("python3", "python3:Python3Decoder"),
    ("detokenizer", "detokenizer:Detokenizer"),
):
    registry.register_lazy(registry.KIND_DECODER, _mode, f"nnstreamer_tpu_torch.decoders.{_target}")
