"""Decoder subplugins.  Importing registers every ported decoder mode."""

from ..core import registry

for _mode, _target in (
    ("image_labeling", "image_label:ImageLabeling"),
    ("bounding_boxes", "bounding_box:BoundingBoxes"),
    ("pose_estimation", "pose:PoseEstimation"),
    ("image_segment", "segment:ImageSegment"),
):
    registry.register_lazy(registry.KIND_DECODER, _mode, f"nnstreamer_tpu_torch.decoders.{_target}")
