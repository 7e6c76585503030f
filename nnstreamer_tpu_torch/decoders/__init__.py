"""Decoder subplugins.  Importing registers every ported decoder mode."""

from ..core import registry

registry.register_lazy(
    registry.KIND_DECODER, "image_labeling",
    "nnstreamer_tpu_torch.decoders.image_label:ImageLabeling")
