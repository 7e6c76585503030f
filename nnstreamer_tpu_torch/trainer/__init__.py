"""Training subsystem: the trainer backend ABI and the PyTorch delegate.

Port of ``nnstreamer_tpu/trainer``.  Reference analog: the
``GstTensorTrainerFramework`` ABI (``nnstreamer_plugin_api_trainer.h:95-196``)
whose reference implementation is NNTrainer (out-of-repo); here the
delegate is PyTorch with ``torch.optim`` (``framework=torch``).
"""

from .base import TrainerBackend, TrainerStatus, find_trainer, register_trainer  # noqa: F401
from . import torch_trainer  # noqa: F401 — registers "torch"
