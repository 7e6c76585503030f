"""Trainer backend ABI (a copy of ``nnstreamer_tpu/trainer/base.py``).

Reference: ``GstTensorTrainerFramework`` {create, destroy, start, stop,
push_data, getStatus, getFrameworkInfo} + event notifier
(EPOCH_COMPLETION, TRAINING_COMPLETION) —
``nnstreamer_plugin_api_trainer.h:95-196``; status fields epoch_count and
training/validation loss/accuracy (:31-48).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

from ..core import registry
from ..core.buffer import TensorFrame

EVENT_EPOCH_COMPLETION = "epoch-completion"
EVENT_TRAINING_COMPLETION = "training-completion"


@dataclass
class TrainerStatus:
    """≙ GstTensorTrainerStats."""

    epoch_count: int = 0
    training_loss: float = 0.0
    training_accuracy: float = 0.0
    validation_loss: float = 0.0
    validation_accuracy: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "epoch": self.epoch_count,
            "training_loss": self.training_loss,
            "training_accuracy": self.training_accuracy,
            "validation_loss": self.validation_loss,
            "validation_accuracy": self.validation_accuracy,
        }


class TrainerBackend:
    """Lifecycle: create(props) -> start() -> push_data(frame)* ->
    events fire -> stop().  Training runs on the backend's own thread
    (≙ "subplugin spawns training thread", SURVEY §3.4)."""

    NAME = "base"

    def __init__(self):
        self.status = TrainerStatus()
        self._listeners: List[Callable[[str, TrainerStatus], None]] = []

    def add_listener(self, cb: Callable[[str, TrainerStatus], None]) -> None:
        self._listeners.append(cb)

    def notify(self, event: str) -> None:
        """≙ nnstreamer_trainer_notify_event."""
        for cb in list(self._listeners):
            cb(event, self.status)

    # -- ABI ----------------------------------------------------------------
    def create(self, props: Dict[str, Any]) -> None:
        raise NotImplementedError

    def start(self) -> None:
        raise NotImplementedError

    def push_data(self, frame: TensorFrame) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass

    def destroy(self) -> None:
        pass

    def get_status(self) -> TrainerStatus:
        return self.status


def register_trainer(cls) -> None:
    registry.register(registry.KIND_TRAINER, cls.NAME, cls)


def find_trainer(name: str):
    return registry.get(registry.KIND_TRAINER, name)
