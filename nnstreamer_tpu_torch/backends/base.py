"""Filter-backend ABI: the pluggable model-runner contract.

Port of ``nnstreamer_tpu/backends/base.py``: ``open/close``,
``get_model_info``/``set_input_info``, ``invoke`` (one frame) and
``invoke_batch`` (a leading batch dim), the staging hooks of the filter's
ingest lane (``SUPPORTS_STAGING``, ``to_device``, ``staging_placement``),
plus the accelerator wish-list parser and backend registration in the
subplugin registry.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core import registry
from ..core.types import StreamSpec


def parse_accelerator(text: Optional[str]) -> Tuple[bool, List[str]]:
    """Parse "true:gpu,cpu" / "cpu" / "false" accelerator strings into
    (enabled, ordered wish list)."""
    if not text:
        return True, ["auto"]
    head, sep, rest = text.strip().partition(":")
    if not sep:  # a bare wish list ("cpu", "gpu.1")
        head, rest = "true", head
    enabled = head.strip().lower() not in ("false", "0", "no", "off")
    wishes = [w.strip() for w in rest.split(",") if w.strip()] or ["auto"]
    return enabled, wishes


class FilterBackend:
    """Base class for filter backends (≙ tensor_filter_subplugin).

    Lifecycle: ``open(model, props)`` once → ``invoke``/``invoke_batch`` per
    frame/batch → ``close()``.
    """

    NAME = "base"

    #: True when :meth:`to_device` performs a real placement (a COPY off
    #: the staging buffer): the filter's ingest lane only engages then.
    #: Host-resident backends keep the default: their "device tensors"
    #: would alias the reusable staging memory.
    SUPPORTS_STAGING = False

    def __init__(self):
        self.model_path: Optional[str] = None
        self.custom_props: Dict[str, str] = {}

    def open(self, model_path: Optional[str], props: Dict[str, Any]) -> None:
        self.model_path = model_path
        # "key1:val1,key2:val2" custom-prop dialect (reference `custom` prop)
        for part in str(props.get("custom") or "").split(","):
            if ":" in part:
                k, _, v = part.partition(":")
                self.custom_props[k.strip()] = v.strip()

    def close(self) -> None:
        pass

    def get_model_info(self) -> Tuple[Optional[StreamSpec], Optional[StreamSpec]]:
        """(input schema, output schema) of one frame; None = unknown."""
        return None, None

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        """Given the negotiated input schema, return the output schema."""
        raise NotImplementedError(f"{self.NAME}: cannot derive output schema")

    def invoke(self, inputs: List[Any]) -> List[Any]:
        """Run one frame: list of per-tensor arrays -> list of arrays."""
        raise NotImplementedError

    def invoke_batch(self, inputs: List[Any]) -> List[Any]:
        """Run a micro-batch: each array has a leading batch dim."""
        raise NotImplementedError

    def to_device(self, arrays: List[Any]) -> List[Any]:
        """Place host-staged arrays on this backend's device: the hook the
        filter's ingest lane calls from the LANE thread.  Contract (when
        :attr:`SUPPORTS_STAGING` is True): return only after the contents
        of ``arrays`` are fully copied off, because the caller reuses those
        buffers immediately.  The default is the identity (host backends
        consume host arrays directly), which is why the base class keeps
        ``SUPPORTS_STAGING = False``."""
        return list(arrays)

    def staging_placement(self):
        """Hashable token naming WHERE :meth:`to_device` places staged
        batches.  The staging-buffer pool keys its rings on it (and pins
        the buffers of a CUDA placement), so buffers of one placement are
        never handed to a caller staging for another
        (``core.buffer.DeviceBufferPool``).  ``None`` = no placement
        identity (host backends)."""
        return None

    @property
    def supports_batch(self) -> bool:
        """True if invoke_batch is implemented."""
        return type(self).invoke_batch is not FilterBackend.invoke_batch


def register_backend(cls_or_name, cls=None) -> None:
    """Register a FilterBackend class under its NAME (or a given name)."""
    if cls is None:
        cls, name = cls_or_name, cls_or_name.NAME
    else:
        name = cls_or_name
    registry.register(registry.KIND_FILTER, name, cls)


def find_backend(name: str) -> type:
    return registry.get(registry.KIND_FILTER, name)
