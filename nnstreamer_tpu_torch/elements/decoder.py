"""tensor_decoder: tensor stream -> labels via decoder subplugins.

Port of ``nnstreamer_tpu/elements/decoder.py``.  Decoder subplugins
register under registry kind "decoder" with the contract::

    class MyDecoder:
        NAME = "my_mode"
        def set_options(self, options: list[str]) -> None: ...
        def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec: ...
        def decode(self, frame: TensorFrame, in_spec) -> TensorFrame: ...

and, to be fusable, a device half ``device_fn`` (runs inside the upstream
filter's backend call) with its host finisher ``decode_fused``.
"""

from __future__ import annotations

from .. import decoders as _decoders  # noqa: F401 — registers decoder modes
from ..core import registry
from ..core.buffer import BatchFrame
from ..core.types import ANY
from ..pipeline.element import ElementError, Property, TransformElement, element

_N_OPTIONS = 9  # reference carries option1..option9


@element("tensor_decoder")
class TensorDecoder(TransformElement):
    BATCH_AWARE = True  # splits blocks itself (or keeps them whole, fused)

    PROPERTIES = {
        "mode": Property(str, "", "decoder subplugin name"),
        **{
            f"option{i}": Property(str, "", f"mode-specific option {i}")
            for i in range(1, _N_OPTIONS + 1)
        },
        "device-fused": Property(
            str, "auto",
            "auto = let the pipeline fold this decoder's device half into the "
            "upstream filter's backend call; never = always decode on host"),
        "split-batches": Property(
            bool, True,
            "fan incoming BatchFrames out to per-frame decodes (false = decode "
            "the block vectorized and pass it downstream whole)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._dec = None
        self._fused = False  # set by the pipeline's device-fusion pass

    @property
    def can_fuse_device(self) -> bool:
        if (
            self._dec is None
            or not hasattr(self._dec, "device_fn")
            or not hasattr(self._dec, "decode_fused")
            or self.props["device-fused"] == "never"
        ):
            return False
        # a subplugin may have a device half for some of its modes only
        supports = getattr(self._dec, "supports_device_fn", None)
        return supports() if callable(supports) else True

    def enable_fused(self) -> None:
        self._fused = True

    def start(self):
        self._fused = False  # re-fused (or not) by the pass on every start
        mode = self.props["mode"]
        if not mode:
            raise ElementError(f"{self.name}: decoder requires mode=")
        try:
            cls = registry.get(registry.KIND_DECODER, mode)
        except KeyError:
            raise ElementError(f"{self.name}: unknown decoder mode {mode!r}") from None
        self._dec = cls() if isinstance(cls, type) else cls
        if hasattr(self._dec, "set_options"):
            self._dec.set_options([self.props[f"option{i}"] for i in range(1, _N_OPTIONS + 1)])

    def stop(self):
        self._dec = None

    def derive_spec(self, pad=0):
        if self._dec is not None and hasattr(self._dec, "get_out_spec"):
            return self._dec.get_out_spec(self.sink_specs.get(0, ANY))
        return ANY

    def transform(self, frame):
        spec = self.sink_specs.get(0, ANY)
        return (self._dec.decode_fused if self._fused else self._dec.decode)(frame, spec)

    def handle_frame(self, pad, frame):
        # batch-through: the upstream filter hands the whole micro-batch as
        # ONE device-resident BatchFrame; to_host() does the single (tiny,
        # post-device_fn) device->host copy before the split
        if isinstance(frame, BatchFrame):
            spec = self.sink_specs.get(0, ANY)
            if (self._fused and not self.props["split-batches"]
                    and hasattr(self._dec, "decode_fused_batch")):
                return [(0, self._dec.decode_fused_batch(frame, spec))]
            dec = self._dec.decode_fused if self._fused else self._dec.decode
            return [(0, dec(f, spec)) for f in frame.to_host().split()]
        return super().handle_frame(pad, frame)
