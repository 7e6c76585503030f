"""tensor_converter: media stream -> typed tensor stream.

Port of ``nnstreamer_tpu/elements/converter.py``.  Raw media payloads
(a byte buffer with a ``meta["media"]`` :class:`MediaInfo`) are framed on
the host as the reference does: video stride removal (rows padded to 4
bytes -> packed (H, W, C)), audio sample framing ((N, channels) per the
sample format), text fixed-size framing (pad/truncate to ``input-dim``
bytes), octet reshaping per ``input-dim``/``input-type``.  Tensor
payloads (appsrc, videotestsrc) pass through as they are, numpy arrays or
torch tensors on any device, with ``frames-per-tensor`` grouping (3:W:H:1
-> 3:W:H:N, numpy (N, H, W, C); ``torch.stack`` on the tensors' own
device for torch payloads).  Flexible-header byte payloads are decoded.
Anything else goes to a converter subplugin (``converters/``, registry
kind "converter") chosen by ``mode=``: ``custom:<name>`` (or
``custom-code:<name>``), ``custom-script:<script.py>``, or
``custom-script:python3`` with the script in
``$NNS_TPU_CONVERTER_SCRIPT``.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from .. import converters as _converters  # noqa: F401 — registers the subplugins
from ..core import registry
from ..core.buffer import BatchFrame, TensorFrame, _is_torch, as_array, stack_tensors
from ..core.types import (
    ANY,
    FORMAT_STATIC,
    StreamSpec,
    TensorSpec,
    dtype_from_name,
    parse_dims_string,
    unpack_flex_header,
)
from ..media.caps import MediaSpec
from ..pipeline.element import Element, ElementError, Property, element


@element("tensor_converter")
class TensorConverter(Element):
    PROPERTIES = {
        "frames-per-tensor": Property(int, 1, "batch N media frames into one tensor"),
        "emit-blocks": Property(
            bool, False,
            "with frames-per-tensor > 1: emit a BatchFrame of N logical frames (per-frame "
            "schema and pts kept; a partial trailing block at EOS is emitted) instead of one "
            "stacked, shape-changed tensor"),
        "input-dim": Property(str, "", "octet mode: target dims (reference dialect)"),
        "input-type": Property(str, "", "octet mode: target element type"),
        "mode": Property(str, "", "external converter: 'custom:<subplugin-name>' or "
                         "'custom-script:<script.py>'"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
        "set-timestamp": Property(bool, True, "stamp arrival-relative pts on frames that "
                                  "carry none (≙ gsttensor_converter set-timestamp)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._pending: List[TensorFrame] = []
        self._sub = None  # the external converter subplugin instance
        self._ts_base = None  # set-timestamp: arrival-time origin

    def start(self):
        self._ts_base = None  # pts restarts with the stream
        mode = self.props["mode"]
        if not mode:
            return
        kind, _, sub = mode.partition(":")
        if kind not in ("custom", "custom-code", "custom-script"):
            raise ElementError(f"{self.name}: unknown converter mode {mode!r}")
        if sub.endswith(".py"):  # the reference's mode=custom-script:<script.py>
            from ..converters.python3 import Python3Converter

            self._sub = Python3Converter(script=sub)
        else:  # a registry name (custom-script:python3 takes the script from the env)
            try:
                cls = registry.get(registry.KIND_CONVERTER, sub)
            except KeyError:
                raise ElementError(f"{self.name}: unknown converter subplugin {sub!r}") from None
            self._sub = cls() if isinstance(cls, type) else cls
        if hasattr(self._sub, "open"):
            self._sub.open()

    def stop(self):
        if self._sub is not None and hasattr(self._sub, "close"):
            self._sub.close()
        self._sub = None
        self._pending.clear()

    # -- negotiation --------------------------------------------------------
    def _octet_spec(self) -> Optional[TensorSpec]:
        if not self.props["input-dim"]:
            return None
        dtype = dtype_from_name(self.props["input-type"] or "uint8")
        return TensorSpec(parse_dims_string(self.props["input-dim"]), dtype)

    def _media_tensor_spec(self, media) -> Optional[TensorSpec]:
        """The static tensor schema of a negotiated media payload."""
        if media.mtype == "video":
            return TensorSpec((media.height, media.width, media.pixel_channels), np.uint8,
                              "video")
        if media.mtype == "audio":
            if media.samples_per_buffer:
                return TensorSpec((media.samples_per_buffer, media.channels),
                                  media.sample_dtype, "audio")
            return None  # per-buffer framing resolved at run time
        if media.mtype == "text":
            octet = self._octet_spec()
            if octet is None:
                raise ElementError(f"{self.name}: text/x-raw needs input-dim= (fixed bytes "
                                   "per frame, reference converter contract)")
            if octet.dtype != np.uint8:
                raise ElementError(f"{self.name}: text/x-raw is uint8 only "
                                   f"(got input-type={self.props['input-type']!r})")
            return octet
        return self._octet_spec()  # octet: None until input-dim is set

    def derive_spec(self, pad=0):
        in_spec = self.sink_specs.get(0, ANY)
        if self._sub is not None and hasattr(self._sub, "get_out_spec"):
            return self._sub.get_out_spec(in_spec)
        fpt = self.props["frames-per-tensor"]
        if isinstance(in_spec, MediaSpec) and in_spec.media is not None:
            t = self._media_tensor_spec(in_spec.media)
            if t is None:
                return ANY
            fr = in_spec.media.framerate
            if fpt > 1 and not self.props["emit-blocks"]:
                t = t.with_batch(fpt)  # one shape-changed frame per group
                if fr is not None:
                    fr = fr / fpt
            return StreamSpec((t,), FORMAT_STATIC, fr)
        octet = self._octet_spec()
        if octet is not None:
            return StreamSpec((octet,), FORMAT_STATIC, in_spec.framerate)
        if self.props["emit-blocks"]:
            fpt = 1  # schema and framerate unchanged: blocks are transparent
        if in_spec.tensors:
            fr = in_spec.framerate
            if fr is not None and fpt > 1:
                fr = fr / fpt
            return StreamSpec(tuple(t.with_batch(fpt) if fpt > 1 else t for t in in_spec.tensors),
                              FORMAT_STATIC, fr)
        return ANY

    # -- processing ---------------------------------------------------------
    def _host_bytes(self, t) -> np.ndarray:
        if _is_torch(t):
            raise ElementError(f"{self.name}: media and octet payloads are host bytes, got a "
                               f"torch tensor on {t.device}")
        return np.asarray(t).reshape(-1).view(np.uint8)

    def _convert_media(self, frame: TensorFrame, media) -> TensorFrame:
        """Frame a raw media payload into its tensor (reference per-type
        chains, gsttensor_converter.c:750-1005)."""
        buf = self._host_bytes(frame.tensors[0])
        if media.mtype == "video":
            h, stride, rb = media.height, media.stride, media.row_bytes
            if len(buf) != h * stride:
                raise ElementError(f"{self.name}: video payload {len(buf)}B != height {h} x "
                                   f"stride {stride}")
            img = buf.reshape(h, stride)[:, :rb].reshape(h, media.width, media.pixel_channels)
            return frame.with_tensors([img])
        if media.mtype == "audio":
            bpf = media.bytes_per_frame
            if len(buf) % bpf:
                raise ElementError(f"{self.name}: audio payload {len(buf)}B not a multiple of "
                                   f"frame size {bpf}B")
            return frame.with_tensors([buf.view(media.sample_dtype).reshape(-1, media.channels)])
        octet = self._octet_spec()
        if media.mtype == "text":
            if octet is None or octet.dtype != np.uint8:
                raise ElementError(f"{self.name}: text/x-raw needs input-dim= (uint8 only)")
            out = np.zeros(octet.nbytes, np.uint8)  # pad with NUL / truncate
            n = min(octet.nbytes, len(buf))
            out[:n] = buf[:n]
            return frame.with_tensors([out.reshape(octet.shape)])
        if octet is None:
            raise ElementError(f"{self.name}: octet payload needs input-dim=/input-type=")
        if len(buf) != octet.nbytes:
            raise ElementError(f"{self.name}: octet payload {len(buf)}B != schema "
                               f"{octet.nbytes}B (set filesrc blocksize accordingly)")
        return frame.with_tensors([buf.view(octet.dtype).reshape(octet.shape)])

    def _convert_one(self, frame: TensorFrame) -> TensorFrame:
        if self._sub is not None:
            out = self._sub.convert(frame)
            return out if isinstance(out, TensorFrame) else frame.with_tensors(out)
        media = frame.meta.get("media")
        if media is not None:
            out = self._convert_media(frame, media)
            out.meta.pop("media", None)  # tensors now, not raw media
            return out
        octet = self._octet_spec()
        if octet is not None:
            raw = self._host_bytes(frame.tensors[0])
            return frame.with_tensors([raw.view(octet.dtype).reshape(octet.shape)])
        return frame.with_tensors([self._flex_or_array(t) for t in frame.tensors])

    @staticmethod
    def _flex_or_array(t):
        """A flexible wire payload (self-describing header + data) as its
        array; any other payload through ``as_array``."""
        if not isinstance(t, (bytes, bytearray, memoryview)):
            return as_array(t)
        spec, off = unpack_flex_header(t)
        return np.frombuffer(t, dtype=spec.dtype, offset=off).reshape(spec.shape)

    def handle_frame(self, pad, frame):
        orig = frame
        frame = self._convert_one(frame)
        if self.props["set-timestamp"] and frame.pts is None:
            # arrival-relative running time for sources that stamp none;
            # never stamped into the input (a subplugin may return it as
            # it is, and tee siblings share it)
            if frame is orig:
                frame = frame.with_tensors(list(frame.tensors))
            if self._ts_base is None:
                self._ts_base = time.monotonic()
            frame.pts = time.monotonic() - self._ts_base
        fpt = self.props["frames-per-tensor"]
        if fpt <= 1:
            return [(0, frame)]
        self._pending.append(frame)
        if len(self._pending) < fpt:
            return []
        return self._emit_group()

    def _emit_group(self):
        group, self._pending = self._pending, []
        stacked = [stack_tensors([f.tensors[i] for f in group])
                   for i in range(len(group[0].tensors))]
        if self.props["emit-blocks"]:
            return [(0, BatchFrame.from_frames(stacked, group))]
        out = group[0].with_tensors(stacked)
        out.duration = sum(f.duration or 0.0 for f in group) or None
        return [(0, out)]

    def handle_eos(self, pad):
        if self.props["emit-blocks"] and self._pending:
            return self._emit_group()  # a partial block changes no schema
        self._pending.clear()  # a partial stacked group is dropped (reference)
        return []
