"""tensor_src_iio: Linux Industrial-I/O sensors as a tensor stream.

Port of ``nnstreamer_tpu/elements/src_iio.py`` (reference:
``gst/nnstreamer/elements/gsttensor_srciio.c``): enumerates the sysfs IIO
root for the named device (or device number), parses ``scan_elements``
channel specs (``[be|le]:[su]<bits>/<storage>[>><shift>]``), optionally
sets ``sampling_frequency`` and the capture trigger, enables the buffer,
reads raw scan records from the character device, applies per-channel
scale and offset, and pushes float32 tensors: merged into one
``(channels, samples)`` tensor (``merge-channels-data``, the reference
default) or one ``(samples,)`` tensor per channel.  Samples are host data:
the filter downstream stages them to the card.

The sysfs and dev roots are properties (``iio-base-dir``, ``dev-dir``) so
tests and containers can point at a fake tree, as the reference's test
suite does with a dummy sysfs.  A stop or a drain ends a read that is
waiting for data at once.
"""

from __future__ import annotations

import os
import select
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.buffer import TensorFrame
from ..core.lifecycle import pipeline_quiescing
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ..pipeline.element import (
    ElementError,
    Property,
    SourceElement,
    element,
)


class IIOChannel:
    """One scan_elements channel: name, index, and its packed-data spec."""

    def __init__(self, name: str, index: int, type_str: str,
                 scale: float = 1.0, offset: float = 0.0):
        self.name = name
        self.index = index
        self.scale = scale
        self.offset = offset
        # "le:s12/16>>4" — endian : signed bits / storage >> shift
        try:
            endian, rest = type_str.strip().split(":", 1)
            sign = rest[0]
            bits_s, _, shift_s = rest[1:].partition(">>")
            used_s, _, storage_s = bits_s.partition("/")
            self.endian = "<" if endian == "le" else ">"
            self.signed = sign == "s"
            self.bits = int(used_s)
            self.storage_bits = int(storage_s)
            self.shift = int(shift_s) if shift_s else 0
        except (ValueError, IndexError):
            raise ElementError(f"bad IIO channel type {type_str!r}") from None
        if self.storage_bits % 8 or self.storage_bits not in (8, 16, 32, 64):
            raise ElementError(f"unsupported storage bits {self.storage_bits}")

    @property
    def storage_bytes(self) -> int:
        return self.storage_bits // 8

    def decode(self, raw: np.ndarray) -> np.ndarray:
        """raw: uint array of storage width -> float32 applying
        shift/mask/sign/scale/offset (reference conversion order)."""
        v = raw.astype(np.uint64) >> np.uint64(self.shift)
        # align the used bits to the top, then shift back down: logical for
        # unsigned, arithmetic (via int64 view) for signed — masks AND
        # sign-extends any width up to 64 without Python-int overflow
        up = np.uint64(64 - self.bits)
        u = v << up
        if self.signed:
            val = u.view(np.int64) >> np.int64(up)
        else:
            val = u >> up
        return ((val.astype(np.float64) + self.offset) * self.scale).astype(
            np.float32
        )


def _read(path: str, default: Optional[str] = None) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return default


def _write(path: str, value: str) -> bool:
    try:
        with open(path, "w") as f:
            f.write(value)
        return True
    except OSError:
        return False


@element("tensor_src_iio")
class TensorSrcIIO(SourceElement):
    PROPERTIES = {
        "mode": Property(str, "continuous", "continuous | one-shot"),
        "device": Property(str, "", "IIO device name"),
        "device-number": Property(int, -1, "IIO device number (alternative)"),
        "trigger": Property(str, "", "trigger name to attach (optional)"),
        "trigger-number": Property(
            int, -1, "trigger by index: attaches 'trigger<N>' (≙ reference "
            "trigger-number; -1 = unset)"
        ),
        "silent": Property(bool, True, "suppress per-buffer logs"),
        "channels": Property(str, "auto", "auto | all | comma list of names"),
        "buffer-capacity": Property(int, 1, "samples per output frame"),
        "frequency": Property(int, 0, "sampling frequency to set (0 = keep)"),
        "merge-channels-data": Property(
            bool, True, "one (channels, samples) tensor vs per-channel tensors"
        ),
        "poll-timeout": Property(int, 10000, "read timeout, ms"),
        "num-buffers": Property(int, -1, "stop after N frames (-1 = forever)"),
        "iio-base-dir": Property(str, "/sys/bus/iio/devices", "sysfs root"),
        "dev-dir": Property(str, "/dev", "character-device root"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._device_dir: Optional[str] = None
        self._dev_path: Optional[str] = None
        self._chans: List[IIOChannel] = []
        self._frame_bytes = 0

    # -- bring-up -----------------------------------------------------------
    def _find_device(self) -> Tuple[str, str]:
        base = self.props["iio-base-dir"]
        want_name = self.props["device"]
        want_num = self.props["device-number"]
        if not os.path.isdir(base):
            raise ElementError(f"{self.name}: no IIO sysfs at {base}")
        for entry in sorted(os.listdir(base)):
            if not entry.startswith("iio:device"):
                continue
            num = int(entry[len("iio:device"):])
            d = os.path.join(base, entry)
            devname = _read(os.path.join(d, "name"), "")
            if (want_name and devname == want_name) or (
                not want_name and want_num >= 0 and num == want_num
            ):
                return d, entry
        raise ElementError(
            f"{self.name}: IIO device not found "
            f"(device={want_name!r} number={want_num})"
        )

    def _scan_channels(self, device_dir: str) -> List[IIOChannel]:
        scan = os.path.join(device_dir, "scan_elements")
        if not os.path.isdir(scan):
            raise ElementError(f"{self.name}: {scan} missing (unbuffered device)")
        sel = self.props["channels"]
        explicit = (
            {c.strip() for c in sel.split(",") if c.strip()}
            if sel not in ("auto", "all")
            else None
        )
        chans: List[IIOChannel] = []
        for fn in sorted(os.listdir(scan)):
            if not fn.endswith("_en"):
                continue
            cname = fn[:-3]
            enabled = _read(os.path.join(scan, fn), "0") == "1"
            if explicit is not None:
                want = cname in explicit
            elif sel == "all":
                want = True
            else:  # auto: keep the device's current enables
                want = enabled
            if not want:
                # a stale enabled channel would corrupt the scan layout the
                # kernel emits vs the one we compute — failing to disable it
                # is fatal, same as failing to enable a wanted one
                if enabled and not _write(os.path.join(scan, fn), "0"):
                    raise ElementError(
                        f"{self.name}: cannot disable channel {cname}"
                    )
                continue
            if not enabled and not _write(os.path.join(scan, fn), "1"):
                raise ElementError(f"{self.name}: cannot enable channel {cname}")
            idx = int(_read(os.path.join(scan, f"{cname}_index"), "0") or 0)
            tstr = _read(os.path.join(scan, f"{cname}_type"))
            if tstr is None:
                raise ElementError(f"{self.name}: {cname}_type missing")
            scale = self._chan_attr(device_dir, cname, "scale", 1.0)
            offset = self._chan_attr(device_dir, cname, "offset", 0.0)
            chans.append(IIOChannel(cname, idx, tstr, scale, offset))
        if not chans:
            raise ElementError(f"{self.name}: no enabled IIO channels")
        chans.sort(key=lambda c: c.index)
        return chans

    @staticmethod
    def _chan_attr(device_dir: str, cname: str, attr: str,
                   default: float) -> float:
        """Per-channel attr with the IIO shared-attr fallback: many devices
        expose one ``in_<type>_scale`` for all components instead of
        ``in_<type>_<comp>_scale`` (the reference falls back the same way)."""
        v = _read(os.path.join(device_dir, f"{cname}_{attr}"))
        if v is None and "_" in cname:
            shared = cname.rsplit("_", 1)[0]
            v = _read(os.path.join(device_dir, f"{shared}_{attr}"))
        try:
            return float(v) if v is not None else default
        except ValueError:
            return default

    def _resolve_trigger(self) -> str:
        """Trigger NAME to write into current_trigger: the `trigger` prop
        verbatim, or — with `trigger-number` — trigger<N>'s sysfs `name`
        file (current_trigger wants the name, not the directory; the dir
        name is the fallback for nameless triggers)."""
        trig = self.props["trigger"]
        if trig or self.props["trigger-number"] < 0:
            return trig
        n = self.props["trigger-number"]
        return _read(
            os.path.join(self.props["iio-base-dir"], f"trigger{n}", "name")
        ) or f"trigger{n}"

    def start(self) -> None:
        self._device_dir, entry = self._find_device()
        self._chans = self._scan_channels(self._device_dir)
        freq = self.props["frequency"]
        if freq > 0:
            _write(os.path.join(self._device_dir, "sampling_frequency"),
                   str(freq))
        trig = self._resolve_trigger()
        if trig:
            if not _write(
                os.path.join(self._device_dir, "trigger", "current_trigger"),
                trig,
            ):
                raise ElementError(f"{self.name}: cannot set trigger {trig!r}")
        # buffered capture on
        _write(os.path.join(self._device_dir, "buffer", "length"),
               str(max(2 * self.props["buffer-capacity"], 2)))
        if not _write(os.path.join(self._device_dir, "buffer", "enable"), "1"):
            raise ElementError(
                f"{self.name}: cannot enable IIO buffer (missing trigger?)"
            )
        self._dev_path = os.path.join(self.props["dev-dir"], entry)
        # kernel scan-record layout (iio_compute_scan_bytes): each element
        # naturally aligned to its own storage size, no trailing pad
        offs: List[int] = []
        pos = 0
        for c in self._chans:
            sb = c.storage_bytes
            pos = (pos + sb - 1) // sb * sb
            offs.append(pos)
            pos += sb
        self._frame_bytes = pos
        self._scan_dtype = np.dtype({
            "names": [c.name for c in self._chans],
            "formats": [
                f"{c.endian}u{c.storage_bytes}" for c in self._chans
            ],
            "offsets": offs,
            "itemsize": self._frame_bytes,
        })

    def stop(self) -> None:
        if self._device_dir:
            _write(os.path.join(self._device_dir, "buffer", "enable"), "0")
        self._device_dir = None

    # -- schema -------------------------------------------------------------
    def output_spec(self) -> StreamSpec:
        cap = self.props["buffer-capacity"]
        if self.props["merge-channels-data"]:
            specs = (
                TensorSpec((len(self._chans), cap), np.float32, "iio"),
            )
        else:
            specs = tuple(
                TensorSpec((cap,), np.float32, c.name) for c in self._chans
            )
        return StreamSpec(specs, FORMAT_STATIC)

    # -- capture ------------------------------------------------------------
    def _read_exact(self, fd: int, nbytes: int) -> Optional[bytes]:
        """Non-blocking read with a real poll-timeout (a blocking chardev
        read would never honor the deadline); None on timeout."""
        deadline = time.monotonic() + self.props["poll-timeout"] / 1000.0
        buf = b""
        while len(buf) < nbytes:
            remain = deadline - time.monotonic()
            if remain <= 0 or pipeline_quiescing(self):
                return None
            r, _, _ = select.select([fd], [], [], min(remain, 0.5))
            if not r:
                continue
            try:
                chunk = os.read(fd, nbytes - len(buf))
            except BlockingIOError:
                continue
            if chunk:
                buf += chunk
            else:
                # EOF on a regular file (fake sysfs): no more data will come
                time.sleep(0.01)
        return buf

    def frames(self) -> Iterator[TensorFrame]:
        cap = self.props["buffer-capacity"]
        merge = self.props["merge-channels-data"]
        limit = self.props["num-buffers"]
        count = 0
        t0 = time.monotonic()
        fd = os.open(self._dev_path, os.O_RDONLY | os.O_NONBLOCK)
        try:
            while limit < 0 or count < limit:
                raw = self._read_exact(fd, self._frame_bytes * cap)
                if raw is None:
                    if not self.props["silent"]:
                        self.log.info("IIO read timeout/EOF; ending stream")
                    return
                rec = np.frombuffer(raw, dtype=self._scan_dtype)
                cols = [
                    c.decode(rec[c.name].astype(np.uint64))
                    for c in self._chans
                ]
                pts = time.monotonic() - t0
                tensors = [np.stack(cols)] if merge else cols
                count += 1
                yield TensorFrame(tensors, pts=pts)
                if self.props["mode"] == "one-shot":
                    return
        finally:
            os.close(fd)
