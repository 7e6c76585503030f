"""datareposrc / datareposink: the MLOps dataset repository.

Port of ``nnstreamer_tpu/elements/datarepo.py``, with its properties, file
layout and sample order: a repo that either package writes reads and
trains in the other, and the shuffle is the same
``np.random.default_rng(shuffle-seed + epoch).permutation``.  Samples
leave as numpy views of the read buffer, as the JAX element emits them;
the sink takes torch tensors too, card ones included (copied to the host).

Reference: ``gst/datarepo/gstdatareposrc.c`` (props :79-88 — location,
json meta, start/stop-sample-index, epochs, is-shuffle, tensors-sequence)
and ``gstdatareposink.c`` (render :106 writes sample files + JSON meta).

Formats:

* flat binary — one file of fixed-size samples (all tensors of one frame
  concatenated) + JSON meta::

      {"format": "static", "tensors": ["float32:1:28:28", "int64:1"],
       "total_samples": N, "sample_size": bytes}

* image — one decoded file per sample with a printf-style ``location``
  pattern (``img_%04d.png``), meta ``{"format": "image", "total_samples":
  N}`` — ≙ the reference's image media type (samples read via
  pngdec/jpegdec; here ``media/image.py``/Pillow).  The sink picks this
  mode automatically when ``location`` contains a ``%`` pattern and the
  sample is a single uint8 H×W×C tensor.

Deterministic resume comes from sample indices + epochs (reference §5.4);
``is-shuffle`` uses a seeded permutation per epoch so a restarted run
replays the same order.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterator, List, Optional

import numpy as np

from ..core.buffer import TensorFrame, materialize
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ..pipeline.element import ElementError, Property, SinkElement, SourceElement, element

# accepts printf length modifiers (%04ld, %04lld — gstdatareposrc.c
# documents them); Python rejects ll and only ignores single l, so
# _fmt_sample_path strips them before %-formatting
_IMG_PATTERN = re.compile(r"%0?\d*(?:ll?)?d")


def _is_image_pattern(location: str) -> bool:
    """Image mode iff the location holds a printf-style integer pattern
    (``img_%04d.png``); a ``%`` with no ``%d`` pattern stays flat-binary."""
    return bool(_IMG_PATTERN.search(location))


def _fmt_sample_path(location: str, idx: int) -> str:
    """``location % idx`` with stray-% errors surfaced as ElementError
    (a second bare ``%`` in the path makes %-formatting throw)."""
    try:
        return _IMG_PATTERN.sub(
            lambda m: m.group(0).replace("l", ""), location, count=1
        ) % idx
    except (ValueError, TypeError) as e:
        raise ElementError(
            f"bad sample-path pattern {location!r}: {e} (exactly one "
            "%d-style field is supported; escape other percents as %%)"
        ) from None


def _tmp_sibling(path: str) -> str:
    """Temp name in the SAME directory (rename must not cross devices),
    dot-prefixed so printf-pattern scans and shell globs skip it, with
    the real name kept as the SUFFIX so extension-sniffing writers (PIL
    picks the container from the extension) still work."""
    d, base = os.path.split(path)
    return os.path.join(d, f".tmp-{os.getpid()}-{base}")


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_replace(tmp: str, path: str) -> None:
    """fsync + rename: after this returns, `path` is either the old file
    or the COMPLETE new one — a writer killed at any instant can never
    leave a half-written file under the final name."""
    _fsync_path(tmp)
    os.replace(tmp, path)


def _atomic_write_json(path: str, obj) -> None:
    tmp = _tmp_sibling(path)
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@element("datareposink")
class DataRepoSink(SinkElement):
    PROPERTIES = {
        "location": Property(str, "", "data file path"),
        "json": Property(str, "", "meta file path"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._file = None
        self._tmp_location: Optional[str] = None
        self._count = 0
        self._specs: Optional[List[TensorSpec]] = None
        self._sample_size = 0
        self._image_mode = False

    def start(self):
        if not self.props["location"] or not self.props["json"]:
            raise ElementError(f"{self.name}: datareposink needs location= and json=")
        self._image_mode = _is_image_pattern(self.props["location"])
        if self._image_mode:
            self._file = None
            self._tmp_location = None
        else:
            # crash-atomic repo: stream into a temp sibling; stop()
            # fsyncs and renames data THEN meta over the final names, so
            # a killed writer leaves the previous repo untouched and
            # never a half-written sample under the real location
            self._tmp_location = _tmp_sibling(self.props["location"])
            self._file = open(self._tmp_location, "wb")
        self._count = 0
        self._specs = None  # re-derive the schema from the new run's frame 0
        self._sample_size = 0

    def _check_schema(self, arrays) -> None:
        """Every sample must match frame 0 (fixed-stride repo / one image
        schema), in BOTH modes — a mismatched write must fail at write
        time, not at read time mid-training."""
        if self._specs is None:
            self._specs = [TensorSpec(a.shape, a.dtype) for a in arrays]
            self._sample_size = sum(a.nbytes for a in arrays)
            return
        if len(arrays) != len(self._specs) or any(
            tuple(a.shape) != s.shape or a.dtype != s.dtype
            for a, s in zip(arrays, self._specs)
        ):
            got = [f"{a.dtype}{list(a.shape)}" for a in arrays]
            raise ElementError(
                f"{self.name}: sample {self._count} schema {got} differs "
                f"from first sample {[s.to_string() for s in self._specs]}"
            )

    def render(self, frame):
        arrays = [np.ascontiguousarray(a) for a in materialize(frame.tensors)]
        if self._image_mode:
            ok = (
                len(arrays) == 1
                and arrays[0].dtype == np.uint8
                and arrays[0].ndim == 3
                and arrays[0].shape[-1] in (1, 3)
            )
            if not ok:
                # only shapes the src can decode BACK may be written
                raise ElementError(
                    f"{self.name}: image mode writes ONE uint8 (H, W, C) "
                    f"tensor per sample with C in (1, 3), got "
                    f"{[f'{a.dtype}{list(a.shape)}' for a in arrays]}"
                )
            self._check_schema(arrays)
            from ..media.image import write_image

            # per-sample crash atomicity: temp write + fsync + rename —
            # a kill mid-encode leaves a dot-tmp orphan, never a
            # half-encoded image under a sample name the src would read
            path = _fmt_sample_path(self.props["location"], self._count)
            tmp = _tmp_sibling(path)
            write_image(tmp, arrays[0])
            _atomic_replace(tmp, path)
            self._count += 1
            return
        self._check_schema(arrays)
        for a in arrays:
            self._file.write(a.tobytes())
        self._count += 1

    def stop(self):
        if self._image_mode:
            if not self.props["json"]:
                return
            meta = {
                "format": "image",
                "tensors": [s.to_string() for s in (self._specs or [])],
                "total_samples": self._count,
            }
            _atomic_write_json(self.props["json"], meta)
            return
        if self._file is None:
            return
        # publish order matters: data first, meta last — a crash between
        # the two renames leaves old-meta + new-data, and the src's
        # size check (not a decode error deep into an epoch) reports it
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._file = None
        os.replace(self._tmp_location, self.props["location"])
        self._tmp_location = None
        meta = {
            "format": "static",
            "tensors": [s.to_string() for s in (self._specs or [])],
            "total_samples": self._count,
            "sample_size": self._sample_size,
        }
        _atomic_write_json(self.props["json"], meta)


@element("datareposrc")
class DataRepoSrc(SourceElement):
    PROPERTIES = {
        "location": Property(str, "", "data file path"),
        "json": Property(str, "", "meta file path"),
        "start-sample-index": Property(int, 0, "first sample (inclusive)"),
        "stop-sample-index": Property(int, -1, "last sample (inclusive; -1 = end)"),
        "epochs": Property(int, 1, "repeat the range N times"),
        "is-shuffle": Property(bool, False, "seeded shuffle per epoch"),
        "shuffle-seed": Property(int, 0, "determinism for resume"),
        "tensors-sequence": Property(str, "", "reorder tensors, e.g. '1,0'"),
        "caps": Property(str, "", "override announced schema"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._specs: List[TensorSpec] = []
        self._total = 0
        self._sample_size = 0
        self._image_mode = False
        self._truncated_samples = 0  # meta-claimed samples the file lacks

    def start(self):
        if not self.props["location"] or not self.props["json"]:
            raise ElementError(f"{self.name}: datareposrc needs location= and json=")
        if self.props["start-sample-index"] < 0:
            # a negative start would read negative indices (mid-epoch with
            # shuffle on) — fail here, not hours into a run
            raise ElementError(
                f"{self.name}: start-sample-index must be >= 0, got "
                f"{self.props['start-sample-index']}"
            )
        with open(self.props["json"]) as f:
            meta = json.load(f)
        self._specs = [TensorSpec.from_string(s) for s in meta["tensors"]]
        self._total = int(meta["total_samples"])
        self._image_mode = meta.get("format") == "image"
        if self._image_mode:
            if not _is_image_pattern(self.props["location"]):
                raise ElementError(
                    f"{self.name}: image repo needs a printf-style "
                    "location pattern (e.g. img_%04d.png)"
                )
            # completeness check at START (flat mode verifies file size
            # here): a deleted/missing sample must not surface hours into
            # a shuffled training run.  Only the configured index range is
            # checked — pruned repos read with start/stop-sample-index
            # stay valid, and the scan cost is bounded by the range.
            lo = self.props["start-sample-index"]
            hi = self.props["stop-sample-index"]
            hi = self._total - 1 if hi < 0 else min(hi, self._total - 1)
            missing = [
                i for i in range(lo, hi + 1)
                if not os.path.exists(
                    _fmt_sample_path(self.props["location"], i)
                )
            ]
            if missing:
                raise ElementError(
                    f"{self.name}: image repo is missing "
                    f"{len(missing)} of samples [{lo}, {hi}] "
                    f"(first: {_fmt_sample_path(self.props['location'], missing[0])})"
                )
            self._sample_size = 0
            return
        self._sample_size = int(meta["sample_size"])
        self._truncated_samples = 0
        size = os.path.getsize(self.props["location"])
        need = self._total * self._sample_size
        if size < need:
            # a killed writer (or interrupted copy) can leave a repo
            # whose file ends mid-sample.  Detect it HERE and serve the
            # complete prefix with a loud report — not a numpy/short-read
            # crash hours into a shuffled training run, and not a silent
            # epoch of garbage.  Zero complete samples is still fatal.
            complete = size // self._sample_size if self._sample_size else 0
            if complete <= 0:
                raise ElementError(
                    f"{self.name}: data file smaller than meta claims "
                    f"({size} < {self._total}×{self._sample_size}) and "
                    "holds no complete sample"
                )
            trailing = size - complete * self._sample_size
            self._truncated_samples = self._total - complete
            self.log.warning(
                "%s: data file truncated (killed writer?): meta claims %d "
                "samples (%d B) but the file holds %d B — serving the %d "
                "complete sample(s)%s",
                self.name, self._total, need, size, complete,
                f"; {trailing} trailing byte(s) of a partial sample "
                "ignored" if trailing else "",
            )
            self._total = complete

    def health_info(self) -> dict:
        """Repo-integrity accounting merged into ``Pipeline.health()``."""
        return {"truncated_samples": self._truncated_samples}

    def _sequence(self) -> Optional[List[int]]:
        text = self.props["tensors-sequence"]
        if not text:
            return None
        return [int(x) for x in text.split(",") if x.strip()]

    def output_spec(self) -> StreamSpec:
        if self.props["caps"]:
            return StreamSpec.from_string(self.props["caps"])
        specs = self._specs
        seq = self._sequence()
        if seq:
            specs = [specs[i] for i in seq]
        return StreamSpec(tuple(specs), FORMAT_STATIC)

    def _open_reader(self):
        """Native mmap reader when the core is built (one memcpy per
        sample, GIL released, next-sample prefetch — ≙ the reference's C
        reader in gstdatareposrc.c); Python seek/read fallback otherwise.
        Image repos decode one file per sample via media/image.py.

        Returns (read(idx) -> uint8 view, prefetch(idx), close())."""
        if self._image_mode:
            from ..media.image import read_image

            spec = self._specs[0]
            fmt = "GRAY8" if spec.shape[-1] == 1 else "RGB"

            def read_img(idx: int):
                arr = read_image(
                    _fmt_sample_path(self.props["location"], int(idx)), fmt
                )
                if tuple(arr.shape) != tuple(spec.shape):
                    raise ElementError(
                        f"{self.name}: sample {idx} is {list(arr.shape)}, "
                        f"meta says {list(spec.shape)}"
                    )
                return arr.reshape(-1).view(np.uint8)

            return read_img, lambda idx: None, lambda: None
        try:
            from ..native.runtime import SampleReader

            r = SampleReader(self.props["location"], self._sample_size)
            return r.read, r.prefetch, r.close
        except (RuntimeError, OSError):
            f = open(self.props["location"], "rb")

            def read(idx: int):
                f.seek(int(idx) * self._sample_size)
                return np.frombuffer(f.read(self._sample_size), np.uint8)

            return read, lambda idx: None, f.close

    def frames(self) -> Iterator[TensorFrame]:
        start = self.props["start-sample-index"]
        stop = self.props["stop-sample-index"]
        stop = self._total - 1 if stop < 0 else min(stop, self._total - 1)
        if start > stop:
            raise ElementError(f"{self.name}: empty sample range [{start}, {stop}]")
        indices = np.arange(start, stop + 1)
        seq = self._sequence()
        read, prefetch, close = self._open_reader()
        try:
            for epoch in range(max(1, self.props["epochs"])):
                order = indices
                if self.props["is-shuffle"]:
                    rng = np.random.default_rng(self.props["shuffle-seed"] + epoch)
                    order = rng.permutation(indices)
                for i, idx in enumerate(order):
                    if self._pipeline is not None and self._pipeline._stop_flag.is_set():
                        return
                    raw = read(int(idx))
                    if i + 1 < len(order):
                        prefetch(int(order[i + 1]))
                    tensors = []
                    off = 0
                    for spec in self._specs:
                        n = spec.nbytes
                        tensors.append(
                            raw[off : off + n].view(spec.dtype).reshape(spec.shape)
                        )
                        off += n
                    if seq:
                        tensors = [tensors[i] for i in seq]
                    frame = TensorFrame(tensors)
                    frame.meta["sample_index"] = int(idx)
                    frame.meta["epoch"] = epoch
                    yield frame
        finally:
            close()
