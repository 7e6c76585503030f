"""Checkpoint/resume for in-pipeline training.

Port of ``nnstreamer_tpu/core/checkpoint.py``: the same layout and
marker-commit protocol, with the state written by ``torch.save`` where the
JAX package writes it with orbax.

Layout: ``<dir>/step_<N>/state.pt`` per checkpoint plus a **completion
marker** ``<dir>/step_<N>.ok`` written atomically *after* the state file
is durable.  A crash mid-save leaves a step dir with no marker;
:func:`latest_step` only ever selects marked steps, so a torn save can
never be resumed (the write/commit split exists so the trainer can
fault-inject the gap between them).  The marker doubles as the
checkpoint's metadata record, a small JSON dict (the trainer stores its
data cursor there), read back via :func:`load_meta`; its format is the JAX
package's, byte for byte.

The state is a tree of tensors in plain containers (dicts, lists, tuples,
numbers), so :func:`restore_state` loads it with ``weights_only=True``.  A
step directory that the JAX package wrote (orbax) holds no ``state.pt``;
:func:`restore_state` refuses it with a message that says so rather than
reading it as something else.
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Any, Dict, Optional

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_MARK_RE = re.compile(r"^step_(\d+)\.ok$")
STATE_FILE = "state.pt"
#: files orbax's StandardCheckpointer leaves in a step directory
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _step_dir(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}")


def _marker_path(path: str, step: int) -> str:
    return _step_dir(path, step) + ".ok"


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-atomic file write: temp sibling in the same directory,
    fsync, then ``os.replace``: a crash at any instant leaves either
    the old complete file or the new complete file, never a torn one
    (the datareposink pattern, shared here so the trainer's model saves,
    state files and checkpoint markers use the one idiom)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    tmp = os.path.join(d, f".{base}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(d)


def to_bytes(obj: Any) -> bytes:
    """``torch.save`` of `obj` into memory (the model file and state format)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def write_state(path: str, step: int, state: Any) -> str:
    """Write checkpoint ``step`` under ``path`` WITHOUT committing it:
    the state file is durable but no marker is written, so
    :func:`latest_step` will not select it until :func:`commit_state`
    runs.  Callers that don't need the split use :func:`save_state`."""
    d = _step_dir(path, step)
    os.makedirs(d, exist_ok=True)
    atomic_write_bytes(os.path.join(d, STATE_FILE), to_bytes(state))
    return d


def commit_state(path: str, step: int,
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomically publish checkpoint ``step`` by writing its completion
    marker (with optional JSON ``meta``: the trainer's data cursor).
    Only after this returns can :func:`latest_step` select the step."""
    marker = _marker_path(path, step)
    payload = dict(meta or {})
    payload["step"] = int(step)
    atomic_write_bytes(marker, json.dumps(payload).encode())
    return marker


def save_state(path: str, step: int, state: Any,
               meta: Optional[Dict[str, Any]] = None) -> str:
    """Save + commit a state tree as checkpoint ``step``; returns the dir."""
    d = write_state(path, step, state)
    commit_state(path, step, meta)
    return d


def latest_step(path: str) -> Optional[int]:
    """Newest COMPLETE (marker-committed) checkpoint step under
    ``path``, or None.  Torn saves (a step dir without its ``.ok``
    marker) are never selected."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        m = _STEP_RE.match(name)
        if (m and os.path.isdir(os.path.join(path, name))
                and os.path.isfile(_marker_path(path, int(m.group(1))))):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load_meta(path: str, step: int) -> Dict[str, Any]:
    """The metadata dict committed with checkpoint ``step`` (empty for
    a missing/unreadable marker: such checkpoints restore with no
    cursor)."""
    try:
        with open(_marker_path(path, step)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def restore_state(path: str, step: int, map_location: Any = "cpu") -> Any:
    """Load checkpoint `step`'s state tree (tensors on `map_location`).
    Raises ``ValueError`` for a step the JAX package wrote with orbax and
    ``FileNotFoundError`` for a step with no state file."""
    d = _step_dir(path, step)
    f = os.path.join(d, STATE_FILE)
    if not os.path.isfile(f):
        if any(os.path.exists(os.path.join(d, n)) for n in _ORBAX_FILES):
            raise ValueError(
                f"{d}: an orbax checkpoint written by the JAX package (nnstreamer_tpu); "
                f"the torch port reads only its own torch.save'd {STATE_FILE}")
        raise FileNotFoundError(f"{d}: no {STATE_FILE} in checkpoint step {step}")
    return torch.load(f, map_location=map_location, weights_only=True)


def prune(path: str, keep: int) -> None:
    """Delete all but the newest `keep` COMPLETE checkpoints.  Torn
    saves (unmarked dirs) and orphaned markers are always removed:
    they can never be resumed, so retaining them only wastes disk."""
    import shutil

    if keep <= 0 or not os.path.isdir(path):
        return
    complete, torn = [], []
    names = os.listdir(path)
    dirs = {int(m.group(1)) for m in map(_STEP_RE.match, names)
            if m and os.path.isdir(os.path.join(path, m.group(0)))}
    marks = {int(m.group(1)) for m in map(_MARK_RE.match, names) if m}
    for s in dirs:
        (complete if s in marks else torn).append(s)
    orphans = sorted(marks - dirs)
    for s in sorted(complete)[:-keep]:
        # marker FIRST: a crash between the two deletes must leave a
        # torn (never-resumed) dir, not a marked dir with no data
        try:
            os.remove(_marker_path(path, s))
        except OSError:
            pass
        shutil.rmtree(_step_dir(path, s), ignore_errors=True)
    for s in torn:
        shutil.rmtree(_step_dir(path, s), ignore_errors=True)
    for s in orphans:
        try:
            os.remove(_marker_path(path, s))
        except OSError:
            pass
