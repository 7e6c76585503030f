"""Configuration: an ini file with environment-variable overrides.

A reduced copy of ``nnstreamer_tpu/core/config.py`` (the reference's
``nnstreamer_conf``): the same ``nnstreamer_tpu.ini`` candidates
(``$NNS_TPU_CONF``, ``./nnstreamer_tpu.ini``,
``~/.config/nnstreamer_tpu.ini``), the first existing one read, and
``NNS_TPU_<SECTION>_<KEY>`` overrides unless ``[common] enable_envvar`` is
false.  The port reads ``[model-repo] path`` (``core/model_uri.py``),
``[framework-priority] <ext>`` (``framework_priority``, which
``framework=auto`` consults) and ``[cuda] cache_dir`` (the kernels' build
directory, ``core/compile_cache.py``).  The JAX package's docstring names a
``[filter] modules`` list, but no JAX code reads it, so the port has none.
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

_ENV_PREFIX = "NNS_TPU_"
_lock = threading.RLock()
_parser: Optional[configparser.ConfigParser] = None
_loaded_from: Optional[str] = None


def _candidate_paths() -> List[str]:
    paths = []
    env = os.environ.get("NNS_TPU_CONF")
    if env:
        paths.append(env)
    paths.append(os.path.abspath("./nnstreamer_tpu.ini"))
    paths.append(os.path.expanduser("~/.config/nnstreamer_tpu.ini"))
    return paths


def load(path: Optional[str] = None, *, force: bool = False) -> None:
    """Load the ini file (the first existing candidate).  Idempotent unless
    `force` or a `path` is given."""
    global _parser, _loaded_from
    with _lock:
        if _parser is not None and not force and path is None:
            return
        cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
        src = None
        for p in [path] if path else _candidate_paths():
            if p and os.path.isfile(p):
                cp.read(p)
                src = p
                break
        _parser = cp
        _loaded_from = src


def reset() -> None:
    """Forget the loaded file (the next lookup loads again)."""
    global _parser, _loaded_from
    with _lock:
        _parser = None
        _loaded_from = None


def loaded_from() -> Optional[str]:
    """The ini file the configuration came from (None: defaults only)."""
    load()
    return _loaded_from


def get_value(section: str, key: str, default: Optional[str] = None) -> Optional[str]:
    """A config value, the env override ``NNS_TPU_<SECTION>_<KEY>`` first
    (reference: ``nnsconf_get_custom_value_string``)."""
    load()
    with _lock:
        enabled = _parser.get("common", "enable_envvar", fallback="true")
        if enabled.strip().lower() in ("1", "true", "yes", "on"):
            env = os.environ.get(f"{_ENV_PREFIX}{section}_{key}".upper().replace("-", "_"))
            if env is not None:
                return env
        return _parser.get(section, key, fallback=default)


def get_bool(section: str, key: str, default: bool = False) -> bool:
    v = get_value(section, key, None)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def get_int(section: str, key: str, default: int = 0) -> int:
    v = get_value(section, key, None)
    return default if v is None else int(v)


def get_list(section: str, key: str) -> List[str]:
    """A comma- or semicolon-separated config value as a list."""
    v = get_value(section, key, None)
    if not v:
        return []
    return [s.strip() for s in v.replace(";", ",").split(",") if s.strip()]


def framework_priority(model_ext: str) -> List[str]:
    """Backend priority for a model file extension: ``[framework-priority]
    <ext>`` (or ``NNS_TPU_FRAMEWORK_PRIORITY_<EXT>``) when set, else the
    port's defaults (reference: the ini's ``framework_priority_<ext>``,
    ``tensor_filter_common.c:1171-1196``).  ``torch-cuda`` loads a ``.pt``
    only as a zoo family's state_dict (``framework=auto`` skips it without
    ``custom=arch:``), so a bare TorchScript archive goes to ``torch``."""
    ext = model_ext.lstrip(".").lower()
    pri = get_list("framework-priority", ext)
    if pri:
        return pri
    defaults: Dict[str, List[str]] = {
        "tflite": ["tflite"],
        "onnx": ["onnx"],
        "py": ["python3"],
        "so": ["custom"],
        "pt": ["torch-cuda", "torch"],
        "pth": ["torch-cuda", "torch"],
        "pt2": ["torch-cuda"],
    }
    return defaults.get(ext, [])
