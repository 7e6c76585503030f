"""Configuration: an ini file with environment-variable overrides.

A reduced copy of ``nnstreamer_tpu/core/config.py`` (the reference's
``nnstreamer_conf``): the same ``nnstreamer_tpu.ini`` candidates
(``$NNS_TPU_CONF``, ``./nnstreamer_tpu.ini``,
``~/.config/nnstreamer_tpu.ini``), the first existing one read, and
``NNS_TPU_<SECTION>_<KEY>`` overrides unless ``[common] enable_envvar`` is
false.  The port reads ``[model-repo] path`` (``core/model_uri.py``); the
framework priorities and the filter's module list wait for ROADMAP A12.
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import List, Optional

_ENV_PREFIX = "NNS_TPU_"
_lock = threading.RLock()
_parser: Optional[configparser.ConfigParser] = None


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
    global _parser
    with _lock:
        if _parser is not None and not force and path is None:
            return
        cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
        for p in [path] if path else _candidate_paths():
            if p and os.path.isfile(p):
                cp.read(p)
                break
        _parser = cp


def reset() -> None:
    """Forget the loaded file (the next lookup loads again)."""
    global _parser
    with _lock:
        _parser = None


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
