"""Process-wide subplugin registry (a copy of ``nnstreamer_tpu/core/registry.py``;
the port keeps its own table so the two packages never share state).

Reference: ``gst/nnstreamer/nnstreamer_subplugin.c`` — per-kind hash tables
with ``register_subplugin`` (:223), ``get_subplugin`` (:139, which dlopens on
miss), ``get_all_subplugins`` (:174), plus custom-property description lists.

The TPU-native registry keys on the same kinds (filter / decoder / converter /
trainer / custom) but loads Python entry points instead of dlopening shared
objects: a subplugin is any callable/class registered under a name, either
directly (in-process, ≙ custom-easy) or lazily via a module path from the
config search list (≙ the .so search path).
"""

from __future__ import annotations

import importlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

KIND_FILTER = "filter"
KIND_DECODER = "decoder"
KIND_CONVERTER = "converter"
KIND_TRAINER = "trainer"
KIND_CUSTOM = "custom"
KINDS = (KIND_FILTER, KIND_DECODER, KIND_CONVERTER, KIND_TRAINER, KIND_CUSTOM)

_lock = threading.RLock()
_tables: Dict[str, Dict[str, Any]] = {k: {} for k in KINDS}
# name -> "module[:attr]" resolved on first get (lazy, ≙ dlopen-on-demand)
_lazy: Dict[str, Dict[str, str]] = {k: {} for k in KINDS}
# per-subplugin custom property descriptions (reference :254)
_custom_props: Dict[Tuple[str, str], Dict[str, str]] = {}


class SubpluginNotFound(KeyError):
    pass


def register(kind: str, name: str, obj: Any, *, replace: bool = True) -> None:
    """Register a subplugin object under (kind, name).

    Reference: ``register_subplugin`` nnstreamer_subplugin.c:223.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown subplugin kind {kind!r}")
    with _lock:
        if not replace and name in _tables[kind]:
            raise ValueError(f"{kind} subplugin {name!r} already registered")
        _tables[kind][name] = obj


def register_lazy(kind: str, name: str, target: str) -> None:
    """Register a lazily imported subplugin: target = "pkg.module[:attr]"."""
    if kind not in KINDS:
        raise ValueError(f"unknown subplugin kind {kind!r}")
    with _lock:
        _lazy[kind][name] = target


def unregister(kind: str, name: str) -> bool:
    with _lock:
        found = _tables[kind].pop(name, None) is not None
        found = (_lazy[kind].pop(name, None) is not None) or found
        return found


def get(kind: str, name: str) -> Any:
    """Look up a subplugin, importing a lazy target on first use.

    Reference: ``get_subplugin`` nnstreamer_subplugin.c:139 (dlopen on miss).
    """
    with _lock:
        if name in _tables[kind]:
            return _tables[kind][name]
        target = _lazy[kind].get(name)
    if target is None:
        raise SubpluginNotFound(f"no {kind} subplugin named {name!r}")
    mod_name, _, attr = target.partition(":")
    mod = importlib.import_module(mod_name)
    obj = getattr(mod, attr) if attr else mod
    register(kind, name, obj)
    return obj


def get_all(kind: str) -> List[str]:
    """Names of every known subplugin of a kind (registered + lazy).

    Reference: ``get_all_subplugins`` nnstreamer_subplugin.c:174.
    """
    with _lock:
        return sorted(set(_tables[kind]) | set(_lazy[kind]))


def exists(kind: str, name: str) -> bool:
    with _lock:
        return name in _tables[kind] or name in _lazy[kind]


def set_custom_property_desc(kind: str, name: str, desc: Dict[str, str]) -> None:
    """Attach human-readable descriptions of a subplugin's custom properties."""
    with _lock:
        _custom_props[(kind, name)] = dict(desc)


def get_custom_property_desc(kind: str, name: str) -> Optional[Dict[str, str]]:
    with _lock:
        d = _custom_props.get((kind, name))
        return dict(d) if d else None
