"""custom-easy backend: register a plain Python callable as a model.

Port of ``nnstreamer_tpu/backends/custom_easy.py`` (reference:
``tensor_filter_custom_easy.c``, ``NNS_custom_easy_register``): register a
callable under a name and run it with ``framework=custom-easy
model=<name>``.  The callable receives what the filter hands it, as it is:
numpy arrays, or torch tensors on the card; nothing is copied to the host
on its behalf, and what it returns goes on as it is.

One addition of the port, off by default so a callable written for the
JAX package runs unchanged: ``batched=True`` hands the callable whole
micro-batches (every tensor with a leading frame axis) through
``invoke_batch``, so the filter's ``max-batch`` reaches a model that runs
best on a batch (a network on the card) in the sizes the filter forms; a
lone frame goes through as a batch of one.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.types import StreamSpec
from .base import FilterBackend, register_backend

_table_lock = threading.Lock()
_table: Dict[str, Tuple[Callable, Optional[StreamSpec], Optional[StreamSpec], bool]] = {}


def register_custom_easy(
    name: str,
    fn: Callable[[List[Any]], List[Any]],
    in_spec: Optional[StreamSpec] = None,
    out_spec: Optional[StreamSpec] = None,
    *,
    batched: bool = False,
) -> None:
    """≙ NNS_custom_easy_register.  `in_spec`/`out_spec` are one frame's
    schemas (None = derived: the output schema then equals the input's)."""
    with _table_lock:
        _table[name] = (fn, in_spec, out_spec, bool(batched))


def unregister_custom_easy(name: str) -> bool:
    """≙ NNS_custom_easy_unregister."""
    with _table_lock:
        return _table.pop(name, None) is not None


class CustomEasy(FilterBackend):
    NAME = "custom-easy"

    def __init__(self):
        super().__init__()
        self._fn: Optional[Callable] = None
        self._in: Optional[StreamSpec] = None
        self._out: Optional[StreamSpec] = None
        self._batched = False

    def open(self, model_path, props):
        super().open(model_path, props)
        with _table_lock:
            entry = _table.get(model_path or "")
        if entry is None:
            raise FileNotFoundError(f"custom-easy function {model_path!r} is not registered")
        self._fn, self._in, self._out, self._batched = entry

    def close(self) -> None:
        self._fn = None

    def get_model_info(self):
        return self._in, self._out

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        # untyped callables default to the same schema
        return self._out if self._out is not None else in_spec

    @property
    def supports_batch(self) -> bool:
        return self._batched

    def invoke(self, inputs: List[Any]) -> List[Any]:
        assert self._fn is not None
        if self._batched:
            return [o[0] for o in self.invoke_batch([a[None] for a in inputs])]
        return self._fn(list(inputs))

    def invoke_batch(self, inputs: List[Any]) -> List[Any]:
        if not self._batched:
            return super().invoke_batch(inputs)
        assert self._fn is not None
        out = self._fn(list(inputs))
        return list(out) if isinstance(out, (list, tuple)) else [out]


register_backend(CustomEasy)
