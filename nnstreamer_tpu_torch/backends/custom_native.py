"""custom filter backend: native ``.so`` subplugins over the C ABI.

Port of ``nnstreamer_tpu/backends/custom_native.py`` (reference:
``tensor_filter_custom.c``): dlopens a user shared object implementing the
port's ``native/include/nns_tpu_custom_filter.h`` (the same ABI as the JAX
package's header) through ``ctypes`` and runs it as a model.  The element's
``custom=`` string goes verbatim to ``nns_custom_open``.  The output schema
is the subplugin's static one, else ``nns_custom_set_input_info`` of the
negotiated input, else of the first frame.  Outputs are pre-allocated by
the framework and filled in place.  The subplugin reads host memory: card
tensors cross to the host through ``core.buffer.materialize``, and its
outputs are host numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import materialize
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from .base import FilterBackend

RANK_LIMIT = 16
TENSOR_LIMIT = 16

# nns_tensor_type enum order (native/include/nns_tpu_custom_filter.h,
# matching the reference tensor_typedef.h)
_TYPE_ORDER = (
    np.int32, np.uint32, np.int16, np.uint16, np.int8, np.uint8,
    np.float64, np.float32, np.int64, np.uint64, np.float16,
)
_DTYPE_TO_CODE = {np.dtype(t): i for i, t in enumerate(_TYPE_ORDER)}


class _CSpec(ctypes.Structure):
    _fields_ = [
        ("dtype", ctypes.c_uint32),
        ("rank", ctypes.c_uint32),
        ("dims", ctypes.c_uint64 * RANK_LIMIT),
    ]


class _CMem(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("nbytes", ctypes.c_uint64),
    ]


def _spec_from_c(c: _CSpec) -> TensorSpec:
    return TensorSpec(tuple(int(c.dims[i]) for i in range(c.rank)),
                      np.dtype(_TYPE_ORDER[c.dtype]))


def _spec_to_c(spec: TensorSpec) -> _CSpec:
    c = _CSpec()
    c.dtype = _DTYPE_TO_CODE[np.dtype(spec.dtype)]
    c.rank = len(spec.shape)
    for i, d in enumerate(spec.shape):
        c.dims[i] = int(d)
    return c


def _mems(arrays: List[np.ndarray]):
    c = (_CMem * len(arrays))()
    for i, a in enumerate(arrays):
        c[i].data = a.ctypes.data_as(ctypes.c_void_p)
        c[i].nbytes = a.nbytes
    return c


class CustomNative(FilterBackend):
    NAME = "custom"

    def __init__(self):
        super().__init__()
        self._lib: Optional[ctypes.CDLL] = None
        self._handle: Optional[ctypes.c_void_p] = None
        self._in_spec: Optional[StreamSpec] = None
        self._out_spec: Optional[StreamSpec] = None

    # -- lifecycle ----------------------------------------------------------
    def open(self, model_path: Optional[str], props: Dict[str, Any]) -> None:
        super().open(model_path, props)
        if not model_path or not os.path.isfile(model_path):
            raise FileNotFoundError(
                f"custom backend needs model=<subplugin.so>, got {model_path!r}")
        lib = ctypes.CDLL(os.path.abspath(model_path))
        lib.nns_custom_open.restype = ctypes.c_void_p
        lib.nns_custom_open.argtypes = [ctypes.c_char_p]
        lib.nns_custom_invoke.restype = ctypes.c_int
        lib.nns_custom_invoke.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_CMem), ctypes.c_uint32,
            ctypes.POINTER(_CMem), ctypes.c_uint32]
        lib.nns_custom_close.restype = None
        lib.nns_custom_close.argtypes = [ctypes.c_void_p]
        lib.nns_custom_get_model_info.restype = ctypes.c_int
        lib.nns_custom_get_model_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(_CSpec), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(_CSpec), ctypes.POINTER(ctypes.c_uint32)]
        handle = lib.nns_custom_open(str(props.get("custom") or "").encode())
        if not handle:
            raise RuntimeError(f"{model_path}: nns_custom_open failed")
        self._lib, self._handle = lib, ctypes.c_void_p(handle)
        self._query_model_info()

    def _query_model_info(self) -> None:
        ins = (_CSpec * TENSOR_LIMIT)()
        outs = (_CSpec * TENSOR_LIMIT)()
        n_in = ctypes.c_uint32(0)
        n_out = ctypes.c_uint32(0)
        rc = self._lib.nns_custom_get_model_info(
            self._handle, ins, ctypes.byref(n_in), outs, ctypes.byref(n_out))
        if rc == 0:
            self._in_spec = StreamSpec(
                tuple(_spec_from_c(ins[i]) for i in range(n_in.value)), FORMAT_STATIC)
            self._out_spec = StreamSpec(
                tuple(_spec_from_c(outs[i]) for i in range(n_out.value)), FORMAT_STATIC)

    def close(self) -> None:
        if self._lib is not None and self._handle is not None:
            self._lib.nns_custom_close(self._handle)
        self._lib = self._handle = None

    # -- model info ----------------------------------------------------------
    def get_model_info(self) -> Tuple[Optional[StreamSpec], Optional[StreamSpec]]:
        return self._in_spec, self._out_spec

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        if not hasattr(self._lib, "nns_custom_set_input_info"):
            raise NotImplementedError("custom subplugin lacks nns_custom_set_input_info")
        fn = self._lib.nns_custom_set_input_info
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(_CSpec), ctypes.c_uint32,
                       ctypes.POINTER(_CSpec), ctypes.POINTER(ctypes.c_uint32)]
        ins = (_CSpec * TENSOR_LIMIT)()
        for i, t in enumerate(in_spec.tensors):
            ins[i] = _spec_to_c(t)
        outs = (_CSpec * TENSOR_LIMIT)()
        n_out = ctypes.c_uint32(0)
        rc = fn(self._handle, ins, len(in_spec.tensors), outs, ctypes.byref(n_out))
        if rc != 0:
            raise RuntimeError(f"nns_custom_set_input_info failed (rc={rc})")
        self._out_spec = StreamSpec(
            tuple(_spec_from_c(outs[i]) for i in range(n_out.value)),
            FORMAT_STATIC, in_spec.framerate)
        self._in_spec = in_spec
        return self._out_spec

    # -- execution -----------------------------------------------------------
    def invoke(self, inputs: List[Any]) -> List[Any]:
        arrays = [np.ascontiguousarray(a) for a in materialize(inputs)]
        if self._out_spec is None:
            # negotiation never saw a static schema (e.g. appsrc): derive it
            # from the first frame, like the reference's setInputDimension
            self.set_input_info(StreamSpec(
                tuple(TensorSpec(a.shape, a.dtype) for a in arrays), FORMAT_STATIC))
        outs = [np.empty(t.shape, t.dtype) for t in self._out_spec.tensors]
        rc = self._lib.nns_custom_invoke(
            self._handle, _mems(arrays), len(arrays), _mems(outs), len(outs))
        if rc != 0:
            raise RuntimeError(f"nns_custom_invoke failed (rc={rc})")
        return outs
