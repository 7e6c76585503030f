"""tensor_sparse_enc / tensor_sparse_dec: static <-> sparse stream format.

Port of ``nnstreamer_tpu/elements/sparse.py`` (reference
``gsttensor_sparseenc.c`` / ``gsttensor_sparsedec.c``): each tensor
travels as a (values, linear indices) pair, the dense spec in the frame's
``sparse_specs`` meta.  Sparse payloads are host arrays: a torch tensor
reaching the encoder is copied to the host first.
"""

from __future__ import annotations

from ..core.buffer import materialize
from ..core.types import ANY, FORMAT_FLEXIBLE, StreamSpec, TensorSpec, sparse_decode, sparse_encode
from ..pipeline.element import ElementError, Property, TransformElement, element


@element("tensor_sparse_enc")
class TensorSparseEnc(TransformElement):
    PROPERTIES = {"max-buffers": Property(int, 0, "mailbox depth override")}

    def derive_spec(self, pad=0):
        return StreamSpec((), FORMAT_FLEXIBLE, self.sink_specs.get(0, ANY).framerate)

    def transform(self, frame):
        tensors, specs = [], []
        for t in materialize(frame.tensors):
            values, indices, spec = sparse_encode(t)
            tensors.extend([values, indices])
            specs.append(spec.to_string())
        out = frame.with_tensors(tensors)
        out.meta["sparse_specs"] = specs
        return out


@element("tensor_sparse_dec")
class TensorSparseDec(TransformElement):
    PROPERTIES = {"max-buffers": Property(int, 0, "mailbox depth override")}

    def derive_spec(self, pad=0):
        return ANY  # the concrete shape is restored per buffer from meta

    def transform(self, frame):
        specs = frame.meta.get("sparse_specs")
        if specs is None:
            raise ElementError(f"{self.name}: frame lacks sparse_specs meta")
        if len(frame.tensors) != 2 * len(specs):
            raise ElementError(f"{self.name}: expected {2 * len(specs)} payload tensors, "
                               f"got {len(frame.tensors)}")
        host = materialize(frame.tensors)
        tensors = [sparse_decode(host[2 * i], host[2 * i + 1], TensorSpec.from_string(s))
                   for i, s in enumerate(specs)]
        out = frame.with_tensors(tensors)
        out.meta.pop("sparse_specs", None)
        return out
