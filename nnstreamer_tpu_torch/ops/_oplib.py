"""The kernels as registered PyTorch operators (``nns_torch::*``).

Each hand-written kernel's wrapper is also a ``torch.library.custom_op``
whose body is the eager wrapper itself: the CUDA kernel on a CUDA tensor,
the plain version on a CPU tensor, with the route chosen when the op runs
(alignment and plans read ``data_ptr()`` then).  Its ``register_fake``
gives the output shapes and dtypes, touches no launch counter and runs no
kernel.

An eager call goes straight to the wrapper (no dispatcher on the hot
path); while ``torch.export`` traces a module (:func:`tracing`), the
wrapper calls the operator instead, whatever device the example tensors
are on, so the exported program records the kernel's operator rather than
the branch the trace's device would have taken.  Importing
``nnstreamer_tpu_torch.ops`` registers every operator, which a saved
program needs before ``torch.export.load``.
"""

from __future__ import annotations

import torch

#: the port's operator namespace: ``torch.ops.nns_torch.<name>``
NAMESPACE = "nns_torch"


def tracing() -> bool:
    """True while ``torch.export`` (or ``torch.compile``) traces the caller."""
    return torch.compiler.is_compiling()


def name(op: str) -> str:
    """The qualified name of the port's operator `op`."""
    return f"{NAMESPACE}::{op}"
