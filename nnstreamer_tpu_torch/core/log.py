"""Logging shims.

Port of ``nnstreamer_tpu/core/log.py``: one stdlib logger per element or
category under the root logger ``nnstreamer_tpu_torch`` (its own name, so
a process that imports both packages never shares handlers between them),
a fatal helper that logs a backtrace and raises, and the level from
``NNS_TPU_LOG`` (e.g. ``NNS_TPU_LOG=debug``).
"""

from __future__ import annotations

import logging
import os
import traceback

_root = logging.getLogger("nnstreamer_tpu_torch")
if not _root.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S")
    )
    _root.addHandler(_h)
    _root.setLevel(
        getattr(logging, os.environ.get("NNS_TPU_LOG", "INFO").upper(), logging.INFO)
    )


def get_logger(category: str) -> logging.Logger:
    return _root.getChild(category)


def fatal(logger: logging.Logger, msg: str, *args) -> "NoReturn":  # noqa: F821
    """Log with a backtrace and raise ``RuntimeError``."""
    text = msg % args if args else msg
    logger.error("%s\n%s", text, "".join(traceback.format_stack(limit=12)))
    raise RuntimeError(text)
