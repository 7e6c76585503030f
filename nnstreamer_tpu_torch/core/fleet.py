"""Routing hints from the discovery plane's announces.

Port of the capture path of ``nnstreamer_tpu/core/fleet.py``:
:func:`hint_from_announce` is the ONE place where a retained announce
becomes a per-endpoint routing hint (``draining``/``degraded``), read by the
query client's discovery (``elements/query.py``).  A telemetry digest under
:data:`DIGEST_KEY` wins over the announce's top-level keys, so a port client
reads a JAX server's digest-carrying announce as the JAX client does.

The rest of the JAX module, the digest publisher, the fleet observatory and
its rollups, belongs to the autoscaler's slice (ROADMAP A13.3) and is not
ported yet.
"""

from __future__ import annotations

from typing import Dict

#: announce key the telemetry digest rides under (``info["digest"]``)
DIGEST_KEY = "digest"


def hint_from_announce(info: dict) -> Dict[str, bool]:
    """``{"draining", "degraded"}`` of one announce: the digest's fields when
    the digest carries them, else the top-level announce keys."""
    d = info.get(DIGEST_KEY)
    src = d if isinstance(d, dict) and "draining" in d else info
    return {"draining": bool(src.get("draining", False)),
            "degraded": bool(src.get("degraded", False))}
