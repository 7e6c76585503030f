"""nns-tpu-torch-check: dump the port's elements, subplugins, card and
configuration.

Port of ``nnstreamer_tpu/cli/confchk.py`` (≙ the reference's
``nnstreamer-check``): what is registered per subplugin kind, where the
active configuration came from, the ``core/hw.py`` probe (each card's
name, compute capability, SMs and memory) and the kernels' build cache
(``core/compile_cache.py``: its directory and the kernel libraries built
there).

CLI: ``python -m nnstreamer_tpu_torch.cli.confchk``
"""

from __future__ import annotations

import sys
from typing import List, Optional

from ..core import compile_cache, config, registry


def _card_lines(info) -> List[str]:
    if "error" in info:
        return [f"cards               : none ({info['error']})"]
    cards = info.get("cards") or []
    if not cards:
        return ["cards               : none (host CPU)"]
    return [f"card {i}              : {c['name']}, compute capability {c['capability']}, "
            f"{c['sms']} SMs, {c['memory_bytes'] / 2**30:.1f} GiB"
            for i, c in enumerate(cards)]


def _kernel_lines() -> List[str]:
    from ..ops import _build

    where = compile_cache.cache_dir("kernels")
    lines = [f"kernel cache        : {where}"
             + ("" if compile_cache.persistent() else " (temporary: cache_dir is empty)")]
    built = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        lib = _build._lib_path(src.stem)
        built.append(f"  {src.stem:<16} {'built ' + lib.name if lib.exists() else 'not built'}")
    return lines + [f"kernel libraries ({sum('built ' in b for b in built)} of {len(built)} "
                    "built for this toolkit):"] + built


def report() -> str:
    # importing the element/subplugin packages triggers self-registration
    from .. import backends as _b  # noqa: F401
    from .. import converters as _c  # noqa: F401
    from .. import decoders as _d  # noqa: F401
    from .. import elements as _e  # noqa: F401
    from ..core import hw
    from ..pipeline.element import ELEMENT_TYPES

    lines: List[str] = []
    lines.append("nnstreamer_tpu_torch configuration check")
    lines.append("=" * 40)
    # time-bounded probe in a throwaway process: a wedged card must not
    # hang a conf-check tool
    hw_info = hw.probe()
    dev_desc = hw_info["devices"] or [hw_info.get("error", "none found")]
    lines.append(f"torch devices       : {dev_desc}")
    lines.extend(_card_lines(hw_info))
    lines.append(f"nvcc                : {compile_cache.host_fingerprint('nvcc')}")
    lines.extend(_kernel_lines())
    lines.append(f"config loaded from  : {config.loaded_from() or '(defaults)'}")
    lines.append("")
    factories = sorted(set(ELEMENT_TYPES))
    lines.append(f"pipeline elements ({len(factories)}):")
    for n in factories:
        cls = ELEMENT_TYPES[n]
        alias = "" if cls.FACTORY_NAME == n else f"  (alias of {cls.FACTORY_NAME})"
        lines.append(f"  {n}{alias}")
    for kind in registry.KINDS:
        names = sorted(registry.get_all(kind))
        lines.append("")
        lines.append(f"{kind} subplugins ({len(names)}):")
        if kind == registry.KIND_CUSTOM and not names:
            # runtime registrations (tensor_if custom conditions): empty at
            # import time by design, not a missing subplugin class
            lines.append("  (runtime-registered tensor_if conditions; none "
                         "registered in this process)")
        for n in names:
            desc = registry.get_custom_property_desc(kind, n)
            if desc:
                desc_text = ", ".join(f"{k}: {v}" for k, v in desc.items())
                lines.append(f"  {n}  [{desc_text}]")
            else:
                lines.append(f"  {n}")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    sys.stdout.write(report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
