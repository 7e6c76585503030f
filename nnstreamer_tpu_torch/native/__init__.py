"""The port's native C++ core and C ABI: ``core/nns_tpu_core.cc`` (the
mailbox, buffer pool and sample reader bound by ``runtime.py``),
``include/nns_tpu_custom_filter.h`` (the ``framework=custom`` subplugin
ABI) and ``examples/`` (subplugins built against it)."""
