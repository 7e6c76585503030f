"""Thread and socket census for the port's network tests: a module that
starts query servers and clients must leave no framework thread, no
socket and no metrics endpoint behind (the census of the JAX package's
``tests/conftest.py`` ``module_leak_check``, kept here so the port's test
files carry their own).

Threads are reported by name and by the package whose code they run
(``name [nnstreamer_tpu_torch]``, ``name [nnstreamer_tpu]``): the port's
threads carry names of their own (``torch-mqtt-client``), and a thread of
the JAX package that a parity test started is never blamed on the port."""

import os
import sys
import threading
import time

import pytest

#: thread-name prefixes outside the framework's control (library pools,
#: pytest internals); framework threads are named ("tcpq-*", "<element>-rpc",
#: segment workers, "-watchdog", pumps, the MQTT broker's "mqtt-broker*" and
#: client's "mqtt-client"/"mqtt-ping" (the port's: "torch-mqtt-*"), the
#: raw-TCP edge's "tcp-edge-*",
#: "<element>-pump", "<element>-pull", "<element>-probe*"), so every one of
#: them is counted
_IGNORE = ("MainThread", "Thread-", "ThreadPool", "Dummy", "asyncio", "pydevd",
           "raylet", "grpc")


_PACKAGES = ("nnstreamer_tpu_torch", "nnstreamer_tpu")


def thread_package(t: threading.Thread) -> str:
    """The package whose code `t` runs: its target's module, else its
    class's (a ``Thread`` subclass)."""
    target = getattr(t, "_target", None)
    mod = getattr(target, "__module__", None) or type(t).__module__ or "?"
    for pkg in _PACKAGES:
        if mod == pkg or mod.startswith(pkg + "."):
            return pkg
    return mod


def framework_threads() -> set:
    """Live framework threads as ``"<name> [<package>]"``."""
    return {f"{t.name} [{thread_package(t)}]" for t in threading.enumerate()
            if t.is_alive() and not t.name.startswith(_IGNORE)}


def socket_fds() -> int:
    """Open socket fds of this process (-1 where /proc is missing)."""
    try:
        fds = os.listdir("/proc/self/fd")
    except OSError:
        return -1
    n = 0
    for fd in fds:
        try:
            if os.readlink(f"/proc/self/fd/{fd}").startswith("socket:"):
                n += 1
        except OSError:
            continue
    return n


def metrics_servers() -> int:
    n = 0
    for name in ("nnstreamer_tpu.core.telemetry", "nnstreamer_tpu_torch.core.telemetry"):
        mod = sys.modules.get(name)
        if mod is not None:
            n += mod.live_server_count()
    return n


def _snapshot():
    return framework_threads(), socket_fds(), metrics_servers()


def assert_no_leaks(before, wait_s: float = 8.0) -> None:
    """Wait (bounded; teardown is asynchronous) until nothing is left over
    from ``before`` (a :func:`_snapshot`), then assert it."""
    threads0, socks0, metrics0 = before
    deadline = time.monotonic() + wait_s
    while True:
        threads, socks, metrics = _snapshot()
        leaked = threads - threads0
        if (not leaked and metrics <= metrics0 and (socks0 < 0 or socks <= socks0)) \
                or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    assert metrics <= metrics0, f"leaked metrics endpoint(s): {metrics0} -> {metrics}"
    assert not leaked, f"leaked framework threads: {sorted(leaked)}"
    if socks0 >= 0:
        assert socks <= socks0, f"leaked sockets: {socks0} -> {socks}"


@pytest.fixture(scope="module", autouse=True)
def module_leak_check():
    """Module-scoped census: use with ``from torch_census import
    module_leak_check  # noqa: F401`` in a test module."""
    before = _snapshot()
    yield
    assert_no_leaks(before)
