"""The JAX package's two lint gates, pointed at the port (ROADMAP C16), and
the thread census naming the package a thread belongs to (C17).

``tools/check_no_bare_except.py`` scans the whole port for bare ``except:``
and silent ``except Exception: pass``; ``tools/check_blocking_timeouts.py``
scans the port's I/O layers (``distributed/``, ``elements/``, ``native/``,
``cli/``: the JAX gate's ``distributed/`` and ``elements/`` and the new
native and CLI code) for unbounded blocking calls.  The tools are used as
they are: only their ``SCAN_DIRS`` module attribute is pointed at the port.
Both scans must be empty.
"""

import importlib.util
import threading
from pathlib import Path

import pytest
import torch

import torch_census
from nnstreamer_tpu.distributed.mqtt import MiniBroker as JaxBroker
from nnstreamer_tpu.distributed.mqtt import MqttClient as JaxClient
from nnstreamer_tpu_torch.distributed.mqtt import MiniBroker, MqttClient

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT_IO_DIRS = ["nnstreamer_tpu_torch/distributed", "nnstreamer_tpu_torch/elements",
                "nnstreamer_tpu_torch/native", "nnstreamer_tpu_torch/cli"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_gate_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool,dirs", [
    ("check_no_bare_except", ["nnstreamer_tpu_torch"]),
    ("check_blocking_timeouts", PORT_IO_DIRS)])
def test_the_port_passes_the_gate(tool, dirs, monkeypatch):
    mod = _tool(tool)
    monkeypatch.setattr(mod, "SCAN_DIRS", dirs)
    assert all((ROOT / d).is_dir() for d in dirs)
    assert mod.scan(ROOT) == []


@pytest.mark.parametrize("tool,bad", [
    ("check_no_bare_except", "try:\n    x = 1\nexcept Exception:\n    pass\n"),
    ("check_blocking_timeouts", "def f(q):\n    return q.get()\n")])
def test_the_gate_still_catches_a_fault(tool, bad, tmp_path, monkeypatch):
    """The same scan on a scratch tree with one fault finds it: the empty
    scan above is not a scan of nothing."""
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "m.py").write_text(bad)
    mod = _tool(tool)
    monkeypatch.setattr(mod, "SCAN_DIRS", ["pkg"])
    assert [k for k, _ in mod.scan(tmp_path)] and \
        all(k.startswith("pkg/m.py:") for k, _ in mod.scan(tmp_path))


def test_census_names_each_packages_mqtt_threads():
    """Both packages' clients and brokers alive at once: the census tells
    their threads apart by name and by package, so a JAX-side thread is
    never blamed on the port."""
    before = torch_census.framework_threads()
    # threads told apart by identity: a same-named thread that an earlier
    # test of this process left running must not hide the new one
    old = set(threading.enumerate())
    brokers = [MiniBroker(), JaxBroker()]
    clients = [MqttClient("127.0.0.1", brokers[0].port, client_id="census-port"),
               JaxClient("127.0.0.1", brokers[1].port, client_id="census-jax")]
    try:
        live = {f"{t.name} [{torch_census.thread_package(t)}]" for t in threading.enumerate()
                if t not in old and t.is_alive() and "mqtt" in t.name}
        ours = {t for t in live if t.endswith("[nnstreamer_tpu_torch]")}
        theirs = {t for t in live if t.endswith("[nnstreamer_tpu]")}
        assert "torch-mqtt-client [nnstreamer_tpu_torch]" in ours
        assert "mqtt-client [nnstreamer_tpu]" in theirs
        assert all(t.startswith("torch-") for t in ours)
        assert not any(t.startswith("torch-") for t in theirs)
    finally:
        for c in clients:
            c.close()
        for b in brokers:
            b.close()
    torch_census.assert_no_leaks((before, -1, 10 ** 6))  # the threads only


def test_thread_package_reads_the_target_or_the_class():
    from nnstreamer_tpu_torch.core import slots

    t = threading.Thread(target=print, name="x")
    assert torch_census.thread_package(t) == "builtins"
    t = threading.Thread(target=slots.SlotEngine.start, name="y")
    assert torch_census.thread_package(t) == "nnstreamer_tpu_torch"
