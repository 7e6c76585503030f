"""The port's hardware probe (``core/hw.py``) and kernel build cache
(``core/compile_cache.py``), after ``tests/test_compile_cache.py`` and the
JAX probe's contracts.

* the probe: the JAX probe's keys plus ``cards``; the subprocess answers
  as this process does; a success cached for the process, a failure for
  ``_NEG_TTL_S`` on a fake clock, a wedged subprocess cut at its time
  limit; ``preferred_dtype()`` float32 on the CPU, bfloat16 with a card;
* the cache: the directory created under ``NNS_TPU_CUDA_CACHE_DIR`` and
  under ``[cuda] cache_dir``; the checkout's default; a conflicting
  directory warns and the first stays; ``""`` builds into a temporary
  directory; the kernels' library names take in the ``nvcc`` release; a
  second process finds the native core's ``g++`` build and compiles
  nothing.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nnstreamer_tpu_torch.core import compile_cache, hw
from nnstreamer_tpu_torch.core import config as nns_config

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
KEYS = {"platform", "device_kind", "num_devices", "accelerated", "devices", "cards"}


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    monkeypatch.delenv("NNS_TPU_CUDA_CACHE_DIR", raising=False)
    monkeypatch.delenv("NNS_TPU_CONF", raising=False)
    monkeypatch.chdir(tmp_path)
    nns_config.reset()
    compile_cache.reset_for_tests()
    hw.reset()
    yield
    nns_config.reset()
    compile_cache.reset_for_tests()
    hw.reset()


# -- the probe ------------------------------------------------------------------------------

def test_probe_keys_and_the_host_answer():
    info = hw.probe()
    assert set(info) == KEYS
    assert info == {"platform": "cpu", "device_kind": "cpu", "num_devices": 0,
                    "accelerated": False, "devices": ["cpu"], "cards": []}
    assert hw.has_accelerator() is False and hw.preferred_dtype() == "float32"


def test_the_probes_subprocess_answers_as_this_process():
    r = subprocess.run([sys.executable, "-c", hw._PROBE_SRC], capture_output=True, text=True,
                       timeout=120)
    (line,) = [ln for ln in r.stdout.splitlines() if ln.startswith("HWPROBE ")]
    assert json.loads(line[len("HWPROBE "):]) == hw._answer(torch)  # noqa: SLF001


def test_a_card_answer_prefers_bfloat16(monkeypatch):
    class Props:
        name, major, minor, multi_processor_count, total_memory = (
            "NVIDIA H100 80GB HBM3", 9, 0, 132, 85 * 2**30)

    class FakeCuda:
        is_available = staticmethod(lambda: True)
        device_count = staticmethod(lambda: 1)
        get_device_properties = staticmethod(lambda i: Props)

    class FakeTorch:
        cuda = FakeCuda

    answer = hw._answer(FakeTorch)
    assert answer["platform"] == "cuda" and answer["accelerated"] and answer["num_devices"] == 1
    assert answer["cards"] == [{"name": "NVIDIA H100 80GB HBM3", "capability": "9.0",
                                "sms": 132, "memory_bytes": 85 * 2**30}]
    assert answer["device_kind"] == "NVIDIA H100 80GB HBM3" and answer["devices"] == ["cuda:0"]
    monkeypatch.setattr(hw, "_query_devices", lambda timeout_s: dict(answer))
    assert hw.preferred_dtype() == "bfloat16"


def test_success_is_cached_for_the_process(monkeypatch):
    calls = []
    monkeypatch.setattr(hw, "_query_devices",
                        lambda timeout_s: calls.append(timeout_s) or hw._answer(torch))
    a = hw.probe()
    a["platform"] = "changed by the caller"
    assert hw.probe()["platform"] == "cpu" and len(calls) == 1  # a copy, cached
    hw.reset()
    hw.probe()
    assert len(calls) == 2


def test_failure_is_cached_for_its_ttl(monkeypatch):
    now = [1000.0]
    calls = []
    monkeypatch.setattr(hw.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(hw, "_query_devices",
                        lambda timeout_s: calls.append(1) or hw._fail("device probe rc=1: x"))
    assert hw.probe()["error"] == "device probe rc=1: x"
    assert not hw.has_accelerator() and hw.preferred_dtype() == "float32"
    assert len(calls) == 1
    now[0] += hw._NEG_TTL_S - 1
    hw.probe()
    assert len(calls) == 1
    now[0] += 2
    hw.probe()
    assert len(calls) == 2


def test_a_wedged_probe_is_cut_at_its_time_limit(monkeypatch):
    monkeypatch.setattr(hw, "_PROBE_SRC", "import time; time.sleep(60)")
    monkeypatch.setattr(torch.version, "cuda", "12.8")  # a CUDA build: the subprocess route
    monkeypatch.setenv("NNS_TPU_HW_PROBE_TIMEOUT", "0.5")
    info = hw.probe()
    assert info["error"].startswith("device probe timed out after")
    assert set(info) == KEYS | {"error"} and info["accelerated"] is False


def test_a_probe_that_prints_nothing_fails_with_its_last_line(monkeypatch):
    monkeypatch.setattr(hw, "_PROBE_SRC", "import sys; sys.exit('no CUDA device')")
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    info = hw.probe(timeout_s=60)
    assert info["error"] == "device probe rc=1: no CUDA device"


# -- the kernel build cache --------------------------------------------------------------

def test_default_in_a_checkout_is_its_build_directory():
    from nnstreamer_tpu_torch.native import runtime
    from nnstreamer_tpu_torch.ops import _build

    assert compile_cache.enable() is None and compile_cache.persistent()
    assert compile_cache.cache_dir("kernels") == ROOT / "build" / "torch_kernels" == _build.BUILD_DIR
    assert compile_cache.cache_dir("native") == ROOT / "build" / "torch_native" == runtime.BUILD_DIR


@pytest.mark.parametrize("how", ["env", "ini"])
def test_enable_creates_the_directory(tmp_path, monkeypatch, how):
    from nnstreamer_tpu_torch.ops import _build

    target = tmp_path / "kc"
    if how == "env":
        monkeypatch.setenv("NNS_TPU_CUDA_CACHE_DIR", str(target))
    else:
        ini = tmp_path / "nnstreamer_tpu.ini"
        ini.write_text(f"[cuda]\ncache_dir = {target}\n")
        monkeypatch.setenv("NNS_TPU_CONF", str(ini))
        nns_config.reset()
    assert compile_cache.enable() == target
    assert compile_cache.enable() == target  # idempotent
    assert _build._lib_path("top1").parent == target / "kernels"
    assert (target / "kernels").is_dir()


def test_a_conflicting_directory_warns_and_the_first_stays(tmp_path, caplog):
    first = compile_cache.enable(str(tmp_path / "a"))
    with caplog.at_level(logging.WARNING):
        assert compile_cache.enable(str(tmp_path / "a")) == first  # the same: no warning
        assert not any("already enabled" in r.message for r in caplog.records)
        assert compile_cache.enable(str(tmp_path / "b")) == first
    assert any("already enabled" in r.message for r in caplog.records)
    assert compile_cache.cache_dir() == tmp_path / "a" / "kernels"


def test_empty_directory_disables_the_persistent_cache(caplog):
    assert compile_cache.enable("") is None
    where = compile_cache.cache_dir("kernels")
    assert not compile_cache.persistent() and where.is_dir()
    assert where.parent.name.startswith("nns_torch_kernels_")
    assert not str(where).startswith(str(ROOT))
    with caplog.at_level(logging.WARNING):
        compile_cache.enable("")
    assert not any("already enabled" in r.message for r in caplog.records)


def test_the_nvcc_release_enters_the_library_name(monkeypatch):
    from nnstreamer_tpu_torch.ops import _build

    first = _build._lib_path("normalize_u8")
    monkeypatch.setitem(compile_cache._fingerprint, "nvcc",
                        "Linux-x86_64 Cuda compilation tools, release 99.0, V99.0.0")
    assert _build._lib_path("normalize_u8") != first
    fp = compile_cache.host_fingerprint("g++")
    assert fp == compile_cache.host_fingerprint("g++") and "\n" not in fp


_CHILD = (
    "import json\n"
    "from nnstreamer_tpu_torch.native import runtime\n"
    "ok = runtime.available()\n"
    "print('CHILD ' + json.dumps({'ok': ok, 'compiles': runtime.COMPILES,\n"
    "      'dir': str(runtime.library_path(runtime.CORE_SRC).parent)}))\n"
)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ missing: no native build here")
def test_a_second_process_finds_the_build_and_compiles_nothing(tmp_path):
    env = dict(os.environ, NNS_TPU_CUDA_CACHE_DIR=str(tmp_path / "kc"))
    env.pop("NNS_TPU_NO_NATIVE", None)
    got = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                           cwd=ROOT, env=env, timeout=300)
        (line,) = [ln for ln in r.stdout.splitlines() if ln.startswith("CHILD ")]
        got.append(json.loads(line[len("CHILD "):]))
    assert [g["ok"] for g in got] == [True, True]
    assert [g["compiles"] for g in got] == [1, 0]
    assert got[0]["dir"] == got[1]["dir"] == str(tmp_path / "kc" / "native")
