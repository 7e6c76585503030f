"""``framework=auto`` in the port against the JAX package's.

* the choice for every extension, with and without ``custom=arch:``, and
  under an ini ``[framework-priority]`` override and an
  ``NNS_TPU_FRAMEWORK_PRIORITY_<EXT>`` one (both packages read the same
  file and environment).  Where the defaults differ by design, the table
  says so: ``torch-cuda`` takes the place of ``jax-xla`` and, like it,
  wins a file only with ``arch:``; a ``.tflite``/``.onnx`` file always goes
  to the port's importers (``torch-cuda`` loads no such file), and a bare
  ``.pt`` to ``torch`` in both;
* pipelines: a ``.tflite`` (``custom=int8:true``) and an ``.onnx``
  MobileNet-v2 at 32x32 width 0.35 label frames through ``framework=auto``
  exactly as through the explicit framework and as the JAX package's
  ``framework=auto`` (its decoder unfused, ROADMAP C12); a bare TorchScript
  ``.pt`` runs on ``torch`` and a zoo state_dict ``.pt`` with ``arch:`` on
  ``torch-cuda``;
* the hot-swap latch keeps the framework ``auto`` resolved at start.

Tolerance: exact (framework names, labels and outputs).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import torch_model_files as mf  # noqa: E402
from torch_parity import assert_frames_equal, run  # noqa: E402

from nnstreamer_tpu.core import config as jax_config  # noqa: E402
from nnstreamer_tpu.elements.filter import detect_framework as jax_detect  # noqa: E402
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse  # noqa: E402
from nnstreamer_tpu.pipeline.element import ElementError as JaxElementError  # noqa: E402
from nnstreamer_tpu_torch.core import config  # noqa: E402
from nnstreamer_tpu_torch.elements.filter import detect_framework  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_pipeline  # noqa: E402
from nnstreamer_tpu_torch.pipeline.element import ElementError  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fresh_config(monkeypatch, tmp_path):
    """No user ini leaks in: both packages read an empty config dir."""
    monkeypatch.delenv("NNS_TPU_CONF", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    config.reset()
    jax_config.reset()
    yield
    config.reset()
    jax_config.reset()


def choice(detect, error, model, custom):
    try:
        return detect(model, custom)
    except error:
        return "refused"


ARCH = "arch:mobilenet_v2,seed:0"
#: (model, custom) -> (port's choice, JAX's choice)
TABLE = [
    ("m.tflite", "", "tflite", "tflite"),
    ("m.tflite", ARCH, "tflite", "jax-xla"),
    ("m.onnx", "", "onnx", "onnx"),
    ("m.onnx", ARCH, "onnx", "jax-xla"),
    ("m.pt", "", "torch", "torch"),
    ("m.pt", ARCH, "torch-cuda", "torch"),
    ("m.pth", "", "torch", "torch"),
    ("m.pth", ARCH, "torch-cuda", "torch"),
    ("m.PT", "k:arch", "torch", "torch"),  # "arch" as a value is no arch key
    ("m.py", "", "python3", "python3"),
    ("m.py", ARCH, "python3", "python3"),
    ("lib.so", "", "custom", "custom"),
    ("m.msgpack", ARCH, "refused", "jax-xla"),
    ("m.bin", "", "refused", "refused"),
    ("zoo", ARCH, "refused", "refused"),
]


@pytest.mark.parametrize("model,custom,port,jax", TABLE,
                         ids=[f"{m}-{'arch' if 'arch:' in c else 'plain'}"
                              for m, c, _, _ in TABLE])
def test_auto_choice_against_jax(model, custom, port, jax):
    assert choice(detect_framework, ElementError, model, custom) == port
    assert choice(jax_detect, JaxElementError, model, custom) == jax


@pytest.mark.parametrize("model,custom,want", [
    ("m.tflite", "", "onnx"), ("m.pt", ARCH, "torch"), ("m.bin", "", "custom"),
    ("lib.so", "", "python3")])
def test_ini_and_env_override_choose_alike(tmp_path, monkeypatch, model, custom, want):
    ini = tmp_path / "nnstreamer_tpu.ini"
    ini.write_text("[framework-priority]\ntflite = onnx, tflite\npt = torch\nbin = custom\n")
    monkeypatch.setenv("NNS_TPU_CONF", str(ini))
    monkeypatch.setenv("NNS_TPU_FRAMEWORK_PRIORITY_SO", "python3,custom")
    config.reset()
    jax_config.reset()
    assert config.framework_priority(Path(model).suffix) == \
        jax_config.framework_priority(Path(model).suffix)
    assert detect_framework(model, custom) == jax_detect(model, custom) == want


def test_defaults_list_the_ports_frameworks():
    assert config.framework_priority(".pt") == ["torch-cuda", "torch"]
    assert config.framework_priority("PTH") == ["torch-cuda", "torch"]
    assert [config.framework_priority(e) for e in ("tflite", "onnx", "py", "so", "xyz")] == \
        [["tflite"], ["onnx"], ["python3"], ["custom"], []]


# -- pipelines ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mv

    module, _, _ = mv.build({"dtype": "float32", "size": "32", "width": "0.35", "seed": "3"})
    module.eval()
    calib = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    d = tmp_path_factory.mktemp("auto")
    paths = {"tflite": d / "mobilenet_v2_quant.tflite", "onnx": d / "mobilenet_v2.onnx"}
    paths["tflite"].write_bytes(mf.mobilenet_v2_tflite(module, calib, "uint8"))
    paths["onnx"].write_bytes(mf.mobilenet_v2_onnx(module, 32, 32))
    return paths


def _labels(parse, text, frames):
    pipe = run(parse, text, [(x, float(i)) for i, x in enumerate(frames)], timeout=120)
    return [f.meta["label_index"] for f in pipe["out"].frames], pipe


@pytest.mark.parametrize("kind,custom", [("tflite", "custom=int8:true"), ("onnx", "")])
def test_auto_pipeline_labels_as_explicit_and_as_jax(files, kind, custom):
    frames = np.random.default_rng(2).integers(0, 256, (8, 1, 32, 32, 3), dtype=np.uint8)
    text = ("appsrc name=src ! tensor_filter name=f framework={fw} model={path} {custom} "
            "max-batch=4 {extra} ! tensor_decoder mode=image_labeling {dec} ! "
            "tensor_sink name=out")
    fmt = dict(path=files[kind], custom=custom)
    auto, pipe = _labels(parse_pipeline, text.format(fw="auto", extra="accelerator=cpu", dec="",
                                                     **fmt), frames)
    assert pipe["f"]._framework == kind
    explicit, _ = _labels(parse_pipeline, text.format(fw=kind, extra="accelerator=cpu", dec="",
                                                      **fmt), frames)
    jax, _ = _labels(jax_parse, text.format(fw="auto", extra="", dec="device-fused=never",
                                            **fmt), frames)
    assert auto == explicit == jax and len(auto) == 8


class _Head(torch.nn.Module):
    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return (x.float() * self.scale).sum(dim=-1)


def test_auto_takes_torchscript_to_torch_and_keeps_it_across_a_swap(tmp_path):
    a, b = tmp_path / "a.pt", tmp_path / "b.pt"
    torch.jit.save(torch.jit.script(_Head(2.0)), str(a))
    torch.jit.save(torch.jit.script(_Head(3.0)), str(b))
    pipe = parse_pipeline(f"appsrc name=src ! tensor_filter name=f framework=auto model={a} "
                          "accelerator=cpu is-updatable=true ! tensor_sink name=out")
    pipe.start()
    try:
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        pipe["src"].push(x, pts=0.0)
        _wait_frames(pipe, 1)
        assert (pipe["f"]._framework, pipe["f"].backend.NAME) == ("torch", "torch")
        ticket = pipe.reload_model("f", str(b))
        assert ticket.wait_staged(30)
        pipe["src"].push(x, pts=1.0)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=60)
        assert (pipe["f"]._framework, pipe["f"].backend.NAME) == ("torch", "torch")
    finally:
        pipe.stop()
    got = [np.asarray(f.tensors[0]) for f in pipe["out"].frames]
    np.testing.assert_array_equal(got[0], (x * 2).sum(-1))
    np.testing.assert_array_equal(got[1], (x * 3).sum(-1))


def _wait_frames(pipe, n, timeout=30.0):
    import time

    end = time.monotonic() + timeout
    while len(pipe["out"].frames) < n:
        assert time.monotonic() < end, "no frame arrived"
        time.sleep(0.01)


def test_auto_takes_a_zoo_state_dict_to_torch_cuda(tmp_path):
    """A ``.pt`` state_dict with ``custom=arch:`` runs on ``torch-cuda``
    (here on the CPU), equal to the zoo build it was saved from."""
    from nnstreamer_tpu_torch.models import build

    props = "arch:mobilenet_v2,dtype:float32,size:32,width:0.35,seed:5"
    module = build("mobilenet_v2", {"dtype": "float32", "size": "32", "width": "0.35",
                                    "seed": "7"})[0]
    path = tmp_path / "weights.pt"
    torch.save(module.state_dict(), str(path))
    frames = [(x, float(i)) for i, x in enumerate(
        np.random.default_rng(6).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))]
    text = ("appsrc name=src ! tensor_filter name=f framework={fw} model={model} "
            f"custom={props} accelerator=cpu ! tensor_sink name=out")
    got = run(parse_pipeline, text.format(fw="auto", model=path), frames)
    assert got["f"]._framework == "torch-cuda"
    module.eval()
    with torch.inference_mode():
        for f, (x, _) in zip(got["out"].frames, frames):
            np.testing.assert_array_equal(np.asarray(f.tensors[0]),
                                          module(torch.from_numpy(x[None]))[0].numpy())
    want = run(parse_pipeline, text.format(fw="torch-cuda", model=path), frames)
    assert_frames_equal(got["out"].frames, want["out"].frames)


def test_auto_without_a_model_or_with_an_unknown_extension_refuses(tmp_path):
    for text in ("appsrc name=src ! tensor_filter framework=auto ! tensor_sink name=out",
                 f"appsrc name=src ! tensor_filter framework=auto model={tmp_path / 'x.bin'} "
                 "! tensor_sink name=out"):
        pipe = parse_pipeline(text)
        with pytest.raises(ElementError):
            pipe.start()
        pipe.stop()
