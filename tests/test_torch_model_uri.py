"""Port parity: model sources — ``core/model_uri.py`` (``file://``,
``model://<name>[/<version>]``), ``core/config.py`` and the torch-cuda
backend's model resolution (a registered module, a ``.py`` file's
``get_model()``, a ``torch.save``d ``state_dict`` loaded into an
``arch:`` build) — on the CPU.

Mirrors ``tests/test_model_uri.py``'s six cases against the JAX
package's resolver.  Tolerance: exact (paths, and labels of the same
weights reached three ways).
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import config as jax_config
from nnstreamer_tpu.core.model_uri import resolve_model_uri as jax_resolve
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.core import config
from nnstreamer_tpu_torch.core.model_uri import repo_dir, resolve_model_uri
from nnstreamer_tpu_torch.models import build
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import run

torch.set_num_threads(2)

ZOO = "arch:mobilenet_v2,size:32,classes:10,width:0.35,dtype:float32"


@pytest.fixture
def repo(tmp_path, monkeypatch):
    monkeypatch.setenv("NNS_TPU_MODEL_REPO", str(tmp_path))
    return tmp_path


def _both(uri):
    got = resolve_model_uri(uri)
    assert got == jax_resolve(uri)
    return got


def test_plain_and_file_scheme():
    assert _both("/a/b.msgpack") == "/a/b.msgpack"
    assert _both("file:///a/b.py") == "/a/b.py"
    assert _both("zoo") == "zoo"


def test_named_version(repo):
    d = repo / "scaler" / "2"
    d.mkdir(parents=True)
    (d / "scaler.py").write_text("# model")
    assert _both("model://scaler/2") == str(d / "scaler.py")


def test_latest_picks_highest(repo):
    for v in ("1", "3", "2", "v9", "1."):
        d = repo / "m" / v
        d.mkdir(parents=True)
        (d / f"m{v}.bin").write_text(v)
    assert _both("model://m").endswith("3/m3.bin")
    assert _both("model://m/latest").endswith("3/m3.bin")


def test_multi_file_version_returns_dir(repo):
    d = repo / "ck" / "1"
    d.mkdir(parents=True)
    (d / "a").write_text("x")
    (d / "b").write_text("y")
    (d / ".hidden").write_text("z")
    assert _both("model://ck/1") == str(d)


def test_missing_raises(repo):
    for uri in ("model://nope", "model://", "model://m/7"):
        with pytest.raises(FileNotFoundError):
            resolve_model_uri(uri)
        with pytest.raises(FileNotFoundError):
            jax_resolve(uri)


def test_repo_from_the_config_file(tmp_path, monkeypatch):
    ini = tmp_path / "nnstreamer_tpu.ini"
    ini.write_text(f"[model-repo]\npath = {tmp_path / 'models'} ; a comment\n")
    monkeypatch.delenv("NNS_TPU_MODEL_REPO", raising=False)
    monkeypatch.setenv("NNS_TPU_CONF", str(ini))
    config.reset()
    jax_config.reset()
    try:
        assert repo_dir() == str(tmp_path / "models") == jax_config.get_value("model-repo", "path")
        monkeypatch.setenv("NNS_TPU_MODEL_REPO_PATH", "/elsewhere")
        assert config.get_value("model-repo", "path") == "/elsewhere"
    finally:
        config.reset()
        jax_config.reset()


def _labels(model, custom=""):
    images = np.random.default_rng(1).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    pipe = run(parse_pipeline,
               f"appsrc name=src ! tensor_filter framework=torch-cuda model={model} "
               f"{custom} accelerator=cpu max-batch=4 batch-timeout=100 ! tensor_decoder "
               "mode=image_labeling ! tensor_sink name=out",
               [(x, float(i)) for i, x in enumerate(images)])
    return [f.meta["label_index"] for f in pipe["out"].frames]


def test_filter_loads_a_state_dict_a_py_file_and_a_model_uri(repo):
    """The same weights reached as a registered module, a state_dict file
    loaded into a zoo build of another seed (by path, file:// and
    model://), and a ``.py`` file's get_model() give the same labels."""
    module, in_spec, out_spec = build("mobilenet_v2", dict(
        kv.split(":") for kv in (ZOO + ",seed:3").split(",")))
    d = repo / "mnv2" / "1"
    d.mkdir(parents=True)
    torch.save(module.state_dict(), d / "model.pt")
    (repo / "get.py").write_text(
        "import torch\n"
        "from nnstreamer_tpu_torch.models import build\n"
        f"def get_model():\n"
        f"    m, i, o = build('mobilenet_v2', dict(kv.split(':') for kv in {ZOO!r}.split(',')))\n"
        f"    m.load_state_dict(torch.load({str(d / 'model.pt')!r}, weights_only=True))\n"
        "    return m, i, o\n")
    register_torch_model("mnv2_reg", module, in_spec, out_spec)
    try:
        want = _labels("mnv2_reg")
    finally:
        unregister_torch_model("mnv2_reg")
    seed0 = _labels("zoo", f"custom={ZOO}")
    assert len(want) == 5 and seed0 != want  # the file's weights are not the default seed's
    for model in (d / "model.pt", f"file://{d / 'model.pt'}", "model://mnv2"):
        assert _labels(model, f"custom={ZOO}") == want
    assert _labels(repo / "get.py") == want


@pytest.mark.parametrize("model,item", [("m.jaxexport", "A12"), ("dir", "A9")])
def test_jax_only_model_formats_raise_naming_their_item(repo, model, item):
    (repo / "dir").mkdir()
    (repo / "m.jaxexport").write_bytes(b"\0")
    pipe = parse_pipeline(f"appsrc ! tensor_filter model={repo / model} custom={ZOO} "
                          "accelerator=cpu ! tensor_sink")
    # a StableHLO module cannot be loaded into torch: the message names the
    # .pt2 route and its converter; a directory is a trainer's
    # checkpoint-path (A9), and an empty one has no committed step to serve
    if model == "m.jaxexport":
        error, match = NotImplementedError, r"\.pt2\).*nns-tpu-torch-convert"
    else:
        error, match = FileNotFoundError, r"no committed checkpoint step \(the directory is empty"
    with pytest.raises(error, match=match):
        pipe.start()
    pipe.stop()
