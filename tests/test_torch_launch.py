"""``python -m nnstreamer_tpu_torch.cli.launch`` against the JAX package's
``launch``: the same pipeline text (``videotestsrc`` random frames, the
converter, a 32x32 width-0.35 MobileNet-v2 with the same weights in both
packages, the labeling decoder, a sink) gives the same labels; the command
runs as a child process (mirroring ``tests/test_cli_tools.py``'s launch
case); ``--dot`` and ``--trace`` write what they name.  Tolerance: exact
labels, the JAX scores within the pipeline tests' 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nnstreamer_tpu.pipeline as jax_pipeline_pkg
import nnstreamer_tpu_torch.pipeline as port_pipeline_pkg
from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.cli import launch as jax_launch
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.cli import launch
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models.mobilenet_v2 import state_dict_from_flax
from torch_parity import randomized_batchnorm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "launch_mobilenet"
PROPS = {"dtype": "float32", "classes": "10", "width": "0.35", "size": "32"}


@pytest.fixture(scope="module")
def registered():
    fn, variables, in_spec, out_spec = jax_build("mobilenet_v2", PROPS)
    variables = randomized_batchnorm(variables)
    register_jax_model(MODEL, fn, variables, in_spec, out_spec)
    module, t_in, t_out = torch_build("mobilenet_v2", PROPS)
    module.load_state_dict(state_dict_from_flax(variables))
    register_torch_model(MODEL, module, t_in, t_out)
    yield
    unregister_jax_model(MODEL)
    unregister_torch_model(MODEL)


def _launched(monkeypatch, pkg, main, argv):
    """Run `main(argv)` in process; returns (exit code, the pipeline)."""
    made = []
    real = pkg.parse_pipeline
    monkeypatch.setattr(pkg, "parse_pipeline", lambda text, *a, **k: made.append(
        real(text, *a, **k)) or made[-1])
    rc = main(argv)
    return rc, made[0]


def text(framework, extra=""):
    return (f"videotestsrc num-buffers=12 width=32 height=32 pattern=random seed=4 ! "
            f"tensor_converter ! tensor_filter framework={framework} model={MODEL} "
            f"max-batch=4 {extra} ! tensor_decoder mode=image_labeling ! tensor_sink name=out")


def test_launch_labels_equal_the_jax_launch(registered, monkeypatch):
    rc, pipe = _launched(monkeypatch, port_pipeline_pkg, launch.main,
                         ["-q", "--timeout", "120", text("torch-cuda", "accelerator=cpu")])
    jrc, jpipe = _launched(monkeypatch, jax_pipeline_pkg, jax_launch.main,
                           ["-q", "--timeout", "120", text("jax-xla")])
    assert rc == jrc == 0
    got, want = pipe["out"].frames, jpipe["out"].frames
    assert len(got) == len(want) == 12
    assert [f.meta["label_index"] for f in got] == [f.meta["label_index"] for f in want]
    np.testing.assert_allclose([f.meta["label_score"] for f in got],
                               [f.meta["label_score"] for f in want], rtol=1e-4, atol=1e-4)


def test_launch_writes_dot_and_trace(registered, monkeypatch, tmp_path, capsys):
    dot = tmp_path / "graph.dot"
    rc, pipe = _launched(monkeypatch, port_pipeline_pkg, launch.main,
                         ["--trace", "--dot", str(dot), text("torch-cuda", "accelerator=cpu")])
    assert rc == 0 and len(pipe["out"].frames) == 12
    graph = dot.read_text()
    assert graph.startswith("digraph pipeline {") and graph.count("->") == 4
    err = capsys.readouterr().err
    assert "pipeline finished in" in err and "tensor_filter" in graph


def test_launch_runs_as_a_child_process():
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.cli.launch", "-q",
         "videotestsrc num-buffers=2 ! tensor_converter ! tensor_sink name=out"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr


def test_launch_reraises_an_element_error(monkeypatch):
    from nnstreamer_tpu_torch.pipeline.element import ElementError

    with pytest.raises(ElementError):
        launch.main(["-q", "videotestsrc num-buffers=2 ! tensor_filter framework=nope ! "
                     "tensor_sink"])
