"""The port's command-line tools against the JAX package's, case for case
with ``tests/test_cli_tools.py``: ``pbtxt`` (the same text from both
packages, byte for byte), ``confchk`` (elements, subplugins, the card
probe, the kernel cache), ``codegen`` (the Python scaffold through the
``python3`` backend, the C scaffold built with the port's header and run
through ``custom``), ``inspect`` and ``convert`` (a ``.tflite`` affine file
and the ONNX MLP and CNN to ``.pt2`` programs served micro-batched; an
unsupported format refused).

Tolerance: exact, except the converted CNN against its frames one by one
(``rtol=1e-5``, as the JAX test holds its ``.jaxexport``).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from nnstreamer_tpu.cli import pbtxt as jax_pbtxt  # noqa: E402
from nnstreamer_tpu_torch.cli import codegen, confchk, pbtxt  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_pipeline  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

TEXTS = [
    "appsrc name=src ! tensor_transform name=tr mode=arithmetic option=add:1 ! "
    "tensor_sink name=out",
    "appsrc name=a ! mux.  appsrc name=b ! mux.  "
    "tensor_mux name=mux sync-mode=nosync ! tensor_sink name=out",
    "appsrc name=src ! tee name=t  t. ! tensor_sink name=s1  t. ! tensor_sink name=s2",
    "appsrc name=src ! tensor_filter name=f model=zoo custom=arch:mobilenet_v2 max-batch=8 ! "
    "tensor_decoder name=d mode=image_labeling ! tensor_sink name=out",
]


class TestPbtxt:
    @pytest.mark.parametrize("text", TEXTS, ids=["linear", "mux", "tee", "filter"])
    def test_pbtxt_equals_the_jax_tools(self, text):
        pb = pbtxt.pipeline_text_to_pbtxt(text)
        assert pb == jax_pbtxt.pipeline_text_to_pbtxt(text)
        back = pbtxt.pbtxt_to_pipeline_text(pb)
        assert back == jax_pbtxt.pbtxt_to_pipeline_text(pb)
        assert pbtxt.pipeline_text_to_pbtxt(back) == pb

    def test_linear_roundtrip(self):
        pb = pbtxt.pipeline_text_to_pbtxt(TEXTS[0])
        assert 'type: "tensor_transform"' in pb
        assert 'key: "option"' in pb and 'value: "add:1"' in pb
        assert 'link { src: "src" src_pad: 0 sink:' in pb

    def test_branching_roundtrip_runs(self):
        pb = pbtxt.pipeline_text_to_pbtxt(TEXTS[1])
        assert pb.count("node {") == 4 and pb.count("link {") == 3
        pipe = pbtxt.pbtxt_to_pipeline(pb)
        pipe.start()
        pipe["a"].push(np.int32([1]))
        pipe["b"].push(np.int32([2]))
        pipe["a"].end_of_stream()
        pipe["b"].end_of_stream()
        pipe.wait(timeout=15)
        pipe.stop()
        assert len(pipe["out"].frames[0].tensors) == 2

    def test_mux_sink_pad_order_preserved(self):
        pb = ('node { name: "a" type: "appsrc" }\n'
              'node { name: "b" type: "appsrc" }\n'
              'node { name: "m" type: "tensor_mux" }\n'
              'node { name: "out" type: "tensor_sink" }\n'
              'link { src: "a" src_pad: 0 sink: "m" sink_pad: 1 }\n'
              'link { src: "b" src_pad: 0 sink: "m" sink_pad: 0 }\n'
              'link { src: "m" src_pad: 0 sink: "out" sink_pad: 0 }\n')
        text = pbtxt.pbtxt_to_pipeline_text(pb)
        assert text == jax_pbtxt.pbtxt_to_pipeline_text(pb)
        pipe = parse_pipeline(text)
        pipe.start()
        pipe["a"].push(np.int32([1]))
        pipe["b"].push(np.int32([2]))
        pipe["a"].end_of_stream()
        pipe["b"].end_of_stream()
        pipe.wait(timeout=15)
        pipe.stop()
        assert [int(t[0]) for t in pipe["out"].frames[0].tensors] == [2, 1]

    def test_quote_escaping(self):
        pipe2 = pbtxt.pbtxt_to_pipeline(pbtxt.pipeline_to_pbtxt(
            parse_pipeline("appsrc name=src ! tensor_sink name=out")))
        assert set(pipe2.elements) == {"src", "out"}
        assert pbtxt._q('a="b"') == 'a=\\"b\\"' == jax_pbtxt._q('a="b"')

    def test_bad_pbtxt(self):
        from nnstreamer_tpu_torch.pipeline.parser import ParseError

        with pytest.raises(ParseError):
            pbtxt.pbtxt_to_pipeline("node { name: unbalanced")
        with pytest.raises(ParseError, match="no such element factory"):
            pbtxt.pbtxt_to_pipeline('node { name: "x" type: "nonexistent" }')

    def test_cli_prints_the_pbtxt(self, tmp_path):
        r = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch.cli.pbtxt", "to-pbtxt",
                            TEXTS[2]], capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert r.returncode == 0, r.stderr
        assert r.stdout == pbtxt.pipeline_text_to_pbtxt(TEXTS[2])
        (tmp_path / "p.pbtxt").write_text(r.stdout)
        assert pbtxt.main(["to-pipeline", str(tmp_path / "p.pbtxt")]) == 0
        assert pbtxt.main(["bogus"]) == 2


class TestConfchk:
    def test_report_lists_elements_and_backends(self):
        rep = confchk.report()
        for word in ("tensor_filter", "tensor_converter", "filter subplugins", "torch-cuda",
                     "tflite", "decoder subplugins", "config loaded from"):
            assert word in rep
        assert "jax-xla" not in rep

    def test_report_names_the_card_probe_and_the_kernel_cache(self):
        from nnstreamer_tpu_torch.core import compile_cache

        rep = confchk.report()
        assert "cards               : none (host CPU)" in rep  # no card here
        assert f"kernel cache        : {compile_cache.cache_dir('kernels')}" in rep
        for name in ("normalize_u8", "top1", "flash_attention", "quantize_i8", "int8_conv",
                     "int8_dwconv"):
            assert f"  {name:<16} " in rep

    def test_card_lines_from_a_probe_with_cards(self):
        info = {"cards": [{"name": "NVIDIA H100 80GB HBM3", "capability": "9.0", "sms": 132,
                           "memory_bytes": 85 * 2**30}]}
        assert confchk._card_lines(info) == [
            "card 0              : NVIDIA H100 80GB HBM3, compute capability 9.0, 132 SMs, "
            "85.0 GiB"]
        assert "timed out" in confchk._card_lines({"error": "device probe timed out"})[0]


class TestCodegen:
    def test_python_scaffold_runs_on_the_python3_backend(self, tmp_path):
        (path,) = codegen.generate("my_scaler", "python", str(tmp_path))
        ns = {}
        exec(compile(open(path).read(), path, "exec"), ns)
        out = ns["filter"]().invoke([np.zeros((3, 4, 4), np.uint8)])
        assert out[0].shape == (3, 4, 4)
        pipe = parse_pipeline(f"appsrc name=src ! tensor_filter framework=python3 model={path} "
                              "! tensor_sink name=out")
        x = np.arange(3 * 224 * 224, dtype=np.uint8).reshape(3, 224, 224)
        pipe.start()
        pipe["src"].push(x)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
        pipe.stop()
        np.testing.assert_array_equal(np.asarray(pipe["out"].frames[0].tensors[0]), x)

    @pytest.mark.skipif(shutil.which("make") is None or shutil.which("g++") is None,
                        reason="make or g++ missing: the C scaffold cannot be built here")
    @pytest.mark.parametrize("cc", ["cc", "g++"])
    def test_c_scaffold_compiles_and_runs(self, tmp_path, cc):
        from nnstreamer_tpu_torch.backends.custom_native import CustomNative

        files = codegen.generate("my_native", "c", str(tmp_path))
        makefile = (tmp_path / "Makefile").read_text()
        assert str(ROOT / "nnstreamer_tpu_torch" / "native" / "include") in makefile
        assert os.sep + "nnstreamer_tpu" + os.sep not in makefile
        assert any(f.endswith(".c") for f in files)
        r = subprocess.run(["make", "-C", str(tmp_path), f"CC={cc}"], capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        be = CustomNative()
        be.open(str(tmp_path / "my_native.so"), {})
        ins, _ = be.get_model_info()
        assert tuple(ins.tensors[0].shape) == (3, 224, 224)
        x = np.arange(3 * 224 * 224, dtype=np.uint8).reshape(3, 224, 224)
        (y,) = be.invoke([x])
        np.testing.assert_array_equal(x, y)
        be.close()

    def test_unknown_language_refused(self, tmp_path):
        with pytest.raises(ValueError, match="unknown lang"):
            codegen.generate("x", "rust", str(tmp_path))


class TestInspectCli:
    def test_list_all_elements(self, capsys):
        from nnstreamer_tpu_torch.cli.inspect import main

        from nnstreamer_tpu_torch.pipeline.element import ELEMENT_TYPES

        assert main([]) == 0
        out = capsys.readouterr().out
        # the port's 44 element classes (48 names with their aliases); a
        # test of the same process may have registered more
        classes = set(ELEMENT_TYPES.values())
        assert out.startswith(f"{len(ELEMENT_TYPES)} elements ({len(classes)} classes):")
        assert len({c for c in classes if c.__module__.startswith("nnstreamer_tpu_torch.")}) == 44
        assert "tensor_filter" in out and "appsrc" in out
        assert "decoder subplugins" in out and "torch-cuda" in out

    def test_inspect_element_properties(self, capsys):
        from nnstreamer_tpu_torch.cli.inspect import main

        assert main(["tensor_filter"]) == 0
        out = capsys.readouterr().out
        assert "framework" in out and "max-batch" in out and "default='torch-cuda'" in out

    def test_unknown_element_suggests(self, capsys):
        from nnstreamer_tpu_torch.cli.inspect import main

        assert main(["tensor_filt"]) == 1
        out = capsys.readouterr().out
        assert "did you mean" in out and "tensor_filter" in out


class TestConvertCli:
    """nns-tpu-torch-convert: third-party model -> ``.pt2`` program."""

    def test_tflite_roundtrip(self, tmp_path):
        from test_tflite_import import build_affine_tflite

        from nnstreamer_tpu_torch.cli.convert import main as convert_main

        src = tmp_path / "aff.tflite"
        src.write_bytes(build_affine_tflite())
        dst = tmp_path / "aff.pt2"
        assert convert_main([str(src), str(dst)]) == 0
        pipe = parse_pipeline(f"appsrc name=src ! tensor_filter framework=auto model={dst} "
                              "accelerator=cpu max-batch=4 batch-timeout=50 ! "
                              "tensor_sink name=out")
        pipe.start()
        for i in range(6):
            pipe["src"].push(np.full((1, 4), float(i), np.float32))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=60)
        pipe.stop()
        got = [np.asarray(f.tensors[0]) for f in pipe["out"].frames]
        assert len(got) == 6
        for i, g in enumerate(got):
            np.testing.assert_array_equal(g, np.full((1, 4), 2.0 * i + 1.0, np.float32))

    def test_onnx_default_output_name(self, tmp_path, capsys):
        from test_onnx_import import build_mlp

        from nnstreamer_tpu_torch.cli.convert import main as convert_main

        blob, _ = build_mlp()
        src = tmp_path / "mlp.onnx"
        src.write_bytes(blob)
        assert convert_main([str(src)]) == 0
        assert (tmp_path / "mlp.pt2").exists()
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith(f"{src} -> {tmp_path / 'mlp.pt2'} (") and out[0].endswith(
            " bytes)")
        assert out[1].startswith("  inputs: [") and out[2].startswith("  ops: ")

    def test_unsupported_format_fails_clearly(self, tmp_path):
        from nnstreamer_tpu_torch.cli.convert import main as convert_main

        src = tmp_path / "model.caffemodel"
        src.write_bytes(b"x")
        with pytest.raises(SystemExit, match="unsupported source format"):
            convert_main([str(src)])

    def test_convert_conv_model_batch_polymorphic(self, tmp_path):
        """A shape-sensitive graph (Conv) converts with the symbolic batch
        and serves micro-batched, each frame as it runs alone."""
        from test_onnx_import import build_cnn

        from nnstreamer_tpu_torch.backends.torch_cuda import TorchCuda
        from nnstreamer_tpu_torch.cli.convert import main as convert_main

        blob, _ = build_cnn()
        src = tmp_path / "cnn.onnx"
        src.write_bytes(blob)
        dst = tmp_path / "cnn.pt2"
        assert convert_main([str(src), str(dst)]) == 0
        be = TorchCuda()
        be.open(str(dst), {"accelerators": ["cpu"]})
        try:
            xs = np.random.default_rng(0).standard_normal((3, 1, 3, 16, 16)).astype(np.float32)
            (out,) = be.invoke_batch([xs])
            assert tuple(out.shape) == (3, 1, 5)
            (o1,) = be.invoke([xs[0]])
            np.testing.assert_allclose(out[0].numpy(), o1.numpy(), rtol=1e-5)
        finally:
            be.close()
