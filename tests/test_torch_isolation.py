"""The port stands alone: nothing in ``nnstreamer_tpu_torch/`` or in
``chip_smoke.py`` imports JAX, flax or the JAX package, and importing the
port (every module of it, and by name the subpackages and modules that
resolve subplugins, media, wire codecs and model sources) and running its
converter, codecs and decoders loads none of them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "nnstreamer_tpu_torch"
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nnstreamer_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in _FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # lazy registrations and import_module name modules as strings
            # ("pkg.module:attr")
            target = node.value.partition(":")[0]
            if all(p.isidentifier() for p in target.split(".")) and _forbidden(target):
                bad.append(node.value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nnstreamer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import nnstreamer_tpu_torch.pipeline as pl\n"
        "pl.parse_pipeline('appsrc ! tensor_filter model=x ! tensor_decoder "
        "mode=image_labeling ! tensor_sink')\n"
        "import numpy as np\n"
        "import nnstreamer_tpu_torch.converters, nnstreamer_tpu_torch.distributed\n"
        "from nnstreamer_tpu_torch.core import config, model_uri, registry\n"
        "from nnstreamer_tpu_torch.distributed import flatbuf_codec, protobuf_codec, wire\n"
        "from nnstreamer_tpu_torch.media import image, wav, y4m\n"
        "from nnstreamer_tpu_torch.models import kws_cnn\n"
        "assert model_uri.resolve_model_uri('file:///m.pt') == '/m.pt'\n"
        "for kind in (registry.KIND_CONVERTER, registry.KIND_DECODER):\n"
        "    for name in registry.get_all(kind):\n"
        "        registry.get(kind, name)\n"
        "p = pl.parse_pipeline('appsrc name=src ! tensor_converter mode=custom:tokenizer ! "
        "tensor_decoder mode=flexbuf ! tensor_converter mode=custom:flexbuf ! "
        "tensor_decoder mode=protobuf ! tensor_converter mode=custom:protobuf ! "
        "tensor_decoder mode=flatbuf ! tensor_converter mode=custom:flatbuf ! "
        "tensor_decoder mode=detokenizer ! tensor_sink name=out')\n"
        "p.start(); p['src'].push(np.frombuffer(b'hi', np.uint8)); p['src'].end_of_stream()\n"
        "p.wait(timeout=30); p.stop()\n"
        "assert p['out'].frames[0].meta['text'] == 'hi', p['out'].frames\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_the_port_imports_and_serves_without_grpc():
    """The card machine has no ``grpc``: with it blocked, every port module
    imports (the MQTT, edge, hybrid and gRPC-stream modules among them), a
    connect-type=tcp query round trip and a tcp edge stream run, and every
    gRPC mode raises a RuntimeError naming the package at ``start()``:
    connect-type=grpc of the query elements (the default), edgesink and
    edgesrc in connect-type=server, client and hybrid, tensor_sink_grpc and
    tensor_src_grpc.  Nothing falls back to TCP."""
    code = (
        "import sys\n"
        "sys.modules['grpc'] = None  # import grpc raises ImportError\n"
        "import importlib, pkgutil\n"
        "import numpy as np\n"
        "import nnstreamer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from nnstreamer_tpu_torch.pipeline import parse_pipeline\n"
        "srv = parse_pipeline('tensor_query_serversrc name=s id=7 host=127.0.0.1 "
        "connect-type=tcp ! tensor_filter framework=scaler custom=factor:2 accelerator=cpu ! "
        "tensor_query_serversink id=7')\n"
        "srv.start()\n"
        "try:\n"
        "    cl = parse_pipeline(f\"appsrc name=src ! tensor_query_client host=127.0.0.1 "
        "port={srv['s'].props['port']} connect-type=tcp wire-batch=2 ! tensor_sink name=out\")\n"
        "    cl.start()\n"
        "    for i in range(5):\n"
        "        cl['src'].push(np.float32([i]))\n"
        "    cl['src'].end_of_stream(); cl.wait(timeout=30); cl.stop()\n"
        "    assert [float(f.tensors[0][0]) for f in cl['out'].frames] == [0, 2, 4, 6, 8]\n"
        "finally:\n"
        "    srv.stop()\n"
        "import time\n"
        "tx = parse_pipeline('appsrc name=src ! edgesink name=es connect-type=tcp host=127.0.0.1')\n"
        "tx.start()\n"
        "rx = parse_pipeline(f\"edgesrc connect-type=tcp dest-host=127.0.0.1 "
        "dest-port={tx['es'].props['port']} topic=nns ! tensor_sink name=out\")\n"
        "rx.start()\n"
        "t0 = time.monotonic()\n"
        "while tx['es']._tcp.subscriber_count('nns') < 1 and time.monotonic() - t0 < 5:\n"
        "    time.sleep(0.01)\n"
        "tx['src'].push(np.float32([4]))\n"
        "while not rx['out'].frames and time.monotonic() - t0 < 10:\n"
        "    time.sleep(0.01)\n"
        "rx.stop(); tx['src'].end_of_stream(); tx.wait(timeout=10); tx.stop()\n"
        "assert [float(f.tensors[0][0]) for f in rx['out'].frames] == [4.0]\n"
        "grpc_modes = ['tensor_query_serversrc ! tensor_query_serversink',\n"
        "              'appsrc ! tensor_query_client port=5 ! tensor_sink',\n"
        "              'appsrc ! tensor_sink_grpc', 'tensor_src_grpc ! tensor_sink']\n"
        "for ct in ('server', 'client', 'hybrid'):\n"
        "    grpc_modes.append(f'appsrc ! edgesink connect-type={ct} dest-port=1')\n"
        "    grpc_modes.append(f'edgesrc connect-type={ct} dest-port=1 ! tensor_sink')\n"
        "grpc_modes.append('edgesrc dest-port=1 ! tensor_sink')  # direct, the default\n"
        "for text in grpc_modes:\n"
        "    pipe = parse_pipeline(text)\n"
        "    try:\n"
        "        pipe.start()\n"
        "    except RuntimeError as e:\n"
        "        assert 'requires the grpc package' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(f'{text!r} started without grpc')\n"
        "    finally:\n"
        "        pipe.stop()\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
