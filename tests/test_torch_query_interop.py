"""tensor_query across the two packages over 127.0.0.1 TCP.

Both directions: a JAX client against a port server, and a port client
against a JAX server, with ``framework=scaler`` and with a narrow
MobileNet-v2 (32x32, width 0.35, 10 classes) whose flax weights are
carried into the port.  Each client's answers equal the server package's
own in-process pipeline on the same frames.  A raw-socket recorder stands
in for the server and captures the request bytes each client sends for the
same pushes: byte-equal between the packages for v1 framing, v2 framing
and the batch envelope.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.core.buffer import TensorFrame as JFrame
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.distributed import tcp_query as tq
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models.mobilenet_v2 import state_dict_from_flax
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse
from torch_census import module_leak_check  # noqa: F401
from torch_parity import randomized_batchnorm

torch.set_num_threads(2)

PARSE = {"jax": jax_parse, "port": torch_parse}
FRAME = {"jax": JFrame, "port": TensorFrame}
MODEL, SIZE = "torch_query_interop_mobilenet", 32
_PROPS = {"dtype": "float32", "classes": "10", "width": "0.35", "size": str(SIZE)}
FILTERS = {
    "scaler": {"jax": "framework=scaler custom=factor:2",
               "port": "framework=scaler custom=factor:2 accelerator=cpu"},
    "mobilenet": {
        "jax": f"framework=jax-xla model={MODEL} max-batch=4 batch-timeout=200",
        "port": f"framework=torch-cuda model={MODEL} accelerator=cpu max-batch=4 "
                "batch-timeout=200"},
}
DECODER = {"scaler": "", "mobilenet": "tensor_decoder mode=image_labeling ! "}


@pytest.fixture(scope="module")
def mobilenet():
    fn, variables, in_spec, out_spec = jax_build("mobilenet_v2", dict(_PROPS, pallas="1"))
    variables = randomized_batchnorm(variables)
    register_jax_model(MODEL, fn, variables, in_spec, out_spec)
    module, t_in, t_out = torch_build("mobilenet_v2", _PROPS)
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    register_torch_model(MODEL, module, t_in, t_out)
    yield
    unregister_jax_model(MODEL)
    unregister_torch_model(MODEL)


def pushes(kind, n):
    rng = np.random.default_rng(7)
    if kind == "scaler":
        return [rng.standard_normal((3,)).astype(np.float32) for _ in range(n)]
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(n)]


def run(pkg, text, arrays, timeout=120):
    pipe = PARSE[pkg](text)
    pipe.start()
    try:
        for i, a in enumerate(arrays):
            pipe["src"].push(a, pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=timeout)
        return list(pipe["out"].frames)
    finally:
        pipe.stop()


def assert_answers_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pts == w.pts
        for k in ("label_index", "label"):
            assert g.meta.get(k) == w.meta.get(k)
        assert len(g.tensors) == len(w.tensors)
        for a, b in zip(g.tensors, w.tensors):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["scaler", "mobilenet"])
@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("cextra", ["", "wire-batch=4 max-in-flight=2", "wire-version=1"])
def test_cross_package_round_trip(request, kind, server_pkg, client_pkg, cextra):
    if kind == "mobilenet":
        request.getfixturevalue("mobilenet")
    arrays = pushes(kind, 10)
    sid = 1850 + (kind == "mobilenet") * 2 + (server_pkg == "jax")
    srv = PARSE[server_pkg](
        f"tensor_query_serversrc name=ssrc id={sid} host=127.0.0.1 port=0 connect-type=tcp ! "
        f"tensor_filter {FILTERS[kind][server_pkg]} ! {DECODER[kind]}"
        f"tensor_query_serversink id={sid}")
    srv.start()
    try:
        port = srv["ssrc"].props["port"]
        got = run(client_pkg, f"appsrc name=src ! tensor_query_client name=q host=127.0.0.1 "
                  f"port={port} connect-type=tcp {cextra} ! tensor_sink name=out", arrays)
        if kind == "mobilenet":
            # the server micro-batches the requests into max-batch=4 invokes
            assert srv["ssrc"]._core.admission.snapshot()["admitted"] >= 1
    finally:
        srv.stop()
    want = run(server_pkg, f"appsrc name=src ! tensor_filter {FILTERS[kind][server_pkg]} ! "
               f"{DECODER[kind]}tensor_sink name=out", arrays)
    assert_answers_equal(got, want)
    if kind == "scaler":
        for g, a in zip(got, arrays):
            np.testing.assert_array_equal(np.asarray(g.tensors[0]), a * 2)


def test_labels_equal_across_packages_in_process(mobilenet):
    arrays = pushes("mobilenet", 10)
    a = run("port", f"appsrc name=src ! tensor_filter {FILTERS['mobilenet']['port']} ! "
            f"{DECODER['mobilenet']}tensor_sink name=out", arrays)
    b = run("jax", f"appsrc name=src ! tensor_filter {FILTERS['mobilenet']['jax']} ! "
            f"{DECODER['mobilenet']}tensor_sink name=out", arrays)
    assert [f.meta["label_index"] for f in a] == [f.meta["label_index"] for f in b]


# -- the request bytes each client sends ---------------------------------------------
class Recorder:
    """A raw-socket stand-in server: records every message a client sends
    (header and body bytes, as received) and echoes each query back.  As a
    v1 peer it answers the 'V' probe with 'E'; as a v2 peer it agrees."""

    def __init__(self, peer_version: int):
        self.peer_version = peer_version
        self.messages = []
        self.gate = threading.Event()  # holds the first reply until set
        self._ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._ls.bind(("127.0.0.1", 0))
        self._ls.listen(4)
        self._ls.settimeout(10)
        self.port = self._ls.getsockname()[1]
        self._t = threading.Thread(target=self._serve, name="tcpq-recorder", daemon=True)
        self._t.start()

    def _recv(self, s, n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return buf

    def _serve(self):
        try:
            conn, _ = self._ls.accept()
        except OSError:
            return
        ver = 1
        replies = 0
        with conn:
            conn.settimeout(20)
            try:
                while True:
                    hs = 17 if ver == 1 else 21
                    head = self._recv(conn, hs)
                    mtype, blen = head[0], int.from_bytes(head[1:9], "little")
                    body = self._recv(conn, blen)
                    self.messages.append(head + body)
                    if mtype == ord("V"):
                        if self.peer_version == 1:
                            conn.sendall(tq.encode_msg(ord("E"), b"unknown message type 86"))
                        else:
                            conn.sendall(tq.encode_msg(ord("V"), b"2"))
                            ver = 2
                        continue
                    if replies == 0:
                        self.gate.wait(20)
                    replies += 1
                    conn.sendall(tq.encode_msg(mtype, body, 0.0, version=ver))
            except (ConnectionError, OSError):
                return

    def close(self):
        self._ls.close()
        self._t.join(timeout=10)


def record(pkg, peer_version, cver):
    """The messages one client sends for 1 + 8 pushed frames: frame 0
    alone, then (its reply held until the other eight are queued) two
    wire batches of four."""
    rec = Recorder(peer_version)
    pipe = PARSE[pkg](
        f"appsrc name=src ! tensor_query_client name=q host=127.0.0.1 port={rec.port} "
        f"connect-type=tcp wire-version={cver} wire-batch=4 max-in-flight=1 timeout=20 "
        "! tensor_sink name=out")
    pipe.start()
    try:
        rng = np.random.default_rng(9)
        for i in range(9):
            f = FRAME[pkg]([rng.standard_normal((2, 3)).astype(np.float32),
                            np.arange(i + 1, dtype=np.uint8)], pts=0.25 * i,
                           meta={"_nns_trace_id": f"trace-{i}", "camera": i % 2})
            f.seq = 1000 + i
            pipe["src"].push(f)
            deadline = time.monotonic() + 10
            while i == 0 and not any(m[0] == ord("Q") for m in rec.messages):
                assert time.monotonic() < deadline, "the first query never arrived"
                time.sleep(0.005)
        deadline = time.monotonic() + 10
        while pipe["src"].pending_frames() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)  # the eight frames wait in the client's mailbox
        rec.gate.set()
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
        outs = list(pipe["out"].frames)
    finally:
        pipe.stop()
        rec.close()
    assert [o.seq for o in outs] == [1000 + i for i in range(9)]
    return rec.messages


@pytest.mark.parametrize("peer_version,cver", [(1, 2), (2, 2), (2, 1)])
def test_request_bytes_equal_across_packages(peer_version, cver):
    port_msgs = record("port", peer_version, cver)
    jax_msgs = record("jax", peer_version, cver)
    assert port_msgs == jax_msgs
    queries = [m for m in port_msgs if m[0] == ord("Q")]
    assert len(queries) == 3  # one frame, then two batches of four
    v = min(peer_version, cver)
    hs = 17 if v == 1 else 21
    assert queries[0][hs:hs + 4] == b"QSNN"  # an NNSQ frame
    assert {q[hs:hs + 4] for q in queries[1:]} == {b"BSNN" if v == 1 else b"CSNN"}
    assert [m[0] for m in port_msgs].count(ord("V")) == (1 if cver == 2 else 0)
