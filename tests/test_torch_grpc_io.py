"""The port's tensor_src_grpc / tensor_sink_grpc against the JAX package's.

Mirrors the contracts of ``tests/test_grpc_io.py``: a sink client sending
into a source server, a source client pulling from a sink server, the
source's inter-frame timeout, and both directions surviving a restart of
the peer server on the same port.  Across the packages, both ways and in
each IDL: one package's sink feeds the other's source, values equal, and
pts where the IDL carries them.  A micro-batch reaches the host in one copy per tensor.  The module
runs where ``grpc`` imports (the typed error without it is held by
``tests/test_torch_isolation.py``); every wait is bounded, and the
module's census checks that no thread or socket outlives it.
"""

import time

import numpy as np
import pytest
import torch

pytest.importorskip("grpc")

from nnstreamer_tpu_torch.core import buffer as tbuffer  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_pipeline  # noqa: E402
from torch_census import module_leak_check  # noqa: E402,F401

torch.set_num_threads(2)


def started(text, parse=parse_pipeline, retry_s=0.0):
    """A started pipeline; with ``retry_s``, retried while its port is still
    held by the previous server."""
    deadline = time.monotonic() + retry_s
    while True:
        pipe = parse(text)
        try:
            pipe.start()
            return pipe
        except Exception:
            pipe.stop()
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def ints(frames) -> list:
    return [int(np.asarray(f.tensors[0]).reshape(-1)[0]) for f in frames]


def test_sink_client_to_src_server():
    rx = started("tensor_src_grpc name=src server=true port=0 num-buffers=3 timeout=8000 ! "
                 "tensor_sink name=out")
    port = rx["src"].bound_port
    tx = started(f"appsrc name=a ! tensor_sink_grpc server=false port={port}")
    try:
        for i in range(3):
            tx["a"].push(np.full((2, 2), i, np.int32), pts=i * 0.5)
        tx["a"].end_of_stream()
        tx.wait(timeout=10)
        rx.wait(timeout=10)
    finally:
        tx.stop()
        rx.stop()
    frames = rx["out"].frames
    assert len(frames) == 3
    np.testing.assert_array_equal(frames[2].tensors[0], np.full((2, 2), 2, np.int32))
    assert frames[1].pts == pytest.approx(0.5)


def test_src_client_pulls_from_sink_server():
    tx = started("appsrc name=a ! tensor_sink_grpc name=s server=true port=0")
    port = tx["s"].bound_port
    rx = started(f"tensor_src_grpc server=false port={port} num-buffers=2 timeout=8000 ! "
                 "tensor_sink name=out")
    try:
        time.sleep(0.2)  # the Pull stream attaches
        for i in range(2):
            tx["a"].push(np.float32([i, i + 1]))
        rx.wait(timeout=10)
    finally:
        rx.stop()
        tx["a"].end_of_stream()
        tx.wait(timeout=10)
        tx.stop()
    frames = rx["out"].frames
    assert len(frames) == 2
    np.testing.assert_allclose(frames[1].tensors[0], [1.0, 2.0])


def test_src_server_timeout_eos():
    rx = started("tensor_src_grpc server=true port=0 timeout=300 ! tensor_sink name=out")
    try:
        rx.wait(timeout=10)
    finally:
        rx.stop()
    assert rx["out"].frames == []


def test_pull_client_survives_server_restart():
    tx1 = started("appsrc name=a ! tensor_sink_grpc name=s server=true port=0")
    port = tx1["s"].bound_port
    rx = started(f"tensor_src_grpc server=false port={port} num-buffers=4 timeout=10000 ! "
                 "tensor_sink name=out")
    tx2 = None
    try:
        time.sleep(0.3)
        tx1["a"].push(np.int32([1]))
        tx1["a"].push(np.int32([2]))
        time.sleep(0.3)
        tx1.stop()  # the server dies mid-stream
        tx2 = started(f"appsrc name=a ! tensor_sink_grpc name=s server=true port={port}",
                      retry_s=8)
        time.sleep(0.8)  # the client's Pull reconnects
        tx2["a"].push(np.int32([3]))
        tx2["a"].push(np.int32([4]))
        rx.wait(timeout=15)
    finally:
        rx.stop()
        tx1.stop()
        if tx2 is not None:
            tx2.stop()
    vals = ints(rx["out"].frames)
    assert 3 in vals and 4 in vals


def test_send_client_retries_through_restart():
    rx1 = started("tensor_src_grpc name=src server=true port=0 num-buffers=3 timeout=10000 ! "
                  "tensor_sink name=out")
    port = rx1["src"].bound_port
    tx = started(f"appsrc name=a ! tensor_sink_grpc server=false port={port} retry-timeout=10")
    rx2 = None
    try:
        tx["a"].push(np.int32([1]))
        time.sleep(0.3)
        rx1.stop()
        tx["a"].push(np.int32([2]))  # lands in the retry loop
        rx2 = started(f"tensor_src_grpc name=src server=true port={port} num-buffers=2 "
                      "timeout=10000 ! tensor_sink name=out", retry_s=8)
        tx["a"].push(np.int32([3]))
        rx2.wait(timeout=15)
    finally:
        tx["a"].end_of_stream()
        tx.wait(timeout=10)
        tx.stop()
        rx1.stop()
        if rx2 is not None:
            rx2.stop()
    vals = ints(rx1["out"].frames + rx2["out"].frames)
    assert 2 in vals and 3 in vals


def test_a_micro_batch_reaches_the_host_once_per_tensor(monkeypatch):
    calls = []
    inner = tbuffer.to_numpy
    monkeypatch.setattr(tbuffer, "to_numpy", lambda t: (calls.append(tuple(t.shape)),
                                                        inner(t))[1])
    rx = started("tensor_src_grpc name=src server=true port=0 num-buffers=6 timeout=8000 ! "
                 "tensor_sink name=out")
    tx = started(f"appsrc name=a ! tensor_sink_grpc server=false port={rx['src'].bound_port}")
    try:
        for b in range(2):
            tx["a"].push_block(torch.arange(3.0).reshape(3, 1) + 3 * b)
        rx.wait(timeout=10)
    finally:
        tx["a"].end_of_stream()
        tx.wait(timeout=10)
        tx.stop()
        rx.stop()
    assert calls == [(3, 1), (3, 1)]
    assert sorted(ints(rx["out"].frames)) == list(range(6))


@pytest.mark.parametrize("idl", ["flex", "protobuf", "flatbuf"])
@pytest.mark.parametrize("sink_pkg", ["jax", "torch"])
def test_across_packages(sink_pkg, idl):
    """One package's sink client feeds the other's source server in the
    ``idl`` codec: values equal, and pts where the codec carries them."""
    from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse

    parse = {"jax": jax_parse, "torch": parse_pipeline}
    src_pkg = "torch" if sink_pkg == "jax" else "jax"
    rx = started(f"tensor_src_grpc name=src server=true port=0 num-buffers=3 timeout=8000 "
                 f"idl={idl} ! tensor_sink name=out", parse[src_pkg])
    tx = started(f"appsrc name=a ! tensor_sink_grpc server=false port={rx['src'].bound_port} "
                 f"idl={idl}", parse[sink_pkg])
    sent = [np.arange(6, dtype=np.float32).reshape(2, 3) * k for k in range(3)]
    try:
        for k, a in enumerate(sent):
            tx["a"].push(a, pts=0.25 * k)
        tx["a"].end_of_stream()
        tx.wait(timeout=10)
        rx.wait(timeout=10)
    finally:
        tx.stop()
        rx.stop()
    frames = rx["out"].frames
    assert len(frames) == 3
    assert all(np.array_equal(np.asarray(f.tensors[0]), a) for f, a in zip(frames, sent))
    if idl == "flatbuf":  # the nnstreamer.fbs schema carries no pts
        assert [f.pts for f in frames] == [None] * 3
    else:
        assert [f.pts for f in frames] == pytest.approx([0.0, 0.25, 0.5])
