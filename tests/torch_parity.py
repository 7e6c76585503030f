"""Helpers shared by the port's parity tests of the stream elements: run the
same pipeline text and the same pushes through the JAX package and the
port, and compare what the sinks received."""

import numpy as np
import torch

from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse


def run(parse, text, pushes=(), src="src", timeout=30):
    """Parse `text`, push each `(payload, pts)` into appsrc `src` (a payload
    is a tensor or a list of them; a dict maps source names to their own
    push lists), end every source's stream, wait and stop.  A pipeline
    without an appsrc `src` runs from its own sources."""
    pipe = parse(text)
    pipe.start()
    try:
        by_src = pushes if isinstance(pushes, dict) else (
            {src: pushes} if src in pipe.elements else {})
        for name, items in by_src.items():
            for payload, pts in items:
                pipe[name].push(payload, pts=pts)
        for name in by_src:
            pipe[name].end_of_stream()
        pipe.wait(timeout=timeout)
    finally:
        pipe.stop()
    return pipe


def host(t):
    """A payload as a host numpy array (torch tensors through .cpu())."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def assert_frames_equal(got, want, meta=()):
    """Same number of frames; per frame the same pts, the named meta keys,
    and tensors of the same dtype, shape and values (bit for bit)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pts == w.pts
        for k in meta:
            assert g.meta.get(k) == w.meta.get(k)
        assert len(g.tensors) == len(w.tensors)
        for a, b in zip(g.tensors, w.tensors):
            a, b = host(a), host(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def both(text, pushes=(), sinks=("out",), **kw):
    """Run `text` through both packages; returns {sink: (port frames, JAX
    frames)} after checking they are equal."""
    jp = run(jax_parse, text, pushes, **kw)
    tp = run(torch_parse, text, pushes, **kw)
    out = {}
    for s in sinks:
        assert_frames_equal(tp[s].frames, jp[s].frames)
        out[s] = (tp[s].frames, jp[s].frames)
    return out
