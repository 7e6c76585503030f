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


def assert_meta_close(got, want, rtol=1e-6, atol=1e-6, path="meta", key=None):
    """Decoder meta of the port against the JAX package's: the same keys,
    list lengths, ints and strings, and floats within the tolerance
    (`atol` may map meta keys to their own, e.g. box coordinates in px)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_meta_close(got[k], want[k], rtol, atol, f"{path}[{k!r}]", k)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_meta_close(g, w, rtol, atol, f"{path}[{i}]", key)
    elif isinstance(want, float):
        assert isinstance(got, float), path
        tol = atol.get(key, atol.get(None, 1e-6)) if isinstance(atol, dict) else atol
        np.testing.assert_allclose(got, want, rtol=rtol, atol=tol, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def assert_decoded_equal(got, want, rtol=1e-6, atol=1e-6):
    """Decoded frames (or lists of them): RGBA canvases byte-equal, meta
    within the float tolerance."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_decoded_equal(g, w, rtol, atol)
        return
    assert got.pts == want.pts
    assert len(got.tensors) == len(want.tensors)
    for a, b in zip(got.tensors, want.tensors):
        a, b = host(a), host(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert_meta_close(got.meta, want.meta, rtol, atol)


def px_tolerance(size, keys=("x", "y", "w", "h")):
    """Meta tolerances for coordinates in px of an image of `size` px: 1e-6
    of the size (float32 decodes round at the scale of the normalized
    coordinates before they are scaled), 1e-6 for everything else."""
    return {None: 1e-6, **{k: 1e-6 * size for k in keys}}


def box_near_ties(scores, thr, dets, iou_thr, tie):
    """Near-ties of one frame's box decode that a rounding difference of
    `tie` could resolve either way: a candidate score (`scores`, every
    candidate) within `tie` of the threshold; two candidates of one class
    (`dets`, [N, 6] from the host decode) whose IoU is within `tie` of
    `iou_thr`; or two that overlap beyond ``iou_thr - tie`` with scores
    within `tie` (their order decides which one NMS keeps)."""
    from nnstreamer_tpu_torch.ops.nms import _iou_matrix

    n = int((np.abs(np.asarray(scores, np.float64) - thr) < tie).sum())
    for c in np.unique(dets[:, 5]):
        d = dets[dets[:, 5] == c]
        iou = _iou_matrix(torch.as_tensor(d[:, :4], dtype=torch.float32)).numpy().astype(np.float64)
        close = np.abs(d[:, 4, None] - d[None, :, 4]) < tie
        pairs = (np.abs(iou - iou_thr) < tie) | ((iou > iou_thr - tie) & close)
        n += int(np.triu(pairs, 1).sum())
    return n


def decoder_pipeline(parse, filter_props, mode, options, frames, extra="", batch=4):
    """``appsrc ! tensor_filter <filter_props> ! tensor_decoder mode=<mode>
    <options> <extra> ! tensor_sink`` over `frames` (pushed one by one,
    pts = index); returns (whether the decoder was fused, the sink's
    frames)."""
    pipe = parse(
        f"appsrc name=src ! tensor_filter name=f {filter_props} max-batch={batch} "
        f"batch-timeout=200 ! tensor_decoder name=d mode={mode} {options} {extra} "
        "! tensor_sink name=out")
    pipe.start()
    try:
        for i, x in enumerate(frames):
            pipe["src"].push(x, pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
        return pipe["d"]._fused, list(pipe["out"].frames)
    finally:
        pipe.stop()


def randomized_batchnorm(variables, seed=0):
    """A copy of a flax tree as numpy arrays, every ``BatchNorm_0``'s scale,
    bias, mean and var seeded (flax init leaves them trivial)."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for k in params:
            if k == "BatchNorm_0":
                c = np.asarray(params[k]["scale"]).shape
                params[k] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                             "bias": rng.normal(0, 0.1, c).astype(np.float32)}
                stats[k] = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            elif isinstance(params[k], dict) and k in stats:
                walk(params[k], stats[k])

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}

    out = copy(variables)
    walk(out["params"], out["batch_stats"])
    return out


def model_pair(family, port_module, props, seed=0):
    """One zoo family built float32 by both packages with the same weights:
    (jitted JAX fn, its variables, the port's module in eval mode with the
    converted tree loaded strictly, (JAX in, JAX out, port in, port out)
    specs)."""
    import jax

    from nnstreamer_tpu.models import build as jax_build
    from nnstreamer_tpu_torch.models import build as torch_build

    props = dict(props, dtype="float32")
    fn, variables, jax_in, jax_out = jax_build(family, props)
    variables = randomized_batchnorm(variables, seed)
    module, port_in, port_out = torch_build(family, props)
    module.load_state_dict(port_module.state_dict_from_flax(variables), strict=True)
    return jax.jit(fn), variables, module.eval(), (jax_in, jax_out, port_in, port_out)


def run_both(fn, variables, module, x):
    """(port outputs, JAX outputs) of one input as lists of numpy arrays."""
    want = [np.asarray(o) for o in fn(variables, [x])]
    with torch.inference_mode():
        got = module(torch.from_numpy(x))
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    return [g.numpy() for g in got], want


def midway_threshold(scores, per_frame):
    """A threshold midway between two neighbouring candidate scores, with
    about `per_frame` candidates of each frame above it on average."""
    s = np.sort(np.asarray(scores, np.float64).reshape(-1))[::-1]
    i = per_frame * int(np.asarray(scores).shape[0])
    return float((s[i - 1] + s[i]) / 2)


def spec_tuple(spec):
    """A stream schema of either package as comparable (shape, dtype, name)s."""
    return [(t.shape, np.dtype(t.dtype), t.name) for t in spec.tensors]
