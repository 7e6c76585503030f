"""Port parity: ``tensor_converter`` and the media schemas it negotiates
(``media/caps.py``) against the JAX package's, on the CPU.

The converter cases of ``tests/test_e2e_slice.py`` are covered here:
``frames-per-tensor`` grouping and octet mode.  So are video stride
removal (RGB, BGRx and GRAY8 at widths whose rows need 4-byte padding),
audio and text framing, ``emit-blocks``, and the schemas each derives.
Outputs must be byte-equal to the JAX element's.  Torch tensors pass
through untouched, or are stacked on their own device.  A converter
subplugin (``mode=``) raises, naming ROADMAP A4.2b.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu.media.caps import MediaSpec as JaxMediaSpec
from nnstreamer_tpu.media.caps import parse_media_caps as jax_parse_media
from nnstreamer_tpu.pipeline import make_element as jax_make
from nnstreamer_tpu_torch.core.buffer import BatchFrame, TensorFrame
from nnstreamer_tpu_torch.media.caps import MediaSpec, parse_media_caps, round_up_4
from nnstreamer_tpu_torch.pipeline import ElementError, make_element, parse_pipeline
from torch_parity import assert_frames_equal, both, host, run

torch.set_num_threads(2)


def test_frames_per_tensor():
    (got, _), = both("videotestsrc num-buffers=7 width=8 height=8 ! "
                     "tensor_converter frames-per-tensor=3 ! tensor_sink name=out",
                     timeout=20).values()
    assert len(got) == 2 and got[0].tensors[0].shape == (3, 8, 8, 3)


@pytest.mark.parametrize("dim,dtype", [("4:2", "uint16"), ("2:2", "float32"), ("16", "uint8")])
def test_octet_mode(dim, dtype):
    raw = np.arange(16, dtype=np.uint8)
    (got, _), = both(f"appsrc name=src ! tensor_converter input-dim={dim} input-type={dtype} "
                     "! tensor_sink name=out", [(raw, 0.0)]).values()
    out = got[0].tensors[0]
    assert out.dtype == np.dtype(dtype) and out.nbytes == 16


def test_tensor_streams_pass_through_and_get_pts():
    x = np.arange(6, dtype=np.int32)
    text = "appsrc name=src ! tensor_converter ! tensor_sink name=out to-host=false"
    got = run(parse_pipeline, text, [(x, 3.0), (torch.from_numpy(x), None)])["out"].frames
    assert got[0].tensors[0] is x and got[0].pts == 3.0
    assert isinstance(got[1].tensors[0], torch.Tensor) and got[1].pts is not None


@pytest.mark.parametrize("emit_blocks", [False, True])
def test_torch_frames_stack_on_their_device(emit_blocks):
    xs = [np.full((2, 3), i, np.uint8) for i in range(5)]
    text = (f"appsrc name=src ! tensor_converter frames-per-tensor=2 emit-blocks={emit_blocks} "
            "! tensor_sink name=out to-host=false split-batches=false")
    want = run(parse_pipeline, text, [(x, float(i)) for i, x in enumerate(xs)])["out"].frames
    got = run(parse_pipeline, text, [(torch.from_numpy(x), float(i))
                                     for i, x in enumerate(xs)])["out"].frames
    assert all(isinstance(t, torch.Tensor) for f in got for t in f.tensors)
    assert_frames_equal(got, want)
    assert len(got) == (3 if emit_blocks else 2)  # a partial block is emitted, a group not
    assert all(isinstance(f, BatchFrame) == emit_blocks for f in got)


def _convert_both(caps, payload, **props):
    jel, el = jax_make("tensor_converter", **props), make_element("tensor_converter", **props)
    jmedia, media = jax_parse_media(caps), parse_media_caps(caps)
    jel.start()
    el.start()
    jel.set_sink_spec(0, JaxMediaSpec(media=jmedia))
    el.set_sink_spec(0, MediaSpec(media=media))
    want = jel.handle_frame(0, JaxFrame([payload], pts=0.0, meta={"media": jmedia}))
    got = el.handle_frame(0, TensorFrame([payload], pts=0.0, meta={"media": media}))
    assert_frames_equal([f for _, f in got], [f for _, f in want])
    assert all("media" not in f.meta for _, f in got)
    specs = [[(t.shape, t.dtype) for t in e.derive_spec().tensors] for e in (jel, el)]
    assert specs[0] == specs[1]
    return [f for _, f in got], el.derive_spec()


@pytest.mark.parametrize("fmt,channels", [("RGB", 3), ("BGRx", 4), ("GRAY8", 1)])
@pytest.mark.parametrize("width", [5, 6, 8])
def test_video_stride_removal(fmt, channels, width):
    caps = f"video/x-raw,format={fmt},width={width},height=3,framerate=30/1"
    stride = round_up_4(width * channels)
    rows = np.random.default_rng(width).integers(0, 256, (3, stride), dtype=np.uint8)
    frames, spec = _convert_both(caps, rows.reshape(-1))
    img = frames[0].tensors[0]
    assert img.shape == (3, width, channels) == spec.tensors[0].shape and spec.framerate == 30
    np.testing.assert_array_equal(img.reshape(3, -1), rows[:, :width * channels])


def test_audio_and_text_framing():
    pcm = np.arange(12, dtype="<i2")
    frames, _ = _convert_both("audio/x-raw,format=S16LE,rate=16000,channels=2",
                              pcm.view(np.uint8))
    np.testing.assert_array_equal(frames[0].tensors[0], pcm.reshape(6, 2))
    text = np.frombuffer(b"hello", np.uint8)
    frames, spec = _convert_both("text/x-raw,format=utf8", text, **{"input-dim": "8"})
    assert bytes(frames[0].tensors[0]) == b"hello\0\0\0" and spec.tensors[0].shape == (8,)


@pytest.mark.parametrize("caps,size,props,match", [
    ("video/x-raw,format=RGB,width=5,height=2", 7, {}, "video payload 7B != height 2 x stride 16"),
    ("application/octet-stream", 5, {"input-dim": "4", "input-type": "uint16"},
     "octet payload 5B != schema 8B"),
    ("audio/x-raw,format=S16LE,channels=2", 6, {}, "not a multiple of frame size 4B"),
], ids=["video", "octet", "audio"])
def test_media_errors_as_jax(caps, size, props, match):
    from nnstreamer_tpu.pipeline import ElementError as JaxElementError

    for make, frame, parse_media, err in (
            (jax_make, JaxFrame, jax_parse_media, JaxElementError),
            (make_element, TensorFrame, parse_media_caps, ElementError)):
        el = make("tensor_converter", **props)
        el.start()
        with pytest.raises(err, match=match):
            el.handle_frame(0, frame([np.zeros(size, np.uint8)],
                                     meta={"media": parse_media(caps)}))


def test_media_payloads_must_be_host_bytes():
    el = make_element("tensor_converter", **{"input-dim": "4"})
    with pytest.raises(ElementError, match="host bytes"):
        el.handle_frame(0, TensorFrame([torch.zeros(4, dtype=torch.uint8)]))


def test_media_caps_parse_and_intersect():
    m = parse_media_caps("video/x-raw,format=RGB,width=6,height=4,framerate=30/1")
    a = parse_media_caps("audio/x-raw,format=S16LE,rate=16000,channels=2")
    assert (m.stride, m.row_bytes, a.bytes_per_frame) == (20, 18, 4)
    assert MediaSpec(media=m).intersect(MediaSpec(media=m)).media == m
    assert MediaSpec(media=m).intersect(MediaSpec(media=a)) is None
    assert m.caps_string() == jax_parse_media(m.caps_string()).caps_string()


def test_subplugin_mode_raises_naming_the_roadmap():
    with pytest.raises(ElementError, match="ROADMAP A4.2b"):
        parse_pipeline("appsrc ! tensor_converter mode=custom:tokenizer ! tensor_sink").start()
    el = make_element("tensor_converter")
    with pytest.raises(ElementError, match="ROADMAP A4.2b"):
        el.handle_frame(0, TensorFrame([b"\x00" * 8]))
    assert host(el.handle_frame(0, TensorFrame([np.int8([1])]))[0][1].tensors[0]) == 1
