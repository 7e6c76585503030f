"""nns-tpu-torch-convert: ahead-of-time model conversion to the port's
native format.

Port of ``nnstreamer_tpu/cli/convert.py``.  Imports a third-party model
(``.tflite`` / ``.onnx``) with the port's importers, wraps the lowered graph
as ``ImportedGraph`` and saves it as a ``.pt2`` ``torch.export`` program
(``backends/torch_cuda.py`` ``export_model``): the weights inside, the
port's kernels as ``nns_torch::`` operators, no importer in the serving
path::

    nns-tpu-torch-convert mobilenet_v2_quant.tflite model.pt2 --int8
    nns-tpu-torch-launch "appsrc ! tensor_filter framework=auto model=model.pt2 ! ..."

Options:
  --fixed                         export the file's declared shapes only
                                  (default: a symbolic leading batch dim)
  --int8                          tflite quantized models: convolutions,
                                  depthwise convolutions and dense layers
                                  on the int8 kernels, as ``custom=int8:true``
  --fake-quant=off                tflite: relax per-tensor requantization
                                  (range clamps kept)

A graph with an op that mixes the frames of a micro-batch cannot take the
symbolic batch: the conversion then refuses, naming ``--fixed``, whose
program serves a micro-batch frame by frame.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def _unfoldable(err: BaseException):
    """The ``Unfoldable`` behind an export failure, if one is."""
    from ..importers.tflite_lower import Unfoldable

    seen = set()
    while err is not None and id(err) not in seen:
        if isinstance(err, Unfoldable):
            return err
        seen.add(id(err))
        err = err.__cause__ or err.__context__
    return None


def convert(src: str, dst: str, batch_polymorphic: bool = True,
            int8: bool = False, fake_quant: bool = True) -> dict:
    """Returns a summary dict (source, artifact, bytes, inputs, ops) for reporting."""
    from ..backends._importer_common import ImportedGraph
    from ..backends.torch_cuda import export_model

    ext = os.path.splitext(src)[1].lower()
    if ext == ".tflite":
        from ..importers.tflite_lower import _Lowering
        from ..importers.tflite_reader import read_tflite

        model = read_tflite(src)
        lowering = _Lowering(model, fake_quant=fake_quant, int8_compute=int8)
        frame_specs = [(model.tensors[i].shape, model.tensors[i].dtype) for i in model.inputs]
        module = ImportedGraph(lowering, lowering.params(), [len(s) for s, _ in frame_specs],
                               lowering.int8_params())
        histogram = model.op_histogram()
    elif ext == ".onnx":
        from ..importers.onnx_lower import _Lowering
        from ..importers.onnx_reader import read_onnx

        model = read_onnx(src)
        lowering = _Lowering(model)
        frame_specs = []
        for vi in model.inputs:
            if vi.shape is None or vi.dtype is None or any(
                    d is None or d < 0 for d in vi.shape):
                raise SystemExit(f"{src}: input {vi.name!r} has dynamic dims; "
                                 "conversion needs concrete shapes")
            frame_specs.append((vi.shape, vi.dtype))
        module = ImportedGraph(lowering, lowering.params(), [len(s) for s, _ in frame_specs])
        histogram = model.op_histogram()
    else:
        raise SystemExit(f"unsupported source format {ext!r} (want .tflite or .onnx)")
    lowering.drop_host_consts()  # the module's buffers hold them
    try:
        export_model(module, frame_specs, dst, batch_polymorphic=batch_polymorphic)
    except Exception as e:  # noqa: BLE001 -- only the Unfoldable case is rephrased
        why = _unfoldable(e)
        if why is None or not batch_polymorphic:
            raise
        raise SystemExit(f"{src}: cannot export a symbolic batch: {why}; convert with --fixed "
                         "(a micro-batch then runs frame by frame)") from e
    return {
        "source": src,
        "artifact": dst,
        "bytes": os.path.getsize(dst),
        "inputs": [tuple(s) for s, _ in frame_specs],
        "ops": histogram,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="nns-tpu-torch-convert", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help="source model (.tflite or .onnx)")
    ap.add_argument("dst", nargs="?", default=None,
                    help="output program (default: <src>.pt2)")
    ap.add_argument("--fixed", action="store_true",
                    help="export the file's declared shapes only (no symbolic batch dim)")
    ap.add_argument("--int8", action="store_true",
                    help="tflite: the int8 kernels, as custom=int8:true")
    ap.add_argument("--fake-quant", choices=("on", "off"), default="on")
    args = ap.parse_args(argv)

    dst = args.dst or os.path.splitext(args.src)[0] + ".pt2"
    summary = convert(
        args.src, dst,
        batch_polymorphic=not args.fixed,
        int8=args.int8,
        fake_quant=args.fake_quant == "on",
    )
    ops = ", ".join(f"{k}×{v}" for k, v in sorted(summary["ops"].items()))
    print(f"{summary['source']} -> {summary['artifact']} "
          f"({summary['bytes']} bytes)")
    print(f"  inputs: {summary['inputs']}")
    print(f"  ops: {ops}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
