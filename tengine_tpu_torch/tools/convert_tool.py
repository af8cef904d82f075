"""Model converter CLI: a model file of another framework -> tmfile
(Tengine's tools/convert_tool/convert_tool.cpp; the port of
tools/convert_tool.py, on the port's eight front ends, its optimize and
its TM2 writer). It runs on the host and touches no device.

Front-ends:
  * torch: a torchscript-able / fx-traceable nn.Module from a python file
  * onnx: .onnx file (self-contained protobuf decoder, convert/onnx_frontend)
  * tf: frozen GraphDef .pb (convert/tf_frontend; NHWC -> NCHW normalization)
  * caffe: -m deploy.prototxt -w weights.caffemodel (convert/caffe_frontend)
  * tflite: .tflite flatbuffer incl. full-integer quantized models — quant
    params import onto the quantized engine (convert/tflite_frontend)
  * darknet: -m model.cfg -w model.weights (convert/darknet_frontend)
  * mxnet: -m symbol.json -w model.params (convert/mxnet_frontend)
  * ncnn: -m model.param -w model.bin (convert/ncnn_frontend)
  * tengine: tmfile -> tmfile (useful with --optimize to run the fusion
    passes on an existing model)

    python -m tengine_tpu_torch.tools.convert_tool -f torch -m mymodel.py:build_model \\
        --input-shape 1,3,224,224 -o model.tmfile --optimize
    python -m tengine_tpu_torch.tools.convert_tool -f onnx -m model.onnx -o model.tmfile --optimize
    python -m tengine_tpu_torch.tools.convert_tool -f tengine -m in.tmfile -o out.tmfile --optimize
"""

import argparse
import importlib.util


def load_torch_model(spec: str):
    """`path.py:factory` -> nn.Module (factory takes no args)."""
    path, _, factory = spec.partition(":")
    mod_spec = importlib.util.spec_from_file_location("user_model", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    fn = getattr(mod, factory or "build_model")
    return fn()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--framework", default="torch",
                    choices=["torch", "onnx", "tf", "caffe", "tflite",
                             "darknet", "mxnet", "ncnn", "tengine"])
    ap.add_argument("-w", "--weights", default=None,
                    help="caffe: .caffemodel ; darknet: .weights ; "
                         "mxnet: .params ; ncnn: .bin")
    ap.add_argument("-m", "--model", required=True,
                    help="torch: file.py:factory ; tengine: input tmfile")
    ap.add_argument("-o", "--output", required=True, help="output tmfile")
    ap.add_argument("--input-shape", default="1,3,224,224")
    ap.add_argument("--optimize", action="store_true",
                    help="run fusion passes (conv+bn fold, relu fuse, dce)")
    args = ap.parse_args(argv)

    from ..serializer.tm2.reader import load_tmfile
    from ..serializer.tm2.writer import save_tmfile

    shape = [int(v) for v in args.input_shape.split(",")]

    if args.framework == "torch":
        import torch

        from ..convert.torch_frontend import from_torch

        model = load_torch_model(args.model)
        example = torch.zeros(*shape)
        g = from_torch(model, example)
        print(f"traced {type(model).__name__}: {len(g.nodes)} nodes")
    elif args.framework == "onnx":
        from ..convert.onnx_frontend import from_onnx

        g = from_onnx(args.model, input_shape=shape)
        print(f"imported {args.model}: {len(g.nodes)} nodes")
    elif args.framework == "tf":
        from ..convert.tf_frontend import from_tf_graphdef

        g = from_tf_graphdef(args.model, input_shape=shape)
        print(f"imported {args.model}: {len(g.nodes)} nodes")
    elif args.framework == "caffe":
        from ..convert.caffe_frontend import from_caffe

        g = from_caffe(args.model, args.weights, input_shape=shape)
        print(f"imported {args.model}: {len(g.nodes)} nodes")
    elif args.framework == "darknet":
        from ..convert.darknet_frontend import from_darknet

        g = from_darknet(args.model, args.weights)
        print(f"imported {args.model}: {len(g.nodes)} nodes")
    elif args.framework == "mxnet":
        from ..convert.mxnet_frontend import from_mxnet

        g = from_mxnet(args.model, args.weights, input_shape=shape)
        print(f"imported {args.model}: {len(g.nodes)} nodes")
    elif args.framework == "ncnn":
        from ..convert.ncnn_frontend import from_ncnn

        g = from_ncnn(args.model, args.weights, input_shape=shape)
        print(f"imported {args.model}: {len(g.nodes)} nodes")
    elif args.framework == "tflite":
        from ..convert.tflite_frontend import from_tflite

        g = from_tflite(args.model)
        print(f"imported {args.model}: {len(g.nodes)} nodes")
    else:
        g = load_tmfile(args.model)
        for tid in g.input_tensors:
            if not g.tensors[tid].shape:
                g.tensors[tid].shape = shape

    if args.optimize:
        from ..graph.passes import optimize

        before = sum(1 for n in g.nodes if n.outputs)
        optimize(g)
        after = sum(1 for n in g.nodes if n.outputs)
        print(f"optimize: {before} -> {after} live nodes")

    save_tmfile(g, args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
