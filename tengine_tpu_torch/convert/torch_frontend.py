"""Torch front-end: torch.nn.Module -> IR Graph (convert_tool equivalent).

The reference's convert_tool ingests 7 legacy formats (Caffe/ONNX/TF/TFLite/
MXNet/Darknet/ncnn — tools/convert_tool/) into its IR and runs fusion passes.
Our equivalent front-end ingests PyTorch models via torch.fx symbolic
tracing — the format today's users actually hold weights in — mapping
modules/functions onto the same TM2 op set, so converted graphs can be saved
as tmfiles (serializer/tm2/writer.py) and run by either engine. Conv+BN
folding (the converter-time fusion in graph_opt.cpp:624-947) is applied via
graph/passes.fold_batchnorm after import.

PyTorch port: a copy of tengine_tpu/convert/torch_frontend.py, so the two
packages build identical IR from one torch module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..graph.ir import DType, Graph, TensorType
from ..serializer.tm2.format import ELT_SUM, ELT_PROD, ELT_SUM_SCALAR, ELT_PROD_SCALAR


def from_torch(model, example_input) -> Graph:
    """Trace a torch.nn.Module and build an IR Graph.

    Supported: Conv2d (incl. groups/dilation), BatchNorm2d, Linear,
    ReLU/ReLU6/LeakyReLU/Sigmoid/Tanh/Hardswish/Hardsigmoid/SiLU/GELU/ELU/
    Softmax, MaxPool2d/AvgPool2d/AdaptiveAvgPool2d, Flatten, Dropout,
    Upsample, add/mul/cat/flatten/reshape/permute/mean.
    """
    import torch
    import torch.fx as fx

    model = model.eval()
    traced = fx.symbolic_trace(model)
    modules = dict(traced.named_modules())

    # Shape propagation: run the example through the fx graph so every node
    # carries meta['tensor_meta'].shape — used to pick FullyConnected (2D)
    # vs MatMul (token tensors) for nn.Linear, like onnx2tengine's
    # rank-dependent Gemm/MatMul split.
    try:
        from torch.fx.passes.shape_prop import ShapeProp

        ex = example_input if hasattr(example_input, "detach") else torch.as_tensor(example_input)
        ShapeProp(traced).propagate(ex)
    except Exception:
        pass

    def _rank(n) -> Optional[int]:
        tm = getattr(n, "meta", {}).get("tensor_meta")
        return len(tm.shape) if tm is not None and hasattr(tm, "shape") else None

    g = Graph(name=type(model).__name__)
    env: Dict[str, int] = {}  # fx node name -> tensor idx

    x = np.asarray(example_input.detach().cpu().numpy() if hasattr(example_input, "detach") else example_input)

    def const(name: str, arr: np.ndarray) -> int:
        t = g.add_tensor(name, DType.FP32, list(arr.shape), TensorType.CONST,
                         data=np.ascontiguousarray(arr, np.float32))
        return t.idx

    def var(name: str) -> int:
        return g.add_tensor(name, DType.FP32, [], TensorType.VAR).idx

    def emit(op: str, name: str, inputs: List[int], params: Optional[dict] = None,
             n_out: int = 1) -> List[int]:
        outs = [var(f"{name}/out{i}" if n_out > 1 else name) for i in range(n_out)]
        g.add_node(op, name, inputs, outs, params=params or {})
        return outs

    import torch.nn as nn
    import torch.nn.functional as F
    import operator

    _ACT_MODULES = {
        nn.ReLU: ("ReLu", {"negative_slope": 0.0}),
        nn.ReLU6: ("ReLu6", {}),
        nn.Sigmoid: ("Sigmoid", {}),
        nn.Tanh: ("Tanh", {}),
        nn.Hardswish: ("HardSwish", {"alpha": 1.0 / 6.0, "beta": 0.5}),
        nn.Hardsigmoid: ("Hardsigmoid", {"alpha": 1.0 / 6.0, "beta": 0.5}),
        nn.GELU: ("Gelu", {}),
        nn.ELU: ("Elu", {"alpha": 1.0}),
        nn.Softmax: None,  # handled below (axis)
        nn.Dropout: ("Dropout", {}),
        nn.Identity: ("Noop", {}),
    }

    for node in traced.graph.nodes:
        if node.op == "placeholder":
            t = g.add_tensor(node.name, DType.FP32, list(x.shape), TensorType.INPUT)
            inp = g.add_node("InputOp", node.name, [], [t.idx])
            g.inputs.append(inp.idx)
            env[node.name] = t.idx

        elif node.op == "get_attr":
            # free parameters/buffers referenced directly in forward
            # (e.g. ViT positional embeddings) become CONST tensors
            obj = traced
            for part in node.target.split("."):
                obj = getattr(obj, part)
            env[node.name] = const(node.name, obj.detach().cpu().numpy())

        elif node.op == "call_module":
            m = modules[node.target]
            xin = env[node.args[0].name]
            name = node.target.replace(".", "/")

            if isinstance(m, nn.ConvTranspose2d):
                # torch weight layout [in_c, out_c/group, kh, kw] == the
                # tmfile deconv IOHW layout (deconvolution.c) — no repack
                w = m.weight.detach().numpy()
                ins = [xin, const(f"{name}/w", w)]
                if m.bias is not None:
                    ins.append(const(f"{name}/b", m.bias.detach().numpy()))
                env[node.name] = emit(
                    "Deconvolution", name, ins,
                    dict(kernel_h=m.kernel_size[0], kernel_w=m.kernel_size[1],
                         stride_h=m.stride[0], stride_w=m.stride[1],
                         dilation_h=m.dilation[0], dilation_w=m.dilation[1],
                         num_output=m.out_channels, group=m.groups,
                         activation=-1,
                         pad_h0=m.padding[0], pad_h1=m.padding[0],
                         pad_w0=m.padding[1], pad_w1=m.padding[1],
                         output_pad_h0=m.output_padding[0],
                         output_pad_w0=m.output_padding[1]),
                )[0]
            elif isinstance(m, nn.Conv2d):
                w = m.weight.detach().numpy()
                ins = [xin, const(f"{name}/w", w)]
                if m.bias is not None:
                    ins.append(const(f"{name}/b", m.bias.detach().numpy()))
                env[node.name] = emit(
                    "Convolution", name, ins,
                    dict(kernel_h=m.kernel_size[0], kernel_w=m.kernel_size[1],
                         stride_h=m.stride[0], stride_w=m.stride[1],
                         dilation_h=m.dilation[0], dilation_w=m.dilation[1],
                         input_channel=m.in_channels, output_channel=m.out_channels,
                         group=m.groups, activation=-1,
                         pad_h0=m.padding[0], pad_h1=m.padding[0],
                         pad_w0=m.padding[1], pad_w1=m.padding[1]),
                )[0]
            elif isinstance(m, nn.BatchNorm2d):
                ins = [
                    xin,
                    const(f"{name}/gamma", m.weight.detach().numpy()),
                    const(f"{name}/beta", m.bias.detach().numpy()),
                    const(f"{name}/mean", m.running_mean.detach().numpy()),
                    const(f"{name}/var", m.running_var.detach().numpy()),
                ]
                env[node.name] = emit(
                    "BatchNormalization", name, ins,
                    dict(rescale_factor=1.0, eps=m.eps, caffe_flavor=0),
                )[0]
            elif isinstance(m, nn.Linear):
                w = m.weight.detach().numpy()
                rank = _rank(node.args[0])
                if rank is not None and rank > 2:
                    # token tensors [B, N, C] @ W^T (+ bias broadcast) — FC
                    # would wrongly flatten all trailing dims (fc.c flattens
                    # to [M, K]); MatMul keeps the token axis
                    out = emit("MatMul", name, [xin, const(f"{name}/wT", w.T)])[0]
                    if m.bias is not None:
                        out = emit(
                            "Eltwise", f"{name}_bias",
                            [out, const(f"{name}/b", m.bias.detach().numpy())],
                            dict(type=ELT_SUM, caffe_flavor=0, shift=0.0,
                                 power=1.0, scale=1.0),
                        )[0]
                    env[node.name] = out
                else:
                    ins = [xin, const(f"{name}/w", w)]
                    if m.bias is not None:
                        ins.append(const(f"{name}/b", m.bias.detach().numpy()))
                    env[node.name] = emit(
                        "FullyConnected", name, ins, dict(num_output=m.out_features)
                    )[0]
            elif isinstance(m, nn.LayerNorm):
                ins = [xin]
                if m.elementwise_affine:
                    ins += [const(f"{name}/g", m.weight.detach().numpy()),
                            const(f"{name}/b", m.bias.detach().numpy())]
                env[node.name] = emit("LayerNorm", name, ins, dict(eps=m.eps))[0]
            elif isinstance(m, nn.MaxPool2d) or isinstance(m, nn.AvgPool2d):
                k = m.kernel_size if isinstance(m.kernel_size, tuple) else (m.kernel_size,) * 2
                s = m.stride if isinstance(m.stride, tuple) else (m.stride or m.kernel_size,) * 2
                p = m.padding if isinstance(m.padding, tuple) else (m.padding,) * 2
                alg = 0 if isinstance(m, nn.MaxPool2d) else 1
                caffe = 1 if getattr(m, "ceil_mode", False) else 0
                if alg == 1 and getattr(m, "count_include_pad", True):
                    caffe |= 0x10
                env[node.name] = emit(
                    "Pooling", name, [xin],
                    dict(alg=alg, kernel_h=k[0], kernel_w=k[1], stride_h=s[0],
                         stride_w=s[1], global_pool=0, caffe_flavor=caffe,
                         pad_h0=p[0], pad_h1=p[0], pad_w0=p[1], pad_w1=p[1]),
                )[0]
            elif isinstance(m, nn.AdaptiveAvgPool2d):
                env[node.name] = emit(
                    "Pooling", name, [xin],
                    dict(alg=1, kernel_h=0, kernel_w=0, stride_h=1, stride_w=1,
                         global_pool=1, caffe_flavor=0, pad_h0=0, pad_h1=0,
                         pad_w0=0, pad_w1=0),
                )[0]
            elif isinstance(m, nn.Softmax):
                env[node.name] = emit("Softmax", name, [xin], dict(axis=m.dim or 1))[0]
            elif isinstance(m, nn.LeakyReLU):
                env[node.name] = emit(
                    "ReLu", name, [xin], dict(negative_slope=m.negative_slope)
                )[0]
            elif isinstance(m, nn.SiLU):
                # x * sigmoid(x): emit Sigmoid + BroadMul
                s_out = emit("Sigmoid", f"{name}/sigmoid", [xin])[0]
                env[node.name] = emit("BroadMul", name, [xin, s_out])[0]
            elif isinstance(m, nn.Flatten):
                env[node.name] = emit("Flatten", name, [xin],
                                      dict(axis=m.start_dim, end_axis=m.end_dim))[0]
            elif isinstance(m, nn.Upsample):
                sf = m.scale_factor if m.scale_factor else 2.0
                sf = float(sf if not isinstance(sf, tuple) else sf[0])
                if m.mode == "nearest":
                    env[node.name] = emit("Upsample", name, [xin], dict(scale=sf))[0]
                else:
                    env[node.name] = emit(
                        "Interp", name, [xin],
                        dict(resize_type=2, width_scale=sf, height_scale=sf,
                             output_width=0, output_height=0),
                    )[0]
            elif isinstance(m, nn.PixelShuffle):
                # torch pixel_shuffle is channel-major (CRD) depth-to-space
                env[node.name] = emit(
                    "DepthToSpace", name, [xin],
                    dict(block_size=int(m.upscale_factor), mode="CRD"),
                )[0]
            elif isinstance(m, nn.PixelUnshuffle):
                env[node.name] = emit(
                    "SpaceToDepth", name, [xin],
                    dict(block_size=int(m.downscale_factor), mode="CRD"),
                )[0]
            elif isinstance(m, nn.ChannelShuffle):
                env[node.name] = emit(
                    "ShuffleChannel", name, [xin], dict(group=int(m.groups))
                )[0]
            elif type(m) in _ACT_MODULES and _ACT_MODULES[type(m)]:
                op, params = _ACT_MODULES[type(m)]
                env[node.name] = emit(op, name, [xin], params)[0]
            else:
                raise NotImplementedError(f"torch module {type(m).__name__} ({node.target})")

        elif node.op == "call_function" or node.op == "call_method":
            fn = node.target
            name = node.name

            def arg_idx(a):
                return env[a.name]

            def _scalar_of(args):
                """(tensor, python-number) in either order, else None."""
                a, b = args[0], args[1]
                if isinstance(b, (int, float)):
                    return a, float(b)
                if isinstance(a, (int, float)):
                    return b, float(a)
                return None

            if fn in (operator.add, torch.add) or fn == "add":
                sc = _scalar_of(node.args)
                if sc is not None:
                    env[node.name] = emit(
                        "Eltwise", name, [arg_idx(sc[0])],
                        dict(type=ELT_SUM_SCALAR, caffe_flavor=0, shift=0.0,
                             power=1.0, scale=sc[1]),
                    )[0]
                else:
                    env[node.name] = emit(
                        "Eltwise", name, [arg_idx(node.args[0]), arg_idx(node.args[1])],
                        dict(type=ELT_SUM, caffe_flavor=0, shift=0.0, power=1.0, scale=1.0),
                    )[0]
            elif fn in (operator.mul, torch.mul) or fn == "mul":
                sc = _scalar_of(node.args)
                if sc is not None:
                    env[node.name] = emit(
                        "Eltwise", name, [arg_idx(sc[0])],
                        dict(type=ELT_PROD_SCALAR, caffe_flavor=0, shift=0.0,
                             power=1.0, scale=sc[1]),
                    )[0]
                else:
                    env[node.name] = emit(
                        "Eltwise", name, [arg_idx(node.args[0]), arg_idx(node.args[1])],
                        dict(type=ELT_PROD, caffe_flavor=0, shift=0.0, power=1.0, scale=1.0),
                    )[0]
            elif fn in (torch.cat,) or fn == "cat":
                tensors = node.args[0]
                axis = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", 0)
                env[node.name] = emit(
                    "Concat", name, [arg_idx(t) for t in tensors], dict(axis=axis)
                )[0]
            elif fn in (torch.flatten,) or fn == "flatten":
                start = node.args[1] if len(node.args) > 1 else node.kwargs.get("start_dim", 0)
                env[node.name] = emit(
                    "Flatten", name, [arg_idx(node.args[0])], dict(axis=start, end_axis=-1)
                )[0]
            elif fn == F.relu or fn == "relu":
                env[node.name] = emit("ReLu", name, [arg_idx(node.args[0])],
                                      dict(negative_slope=0.0))[0]
            elif fn == F.relu6:
                env[node.name] = emit("ReLu6", name, [arg_idx(node.args[0])])[0]
            elif fn == torch.sigmoid or fn == "sigmoid" or fn == F.sigmoid:
                env[node.name] = emit("Sigmoid", name, [arg_idx(node.args[0])])[0]
            elif fn in (F.softmax, torch.softmax) or fn == "softmax":
                axis = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", 1)
                env[node.name] = emit("Softmax", name, [arg_idx(node.args[0])],
                                      dict(axis=axis))[0]
            elif fn == F.adaptive_avg_pool2d:
                env[node.name] = emit(
                    "Pooling", name, [arg_idx(node.args[0])],
                    dict(alg=1, kernel_h=0, kernel_w=0, stride_h=1, stride_w=1,
                         global_pool=1, caffe_flavor=0, pad_h0=0, pad_h1=0,
                         pad_w0=0, pad_w1=0),
                )[0]
            elif fn == "view" or fn == "reshape" or fn == torch.reshape:
                shape = [
                    int(a) if not hasattr(a, "name") else -1
                    for a in (node.args[1:] if fn != torch.reshape else node.args[1])
                ]
                env[node.name] = emit(
                    "Reshape", name, [arg_idx(node.args[0])],
                    dict(shape=shape, is_onnx=1, is_mxnet=0, reverse=0),
                )[0]
            elif fn == "mean" or fn is torch.mean:
                dim = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
                if dim in ((2, 3), [2, 3]):  # spatial mean == global avg pool
                    env[node.name] = emit(
                        "Pooling", name, [arg_idx(node.args[0])],
                        dict(alg=1, kernel_h=0, kernel_w=0, stride_h=1, stride_w=1,
                             global_pool=1, caffe_flavor=0, pad_h0=0, pad_h1=0,
                             pad_w0=0, pad_w1=0),
                    )[0]
                else:  # general axis mean (e.g. token pooling) -> Reduction
                    dims = [dim] if isinstance(dim, int) else list(dim)
                    dims = (dims + [-2, -2, -2, -2])[:4]
                    keep = int(bool(node.kwargs.get("keepdim", False)))
                    env[node.name] = emit(
                        "Reduction", name, [arg_idx(node.args[0])],
                        dict(type=1, dim_0=dims[0], dim_1=dims[1], dim_2=dims[2],
                             dim_3=dims[3], keepdim=keep),
                    )[0]
            elif fn == "permute":
                order = list(node.args[1]) if isinstance(node.args[1], (tuple, list)) else list(node.args[1:])
                env[node.name] = emit("Transpose", name, [arg_idx(node.args[0])],
                                      dict(perm=order))[0]
            elif fn in (torch.matmul, torch.bmm) or fn in ("matmul", "bmm"):
                env[node.name] = emit(
                    "MatMul", name, [arg_idx(node.args[0]), arg_idx(node.args[1])]
                )[0]
            elif fn is torch.transpose or fn == "transpose":
                d0, d1 = int(node.args[1]), int(node.args[2])
                env[node.name] = emit(
                    "SwapAxis", name, [arg_idx(node.args[0])],
                    dict(dim_0=d0, dim_1=d1),
                )[0]
            elif fn == F.gelu or fn == "gelu":
                env[node.name] = emit("Gelu", name, [arg_idx(node.args[0])])[0]
            elif fn in (operator.truediv, torch.div) or fn == "div":
                a, b = node.args[0], node.args[1]
                assert isinstance(b, (int, float)), "only tensor/scalar div"
                env[node.name] = emit(
                    "Eltwise", name, [arg_idx(a)],
                    dict(type=ELT_PROD_SCALAR, caffe_flavor=0, shift=0.0,
                         power=1.0, scale=1.0 / float(b)),
                )[0]
            elif fn == getattr(operator, "getitem", None):
                # tensor slicing x[..., a:b:s, ...] -> StridedSlice
                # (strided_slice.c param layout: begin/end/stride per NCHW dim)
                index = node.args[1]
                if not isinstance(index, tuple):
                    index = (index,)
                # expand Ellipsis to full slices over a 4-D NCHW tensor
                n_explicit = sum(1 for i in index if i is not Ellipsis)
                idx: List[Any] = []
                for i in index:
                    if i is Ellipsis:
                        idx.extend([slice(None)] * (4 - n_explicit))
                    else:
                        idx.append(i)
                while len(idx) < 4:
                    idx.append(slice(None))
                if len(idx) != 4 or not all(isinstance(i, slice) for i in idx):
                    raise NotImplementedError(
                        f"unsupported torch getitem index {node.args[1]!r} "
                        "(only 4-D slice indexing)"
                    )
                # TM2 StridedSlice stores |end - begin| as a total CROP
                # amount, not an exclusive stop (strided_slice.c infer_shape:
                # out = ceil((in - |end-begin|)/stride)); convert torch's
                # exclusive-stop slices using the propagated input shape.
                src_meta = node.args[0].meta.get("tensor_meta")
                src_shape = list(src_meta.shape)
                params = {}
                for dim, (dname, s) in enumerate(zip("nchw", idx)):
                    size = int(src_shape[dim])
                    b = int(s.start or 0)
                    stop = int(s.stop) if s.stop is not None else size
                    stop = min(stop, size)
                    step = int(s.step or 1)
                    count = max(0, -(-(stop - b) // step))
                    if count == -(-size // step):
                        crop = 0  # full-length strided slice (focus pattern)
                    else:
                        crop = size - ((count - 1) * step + 1) if count else size
                    params[f"begin_{dname}"] = b
                    params[f"end_{dname}"] = b + crop
                    params[f"stride_{dname}"] = step
                env[node.name] = emit(
                    "StridedSlice", name, [arg_idx(node.args[0])], params
                )[0]
            else:
                raise NotImplementedError(f"torch function {fn} in traced graph")

        elif node.op == "output":
            arg = node.args[0]
            outs = arg if isinstance(arg, (tuple, list)) else [arg]
            for a in outs:
                g.outputs.append(g.tensors[env[a.name]].producer)

    return g
