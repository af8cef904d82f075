"""Extra model families from the reference example zoo: segmentation (U-Net,
`examples/tm_unet.cpp`) and OCR (CRNN conv+LSTM+CTC, `examples/tm_crnn.cpp`)
(PyTorch port of tengine_tpu/models/extra.py: the same modules, seeds and
IR).

U-Net is defined as a torch module and imported through the fx front-end
(exercising Deconvolution / skip concats); CRNN is built directly as IR
(conv backbone -> sequence reshape -> stacked LSTM -> per-step FC),
exercising the recurrent ops in a full model. Weights are seeded random —
the reference benchmarks weight-stripped nets the same way
(tm2_serializer.c:241-246)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..graph.ir import DType, Graph, TensorType

__all__ = ["UNet", "build_unet_graph", "build_crnn_graph", "CRNN_CHARSET", "ctc_greedy_decode"]

# 0 = CTC blank, then digits + lowercase (the classic 37-class CRNN head)
CRNN_CHARSET = "-0123456789abcdefghijklmnopqrstuvwxyz"


def UNet(in_ch: int = 3, num_classes: int = 2, base: int = 16, depth: int = 3):
    """Small U-Net (encoder/decoder with skip concats, ConvTranspose2d up)."""

    class Block(nn.Module):
        def __init__(self, ci, co):
            super().__init__()
            self.c1 = nn.Conv2d(ci, co, 3, padding=1)
            self.b1 = nn.BatchNorm2d(co)
            self.c2 = nn.Conv2d(co, co, 3, padding=1)
            self.b2 = nn.BatchNorm2d(co)
            self.act = nn.ReLU()

        def forward(self, x):
            x = self.act(self.b1(self.c1(x)))
            return self.act(self.b2(self.c2(x)))

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            chs = [base * (2**i) for i in range(depth + 1)]
            self.enc = nn.ModuleList()
            ci = in_ch
            for co in chs:
                self.enc.append(Block(ci, co))
                ci = co
            self.pool = nn.MaxPool2d(2)
            self.up = nn.ModuleList(
                nn.ConvTranspose2d(chs[i + 1], chs[i], 2, stride=2)
                for i in reversed(range(depth))
            )
            self.dec = nn.ModuleList(
                Block(chs[i] * 2, chs[i]) for i in reversed(range(depth))
            )
            self.head = nn.Conv2d(chs[0], num_classes, 1)

        def forward(self, x):
            skips = []
            for i, blk in enumerate(self.enc):
                x = blk(x if i == 0 else self.pool(x))
                skips.append(x)
            for up, dec, skip in zip(self.up, self.dec, reversed(skips[:-1])):
                x = dec(torch.cat([up(x), skip], 1))
            return self.head(x)

    m = Model().eval()
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in m.parameters():
            if p.ndim > 1:
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(fan_in))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return m


def build_unet_graph(in_ch=3, num_classes=2, img=64, base=16, depth=3):
    """torch U-Net -> IR Graph via the fx front-end + the torch oracle."""
    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = UNet(in_ch, num_classes, base, depth)
    g = from_torch(m, torch.zeros(1, in_ch, img, img))
    g.name = "unet"
    return m, optimize(g)


def build_crnn_graph(
    num_classes: int = len(CRNN_CHARSET),
    img_w: int = 100,
    img_h: int = 32,
    hidden: int = 128,
    seed: int = 3,
):
    """CRNN OCR net as direct IR: VGG-ish conv backbone collapsing height to
    1, reshape to a [T, B, C] sequence, two stacked LSTMs (Tengine gate
    order I,O,F,G — lstm.c), FC per step to the charset logits.

    Returns (graph, weights dict) — the weights let tests build the oracle.
    """
    rng = np.random.default_rng(seed)
    g = Graph(name="crnn")
    weights = {}

    x = g.add_tensor("input", DType.FP32, [1, 1, img_h, img_w], TensorType.INPUT)
    g.inputs.append(g.add_node("InputOp", "input", [], [x.idx]).idx)
    cur = x.idx
    cur_c = 1

    def const(name, arr):
        arr = np.ascontiguousarray(arr, np.float32)
        weights[name] = arr
        return g.add_tensor(name, DType.FP32, list(arr.shape), TensorType.CONST, data=arr).idx

    def var(name):
        return g.add_tensor(name, DType.FP32, [], TensorType.VAR).idx

    def conv(name, co, k=3, s=1, p=1, relu=True):
        nonlocal cur, cur_c
        w = rng.standard_normal((co, cur_c, k, k)).astype(np.float32) / np.sqrt(cur_c * k * k)
        b = (rng.standard_normal(co) * 0.02).astype(np.float32)
        out = var(name)
        g.add_node(
            "Convolution", name, [cur, const(f"{name}/w", w), const(f"{name}/b", b)], [out],
            params=dict(kernel_h=k, kernel_w=k, stride_h=s, stride_w=s,
                        dilation_h=1, dilation_w=1, input_channel=cur_c,
                        output_channel=co, group=1, activation=0 if relu else -1,
                        pad_h0=p, pad_h1=p, pad_w0=p, pad_w1=p),
        )
        cur, cur_c = out, co

    def pool(name, kh, kw, sh, sw):
        nonlocal cur
        out = var(name)
        g.add_node(
            "Pooling", name, [cur], [out],
            params=dict(alg=0, kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                        global_pool=0, caffe_flavor=0, pad_h0=0, pad_h1=0,
                        pad_w0=0, pad_w1=0),
        )
        cur = out

    # backbone: 32xW -> 1x(W/4)
    conv("conv1", 32)
    pool("pool1", 2, 2, 2, 2)          # 16 x W/2
    conv("conv2", 64)
    pool("pool2", 2, 2, 2, 2)          # 8 x W/4
    conv("conv3", 96)
    conv("conv4", 96)
    pool("pool3", 2, 1, 2, 1)          # 4 x W/4
    conv("conv5", 128)
    conv("conv6", 128)
    pool("pool4", 2, 1, 2, 1)          # 2 x W/4
    conv("conv7", 128, k=2, p=0, relu=True)  # 1 x (W/4 - 1)

    seq_t = img_w // 4 - 1
    feat_c = cur_c

    # [N, C, 1, T] -> squeeze -> [N, C, T] -> permute -> [T, N, C]
    sq = var("squeeze")
    g.add_node("Squeeze", "squeeze", [cur], [sq], params=dict(dim_0=0, dim_1=0, dim_2=1, dim_3=0))
    pm = var("to_seq")
    g.add_node("Transpose", "to_seq", [sq], [pm], params=dict(perm=[2, 0, 1]))
    cur = pm

    def lstm(name, in_dim, h):
        nonlocal cur
        w = rng.standard_normal((4 * h, in_dim)).astype(np.float32) / np.sqrt(in_dim)
        r = rng.standard_normal((4 * h, h)).astype(np.float32) / np.sqrt(h)
        out = var(name)
        g.add_node(
            "LSTM", name, [cur, const(f"{name}/w", w), const(f"{name}/r", r)], [out],
            params=dict(hidden_size=h, cell_size=h, input_size=in_dim,
                        sequence_len=seq_t, output_len=h, forget_bias=0.0,
                        has_bias=0, mxnet_flag=0),
        )
        cur = out
        return out

    lstm("lstm1", feat_c, hidden)
    # LSTM out is [T, 1, B, H] -> back to [T, B, H] for stacking
    rs1 = var("rs1")
    g.add_node("Reshape", "rs1", [cur], [rs1],
               params=dict(shape=[seq_t, 1, hidden], is_onnx=1, is_mxnet=0, reverse=0))
    cur = rs1
    lstm("lstm2", hidden, hidden)
    rs2 = var("rs2")
    g.add_node("Reshape", "rs2", [cur], [rs2],
               params=dict(shape=[seq_t, hidden], is_onnx=1, is_mxnet=0, reverse=0))
    cur = rs2

    # per-step charset logits
    wf = rng.standard_normal((num_classes, hidden)).astype(np.float32) / np.sqrt(hidden)
    bf = (rng.standard_normal(num_classes) * 0.02).astype(np.float32)
    fc = var("logits")
    g.add_node("FullyConnected", "fc", [cur, const("fc/w", wf), const("fc/b", bf)], [fc],
               params=dict(num_output=num_classes))
    g.outputs.append(g.tensors[fc].producer)
    return g, weights


def ctc_greedy_decode(logits: np.ndarray, charset: str = CRNN_CHARSET) -> str:
    """[T, C] logits -> best-path CTC string (blank=0, collapse repeats) —
    the host-side decode in tm_crnn.cpp."""
    ids = np.argmax(logits, axis=-1)
    out = []
    prev = -1
    for i in ids:
        if i != prev and i != 0:
            out.append(charset[int(i)])
        prev = int(i)
    return "".join(out)
