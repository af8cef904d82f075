"""Transformer model family — SegFormer (examples/tm_segformer.cpp) and a
plain ViT classifier.

The reference runs SegFormer as a converted ONNX model through its generic
op set (matmul/softmax/layernorm-as-primitives); here the same family is a
clean-room torch module imported through the torch front-end, exercising
the transformer op path no CNN family touches: LayerNorm, ND Linear
(MatMul), SwapAxis/Transpose attention plumbing, scalar-div scaling,
softmax over tokens, and GELU MixFFN with a depthwise 3x3 mixer.
Weights are seeded random (reference benchmarks weight-stripped nets the
same way, tm2_serializer.c:241-246).

PyTorch port: a copy of tengine_tpu/models/transformer_zoo.py — the same
modules, built through the port's own torch frontend and optimize
pipeline, so after one torch.manual_seed both packages build the same IR.
The builders bake batch 1 into the token reshapes.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SegFormerLite",
    "ViTLite",
    "build_segformer_graph",
    "build_vit_graph",
    "segformer_classmap",
]


def _torch():
    import torch
    import torch.nn as nn

    return torch, nn


def SegFormerLite(num_classes: int = 19, img: int = 256,
                  dims=(32, 64, 128, 192), heads=(1, 2, 4, 8),
                  sr=(8, 4, 2, 1), depths=(2, 2, 2, 2), expand: int = 4):
    """Mix-Transformer (MiT) encoder + all-MLP decode head, B0-shaped.

    Stage s: OverlapPatchEmbed (conv k7/s4 then k3/s2) -> `depths[s]` blocks
    of [LN -> efficient self-attention (spatial-reduction sr[s]) -> +res,
    LN -> MixFFN (fc -> dw3x3 -> GELU -> fc) -> +res] -> LN. Decoder projects
    every stage to a common width, upsamples to 1/4 and fuses with a 1x1
    conv -> class map at stride 4."""
    torch, nn = _torch()

    class Attn(nn.Module):
        def __init__(self, c, h, w, nheads, sr_ratio):
            super().__init__()
            self.h, self.w, self.nh = h, w, nheads
            self.dh = c // nheads
            self.scale = float(self.dh) ** 0.5
            self.q = nn.Linear(c, c)
            self.k = nn.Linear(c, c)
            self.v = nn.Linear(c, c)
            self.proj = nn.Linear(c, c)
            self.sr_ratio = sr_ratio
            if sr_ratio > 1:
                self.sr = nn.Conv2d(c, c, sr_ratio, sr_ratio)
                self.norm = nn.LayerNorm(c)

        def forward(self, x):
            b, n, c = 1, self.h * self.w, self.q.in_features
            q = self.q(x).reshape(b, n, self.nh, self.dh).permute(0, 2, 1, 3)
            if self.sr_ratio > 1:
                xs = x.transpose(1, 2).reshape(b, c, self.h, self.w)
                xs = self.sr(xs)
                m = (self.h // self.sr_ratio) * (self.w // self.sr_ratio)
                xs = xs.reshape(b, c, m).transpose(1, 2)
                xs = self.norm(xs)
            else:
                xs, m = x, n
            k = self.k(xs).reshape(b, m, self.nh, self.dh).permute(0, 2, 3, 1)
            v = self.v(xs).reshape(b, m, self.nh, self.dh).permute(0, 2, 1, 3)
            attn = torch.matmul(q, k) / self.scale
            attn = torch.softmax(attn, dim=-1)
            out = torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(b, n, c)
            return self.proj(out)

    class MixFFN(nn.Module):
        def __init__(self, c, h, w, e):
            super().__init__()
            self.h, self.w, self.ce = h, w, c * e
            self.fc1 = nn.Linear(c, c * e)
            self.dw = nn.Conv2d(c * e, c * e, 3, 1, 1, groups=c * e)
            self.act = nn.GELU()
            self.fc2 = nn.Linear(c * e, c)

        def forward(self, x):
            y = self.fc1(x)
            y = y.transpose(1, 2).reshape(1, self.ce, self.h, self.w)
            y = self.dw(y)
            y = y.reshape(1, self.ce, self.h * self.w).transpose(1, 2)
            return self.fc2(self.act(y))

    class Block(nn.Module):
        def __init__(self, c, h, w, nh, sr_ratio, e):
            super().__init__()
            self.n1 = nn.LayerNorm(c)
            self.attn = Attn(c, h, w, nh, sr_ratio)
            self.n2 = nn.LayerNorm(c)
            self.ffn = MixFFN(c, h, w, e)

        def forward(self, x):
            x = x + self.attn(self.n1(x))
            return x + self.ffn(self.n2(x))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stages = nn.ModuleList()
            self.embeds = nn.ModuleList()
            self.norms = nn.ModuleList()
            self.hw = []
            cin, side = 3, img
            for s, c in enumerate(dims):
                k, st, p = (7, 4, 3) if s == 0 else (3, 2, 1)
                side = side // st
                self.embeds.append(nn.Conv2d(cin, c, k, st, p))
                self.stages.append(
                    nn.ModuleList(
                        [Block(c, side, side, heads[s], sr[s], expand)
                         for _ in range(depths[s])]
                    )
                )
                self.norms.append(nn.LayerNorm(c))
                self.hw.append(side)
                cin = c
            dec = 64
            self.linears = nn.ModuleList([nn.Linear(c, dec) for c in dims])
            self.ups = nn.ModuleList(
                [nn.Upsample(scale_factor=2 ** s, mode="nearest") for s in range(4)]
            )
            self.fuse = nn.Sequential(
                nn.Conv2d(4 * dec, dec, 1, bias=False), nn.BatchNorm2d(dec), nn.ReLU()
            )
            self.classify = nn.Conv2d(dec, num_classes, 1)

        def forward(self, x):
            feats = []
            for s in range(4):
                x = self.embeds[s](x)
                side = self.hw[s]
                x = x.reshape(1, self.embeds[s].out_channels, side * side).transpose(1, 2)
                for blk in self.stages[s]:
                    x = blk(x)
                x = self.norms[s](x)
                feats.append(x)
                # back to NCHW for the next stage's patch embed
                x = x.transpose(1, 2).reshape(
                    1, self.embeds[s].out_channels, side, side
                )
            maps = []
            for s in range(4):
                f = self.linears[s](feats[s])
                side = self.hw[s]
                f = f.transpose(1, 2).reshape(1, 64, side, side)
                maps.append(self.ups[s](f))
            y = self.fuse(torch.cat(maps[::-1], 1))
            return self.classify(y)

    return Net()


def build_segformer_graph(num_classes=19, img=256, dims=(32, 64, 128, 192),
                          depths=(2, 2, 2, 2)):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = SegFormerLite(num_classes, img, dims=dims, depths=depths)
    m.eval()
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "segformer"
    return m, optimize(g)


def segformer_classmap(logits: np.ndarray) -> np.ndarray:
    """[1, C, H/4, W/4] logits -> [H/4, W/4] int class map (the argmax the
    reference's tm_segformer example paints into an image)."""
    return np.asarray(logits)[0].argmax(axis=0).astype(np.int32)


def ViTLite(num_classes: int = 1000, img: int = 224, patch: int = 16,
            dim: int = 192, depth: int = 6, nheads: int = 3, expand: int = 4):
    """Plain ViT classifier (patch embed via conv, [CLS]-free mean-pool
    head) — the minimal attention net, for op-path tests and benches."""
    torch, nn = _torch()
    n_tok = (img // patch) ** 2

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.n1 = nn.LayerNorm(dim)
            self.q = nn.Linear(dim, dim)
            self.k = nn.Linear(dim, dim)
            self.v = nn.Linear(dim, dim)
            self.proj = nn.Linear(dim, dim)
            self.n2 = nn.LayerNorm(dim)
            self.fc1 = nn.Linear(dim, dim * expand)
            self.act = nn.GELU()
            self.fc2 = nn.Linear(dim * expand, dim)
            self.dh = dim // nheads
            self.scale = float(self.dh) ** 0.5

        def forward(self, x):
            y = self.n1(x)
            q = self.q(y).reshape(1, n_tok, nheads, self.dh).permute(0, 2, 1, 3)
            k = self.k(y).reshape(1, n_tok, nheads, self.dh).permute(0, 2, 3, 1)
            v = self.v(y).reshape(1, n_tok, nheads, self.dh).permute(0, 2, 1, 3)
            a = torch.softmax(torch.matmul(q, k) / self.scale, dim=-1)
            y = torch.matmul(a, v).permute(0, 2, 1, 3).reshape(1, n_tok, dim)
            x = x + self.proj(y)
            return x + self.fc2(self.act(self.fc1(self.n2(x))))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Conv2d(3, dim, patch, patch)
            self.pos = nn.Parameter(torch.zeros(1, n_tok, dim))
            self.blocks = nn.Sequential(*[Block() for _ in range(depth)])
            self.norm = nn.LayerNorm(dim)
            self.head = nn.Linear(dim, num_classes)

        def forward(self, x):
            x = self.embed(x)
            x = x.reshape(1, self.embed.out_channels, n_tok).transpose(1, 2)
            x = self.blocks(x + self.pos)
            x = self.norm(x)
            x = x.mean(1)  # mean over tokens
            return self.head(x)

    return Net()


def build_vit_graph(num_classes=1000, img=224, patch=16, dim=192, depth=6,
                    nheads=3):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = ViTLite(num_classes, img, patch, dim, depth, nheads)
    m.eval()
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "vit"
    return m, optimize(g)
