"""Real-model quantization accuracy: train CNNs on a real dataset, quantize
with real calibration data, and publish top-1 Δ (INT8/UINT8 vs FP32); the
port of tools/accuracy_eval.py.

The reference validates its quant tools on pretrained ImageNet models
(tools/quantize/README.md:96-135, per-layer cosine >= 0.95); with no
pretrained zoo at hand the equivalent is: train real models from scratch on
the one real vision dataset that ships with scikit-learn
(sklearn.datasets.load_digits — 1797 handwritten 8x8 digit images, the
classic UCI test set), quantize with calibration on real training images,
and measure true top-1 on the held-out test split.

Four architectures exercise the quantized conv paths:
  * digit_cnn     — plain conv+BN+ReLU+maxpool stack (vgg/resnet-style convs)
  * digit_dwnet   — depthwise-separable blocks (mobilenet-style dw+pw)
  * digit_resnet  — bottlenecks with a residual sum (the fused epilogue)
  * digit_widenet — every non-stem conv >= 64 channels (the native-int8 plan)

Pipeline per model: torch train -> convert.from_torch -> the port's IR ->
quantize_graph (uint8 minmax asymmetric per-tensor / int8 KL per-channel /
int8 EQ) -> top-1 on the test split through the compiled engine, on the
card unless --device names another.

With --reference, the quantized graph is additionally serialized to a
tmfile and evaluated through the reference C engine (libtengine-lite.so,
built by tools/build_reference.sh; TENGINE_REF_BUILD names its directory,
TENGINE_SOURCE the Tengine checkout with pytengine/) on the same test set.
With --publish the results go to the JSON file named by --out.

Usage: python -m tengine_tpu_torch.tools.accuracy_eval [--epochs N] [--publish --out F] [--reference]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

SEED = 0
# the reference C engine (tools/build_reference.sh)
REF_LIB_DIR = os.environ.get("TENGINE_REF_BUILD", "/tmp/tengine-build/source")
REF_LIB = os.path.join(REF_LIB_DIR, "libtengine-lite.so")


def load_digits_32():
    """sklearn digits upsampled 8x8 -> 32x32 (nearest), NCHW float in [-1, 1].

    Deterministic stratified 80/20 split."""
    try:
        from sklearn.datasets import load_digits
        from sklearn.model_selection import train_test_split
    except ImportError as e:
        raise RuntimeError(
            "accuracy_eval needs scikit-learn for its dataset (sklearn.datasets.load_digits)"
        ) from e

    d = load_digits()
    x = d.images.astype(np.float32)  # [N, 8, 8], values 0..16
    x = np.repeat(np.repeat(x, 4, axis=1), 4, axis=2)  # 32x32 nearest
    x = (x / 8.0 - 1.0)[:, None]  # [-1, 1], NCHW with C=1
    xtr, xte, ytr, yte = train_test_split(
        x, d.target, test_size=0.2, random_state=SEED, stratify=d.target
    )
    return xtr, ytr.astype(np.int64), xte, yte.astype(np.int64)


def build_models():
    import torch.nn as nn

    class DigitCNN(nn.Sequential):
        def __init__(self):
            super().__init__(
                nn.Conv2d(1, 16, 3, padding=1), nn.BatchNorm2d(16), nn.ReLU(),
                nn.MaxPool2d(2),
                nn.Conv2d(16, 32, 3, padding=1), nn.BatchNorm2d(32), nn.ReLU(),
                nn.MaxPool2d(2),
                nn.Conv2d(32, 64, 3, padding=1), nn.BatchNorm2d(64), nn.ReLU(),
                nn.MaxPool2d(2),
                nn.Flatten(),
                nn.Linear(64 * 4 * 4, 10),
            )

    def dw_block(cin, cout, stride):
        import torch.nn as nn

        return nn.Sequential(
            nn.Conv2d(cin, cin, 3, stride=stride, padding=1, groups=cin),
            nn.BatchNorm2d(cin), nn.ReLU(),
            nn.Conv2d(cin, cout, 1), nn.BatchNorm2d(cout), nn.ReLU(),
        )

    class DigitDWNet(nn.Sequential):
        def __init__(self):
            super().__init__(
                nn.Conv2d(1, 16, 3, stride=2, padding=1),
                nn.BatchNorm2d(16), nn.ReLU(),
                dw_block(16, 32, 1),
                dw_block(32, 64, 2),
                dw_block(64, 64, 1),
                nn.AvgPool2d(8),
                nn.Flatten(),
                nn.Linear(64, 10),
            )

    class Bottleneck(nn.Module):
        """resnet bottleneck: 1x1 -> 3x3 -> 1x1 + residual, trailing relu —
        exercises the fuse_conv_add epilogue / fuse_resnet_blocks chain
        kernel on trained weights."""

        def __init__(self, c, mid):
            super().__init__()
            self.path = nn.Sequential(
                nn.Conv2d(c, mid, 1), nn.BatchNorm2d(mid), nn.ReLU(),
                nn.Conv2d(mid, mid, 3, padding=1), nn.BatchNorm2d(mid), nn.ReLU(),
                nn.Conv2d(mid, c, 1), nn.BatchNorm2d(c),
            )
            self.relu = nn.ReLU()

        def forward(self, x):
            return self.relu(x + self.path(x))

    class DigitResNet(nn.Sequential):
        def __init__(self):
            super().__init__(
                nn.Conv2d(1, 32, 3, padding=1), nn.BatchNorm2d(32), nn.ReLU(),
                nn.MaxPool2d(2),
                Bottleneck(32, 16),
                Bottleneck(32, 16),
                nn.MaxPool2d(2),
                Bottleneck(32, 16),
                nn.AvgPool2d(8),
                nn.Flatten(),
                nn.Linear(32, 10),
            )

    class DigitWideNet(nn.Sequential):
        """wide-channel stack (every non-stem conv >= 64ch) that passes
        engine._native_profitable — the published top-1 table must cover the
        native-int8 tier that actually runs the resnet-class nets (the
        other digit archs are all small-channel and the auto-gate routes
        them to the legacy path)."""

        def __init__(self):
            super().__init__(
                nn.Conv2d(1, 64, 3, padding=1), nn.BatchNorm2d(64), nn.ReLU(),
                nn.MaxPool2d(2),
                nn.Conv2d(64, 64, 3, padding=1), nn.BatchNorm2d(64), nn.ReLU(),
                nn.MaxPool2d(2),
                nn.Conv2d(64, 128, 1), nn.BatchNorm2d(128), nn.ReLU(),
                nn.Conv2d(128, 64, 3, padding=1), nn.BatchNorm2d(64), nn.ReLU(),
                nn.MaxPool2d(2),
                nn.Flatten(),
                nn.Linear(64 * 4 * 4, 10),
            )

    return {
        "digit_cnn": DigitCNN(),
        "digit_dwnet": DigitDWNet(),
        "digit_resnet": DigitResNet(),
        "digit_widenet": DigitWideNet(),
    }


def train(model, xtr, ytr, xte, yte, epochs, seed=SEED):
    import torch

    torch.manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    lossf = torch.nn.CrossEntropyLoss()
    xt = torch.from_numpy(xtr)
    yt = torch.from_numpy(ytr)
    n = len(xt)
    for ep in range(epochs):
        model.train()
        perm = torch.randperm(n)
        for i in range(0, n, 64):
            idx = perm[i : i + 64]
            opt.zero_grad()
            loss = lossf(model(xt[idx]), yt[idx])
            loss.backward()
            opt.step()
    model.eval()
    with torch.no_grad():
        acc = (
            (model(torch.from_numpy(xte)).argmax(1).numpy() == yte).mean()
        )
    return float(acc)


def top1_ours(graph, x, y, quantized, batch=360, device=None, **opt_kw):
    """Top-1 of a (possibly quantized) graph through the port's compiled
    engine on `device`. opt_kw forwards Options fields (e.g.
    quant_relaxed=True for the relaxed tier's accuracy gate)."""
    from ..executor.engine import compile_graph
    from ..ops import qmath
    from ..utils.config import Options

    cg = compile_graph(graph, Options(batch_size=batch, quant_mode="fast", **opt_kw),
                       device=device)
    correct = 0
    for i in range(0, len(x), batch):
        xb = x[i : i + batch]
        pad = batch - len(xb)
        if pad:
            xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
        if quantized:
            t_in = graph.tensors[graph.input_tensors[0]]
            xb = qmath.quantize_np(xb, t_in.quant, t_in.dtype)
        out = cg.run(xb)[0]
        pred = out.reshape(batch, -1).argmax(1)[: batch - pad if pad else batch]
        correct += int((pred == y[i : i + len(pred)]).sum())
    return correct / len(x)


_REF_RUNNER = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[4])
from tengine import tg

tmfile, in_npy, out_npy = sys.argv[1:4]
x = np.load(in_npy)
graph = tg.Graph(None, 'tengine', tmfile)
itensor = graph.getInputTensor(0, 0)
itensor.shape = list(x[0:1].shape)
graph.preRun()
preds = []
for i in range(x.shape[0]):
    itensor.buf = np.ascontiguousarray(x[i:i+1])
    graph.run(1)
    t = graph.getOutputTensor(0, 0)
    preds.append(int(np.asarray(np.array(t.buf)).reshape(-1).argmax()))
np.save(out_npy, np.asarray(preds))
import os
os._exit(0)
"""


def top1_reference(graph, x, y, tmpdir):
    """Top-1 of the same quantized tmfile run by the reference C engine —
    per-image at the tmfile's native batch-1 shape (its fixed-dim Reshape
    nodes don't rebatch), one subprocess for all images. None when the
    library or the checkout is absent."""
    from ..ops import qmath
    from ..serializer.tm2.writer import save_tmfile

    source = os.environ.get("TENGINE_SOURCE")
    if not os.path.exists(REF_LIB) or not source:
        return None

    tmfile = os.path.join(tmpdir, "m.tmfile")
    save_tmfile(graph, tmfile)
    t_in = graph.tensors[graph.input_tensors[0]]
    xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
    in_npy = os.path.join(tmpdir, "in.npy")
    out_npy = os.path.join(tmpdir, "out.npy")
    np.save(in_npy, xq)
    env = dict(os.environ, LD_LIBRARY_PATH=REF_LIB_DIR)
    r = subprocess.run(
        [sys.executable, "-c", _REF_RUNNER, tmfile, in_npy, out_npy,
         os.path.join(source, "pytengine")],
        capture_output=True, text=True, env=env, timeout=600,
    )
    if not os.path.exists(out_npy):
        print("reference engine run failed:", r.stdout[-500:], r.stderr[-500:])
        return None
    pred = np.load(out_npy)
    return float((pred == y).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--calib", type=int, default=64, help="calibration images")
    ap.add_argument("--publish", action="store_true",
                    help="write the results' published block to --out")
    ap.add_argument("--out", default="accuracy_eval.json",
                    help="the JSON file --publish writes")
    ap.add_argument("--reference", action="store_true",
                    help="also score the quantized tmfile in the C engine")
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--seeds", type=int, default=1,
                    help="training/calibration seeds; >1 publishes mean±σ")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA card; "
                         "'cpu' runs on the CPU); training runs on the CPU")
    args = ap.parse_args(argv)

    import torch

    from ..convert.torch_frontend import from_torch
    from ..executor.engine import _native_profitable, resolve_device
    from ..graph.passes import optimize
    from ..quantize.quantizer import quantize_graph

    device = resolve_device(args.device)
    xtr, ytr, xte, yte = load_digits_32()

    results = {}
    for name in build_models():
        if args.models and name not in args.models:
            continue
        rows = []
        for seed in range(args.seeds):
            model = build_models()[name]
            rng = np.random.default_rng(seed)
            calib_idx = rng.choice(len(xtr), args.calib, replace=False)
            calib = [xtr[i : i + 1] for i in calib_idx]
            torch_acc = train(model, xtr, ytr, xte, yte, args.epochs, seed=seed)
            # convert-time fusions (BN fold etc.) — the reference's int8
            # tmfiles never contain BatchNormalization (its converter folds
            # it, and its CPU tier has no int8 BN kernel), so fold before
            # quantizing for a comparable artifact
            g = optimize(from_torch(model, torch.zeros(1, 1, 32, 32)))
            fp32 = top1_ours(g, xte, yte, quantized=False, device=device)
            row = {"torch_fp32_top1": torch_acc, "ours_fp32_top1": fp32}
            for scheme, algo in (
                ("uint8", "minmax"), ("int8", "kl"), ("int8", "eq"),
            ):
                qg = quantize_graph(g, calib, scheme=scheme, algorithm=algo, device=device)
                q1 = top1_ours(qg, xte, yte, quantized=True, device=device)
                key = f"{scheme}_{algo}"
                row[f"{key}_top1"] = q1
                row[f"{key}_delta_vs_fp32"] = q1 - fp32
                if algo != "eq":
                    # relaxed tier acceptance: top-1 delta vs the exact
                    # engine (chains on digit_resnet int8; the fused-add
                    # single-rounding epilogue on both schemes)
                    qr = top1_ours(qg, xte, yte, quantized=True, device=device,
                                   quant_relaxed=True)
                    row[f"{key}_relaxed_top1"] = qr
                    row[f"{key}_relaxed_delta_vs_exact"] = qr - q1
                    # native-int8 tier (to_native_int8 + 1-byte convs) on
                    # archs that pass the auto gate — digit_widenet
                    if _native_profitable(qg):
                        qn = top1_ours(qg, xte, yte, quantized=True, device=device,
                                       quant_relaxed=True, quant_native="on")
                        row[f"{key}_native_top1"] = qn
                        row[f"{key}_native_delta_vs_exact"] = qn - q1
                if args.reference:
                    with tempfile.TemporaryDirectory() as td:
                        r1 = top1_reference(qg, xte, yte, td)
                    if r1 is not None:
                        row[f"{key}_reference_engine_top1"] = r1
            rows.append(row)
            print(f"{name} seed {seed}:", json.dumps(
                {k: round(v, 4) for k, v in row.items()}))
        # aggregate over seeds: mean ± σ per metric
        agg = {
            "dataset": "sklearn_digits (1437 train / 360 test, 10 classes)",
            "n_seeds": len(rows),
        }
        for k in rows[0]:
            vals = [r[k] for r in rows if k in r]
            agg[k + "_mean"] = round(float(np.mean(vals)), 4)
            if len(vals) > 1:
                agg[k + "_std"] = round(float(np.std(vals, ddof=1)), 4)
        results[name] = agg
        print(name, json.dumps(agg, indent=2))

    if args.publish:
        published = {
            "provenance": (
                "models trained from scratch on the one real vision dataset "
                "that ships with scikit-learn (sklearn digits). "
                "Reproduce: python -m tengine_tpu_torch.tools.accuracy_eval --publish "
                f"--epochs {args.epochs} --seeds {args.seeds}"
                + (" --reference" if args.reference else "")
            ),
            "engine": f"tengine_tpu_torch on {device}",
            "metric": (
                "top-1 on held-out test split; delta = quantized - fp32; "
                "mean±std over training/calibration seeds; "
                "*_reference_engine_top1 = same tmfile scored by the "
                "reference C engine"
            ),
            "models": results,
        }
        with open(args.out, "w") as f:
            json.dump({"published": published}, f, indent=2)
        print(f"published to {args.out}")
    return results


if __name__ == "__main__":
    main()
