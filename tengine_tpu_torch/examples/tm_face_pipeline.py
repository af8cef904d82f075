"""Two-stage face pipeline: RetinaFace detection -> MobileFaceNet embedding.

Equivalent of the reference's retinaface + mobilefacenet flow
(examples/tm_retinaface.c + tm_mobilefacenet.c, and the actor pipeline in
examples/pipeline/). Stage 1 runs the detector over the frame; stage 2 crops
each (letterboxed) face and batches them through the embedder — detector
and embedder fp32 here, the crop count padded to a max face count.

The default tmfiles are the benchmark zoo's, under benchmark/models relative
to the working directory (models/zoo.py:DEFAULT_MODEL_DIR).

    python -m tengine_tpu_torch.examples.tm_face_pipeline            # synthetic input demo
    python -m tengine_tpu_torch.examples.tm_face_pipeline -i img.jpg
"""

import argparse
import os
import time

import numpy as np

from ._runner import add_device, device_of

MAX_FACES = 8


def decode_retinaface(outputs, score_threshold=0.5):
    """Decode RetinaFace benchmark-graph outputs into face boxes.

    The benchmark tmfile emits raw per-stride score/bbox/landmark maps; with
    the stripped (random) weights of the benchmark model there are no real
    detections, so the caller falls back to a centered synthetic box to
    exercise stage 2.
    """
    boxes = []
    for out in outputs:
        if out.ndim == 4 and out.shape[1] == 2:  # softmax scores [1,2,H,W]
            probs = out[0, 1]
            ys, xs = np.where(probs > score_threshold)
            for y, x in zip(ys[:MAX_FACES], xs[:MAX_FACES]):
                boxes.append((x * 16, y * 16, x * 16 + 64, y * 16 + 64, probs[y, x]))
    return boxes[:MAX_FACES]


def main(argv=None):
    from ..models.zoo import DEFAULT_MODEL_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("--detector",
                    default=os.path.join(DEFAULT_MODEL_DIR, "retinaface_benchmark.tmfile"))
    ap.add_argument("--embedder",
                    default=os.path.join(DEFAULT_MODEL_DIR, "mobilefacenets_benchmark.tmfile"))
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import compile_graph, load_model, native
    from ..utils.config import Options

    rng = np.random.default_rng(0)

    # --- load frame ---
    if args.image:
        from PIL import Image

        frame = np.asarray(Image.open(args.image).convert("RGB"), np.uint8)
    else:
        frame = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)

    # --- stage 1: detector ---
    det = load_model(args.detector, fill_missing_weights="random")
    for tid in det.input_tensors:
        if not det.tensors[tid].shape:
            det.tensors[tid].shape = [1, 3, 320, 240]
    dh, dw = det.tensors[det.input_tensors[0]].shape[2:]
    det_cg = compile_graph(det, Options(precision="fp32_fast"), device=device)

    small = native.resize_bilinear(frame, dh, dw)
    x = native.normalize_chw(small, np.zeros(3, np.float32), np.ones(3, np.float32))[None]
    t0 = time.perf_counter()
    det_out = det_cg.run(x)
    detect_ms = (time.perf_counter() - t0) * 1e3
    print(f"stage1 detect: {len(det_out)} output maps, {detect_ms:.1f} ms")

    faces = decode_retinaface(det_out)
    if not faces:
        print("no detections (benchmark weights are random); using a synthetic face box")
        faces = [(dw // 4, dh // 4, 3 * dw // 4, 3 * dh // 4, 1.0)]

    # --- stage 2: embedder over batched crops ---
    emb = load_model(args.embedder, fill_missing_weights="random")
    for tid in emb.input_tensors:
        if not emb.tensors[tid].shape:
            emb.tensors[tid].shape = [1, 3, 112, 112]
    emb_cg = compile_graph(emb, Options(precision="fp32_fast", batch_size=MAX_FACES),
                           device=device)

    crops = np.zeros((MAX_FACES, 3, 112, 112), np.float32)
    scale_y, scale_x = frame.shape[0] / dh, frame.shape[1] / dw
    for i, (x0, y0, x1, y1, score) in enumerate(faces[:MAX_FACES]):
        fx0, fy0 = int(x0 * scale_x), int(y0 * scale_y)
        fx1, fy1 = int(x1 * scale_x), int(y1 * scale_y)
        crop = frame[max(fy0, 0) : max(fy1, 1), max(fx0, 0) : max(fx1, 1)]
        if crop.size == 0:
            continue
        aligned = native.letterbox(crop, 112, 112)
        crops[i] = native.normalize_chw(
            aligned, np.full(3, 127.5, np.float32), np.full(3, 1 / 128, np.float32)
        )

    t0 = time.perf_counter()
    (embeddings,) = emb_cg.run(crops)
    embed_ms = (time.perf_counter() - t0) * 1e3
    embeddings = embeddings.reshape(MAX_FACES, -1)[: len(faces)]
    norms = embeddings / (np.linalg.norm(embeddings, axis=1, keepdims=True) + 1e-9)
    print(
        f"stage2 embed: {len(faces)} faces -> {embeddings.shape[1]}-d, "
        f"{embed_ms:.1f} ms"
    )
    for i, (f, e) in enumerate(zip(faces, norms)):
        print(f"face {i}: box=({f[0]},{f[1]},{f[2]},{f[3]}) score={f[4]:.2f} "
              f"embed[:4]={np.round(e[:4], 4).tolist()}")
    return {"outs": det_out + [embeddings], "faces": faces, "embeddings": norms,
            "ms": (detect_ms, embed_ms)}


if __name__ == "__main__":
    main()
