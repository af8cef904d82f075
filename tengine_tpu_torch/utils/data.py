"""Threaded, prefetching image data loader — the serving/calibration input
pipeline.

The reference's examples and quant tools loop over images one at a time on
the caller's thread (examples/common/tengine_operations.c get_input_data,
tools/quantize/quant_tool_int8.cpp pass-1 loop). Here decode (PIL, releases
the GIL) runs on a worker pool, resize/normalize/quantize runs in the native
threaded preprocessor (native/improc.cc:tt_preprocess_batch), and batches are
prefetched on a background thread so the device never waits on the host.
(PyTorch port of tengine_tpu/utils/data.py, on the port's native layer.)
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")


def list_images(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMAGE_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _decode(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


class ImageBatchLoader:
    """Iterate (batch, paths) over image files with background prefetch.

    batch is [N,C,H,W] fp32 (normalized) or uint8 (input-quantized when
    `quant=(scale, zero_point)` is given — the uint8-model input path).
    """

    def __init__(
        self,
        paths: Sequence[str],
        out_hw: Tuple[int, int],
        batch_size: int = 8,
        mean: Sequence[float] = (0.0, 0.0, 0.0),
        scale: Sequence[float] = (1.0, 1.0, 1.0),
        quant: Optional[Tuple[float, int]] = None,
        decode_threads: int = 4,
        prefetch: int = 2,
        drop_last: bool = False,
    ):
        self.paths = list(paths)
        self.out_hw = out_hw
        self.batch_size = batch_size
        self.mean = list(mean)
        self.scale = list(scale)
        self.quant = quant
        self.decode_threads = decode_threads
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.paths) // self.batch_size
        if not self.drop_last and len(self.paths) % self.batch_size:
            n += 1
        return n

    def _make_batch(self, pool: ThreadPoolExecutor, chunk: List[str]):
        images = list(pool.map(_decode, chunk))
        h, w = self.out_hw
        batch = native.preprocess_batch(
            images, h, w, self.mean, self.scale, quant=self.quant
        )
        return batch, chunk

    def __iter__(self) -> Iterator[Tuple[np.ndarray, List[str]]]:
        chunks = [
            self.paths[i : i + self.batch_size]
            for i in range(0, len(self.paths), self.batch_size)
        ]
        if self.drop_last and chunks and len(chunks[-1]) < self.batch_size:
            chunks.pop()
        if not chunks:
            return
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.decode_threads) as pool:
                for chunk in chunks:
                    if stop.is_set():
                        break
                    try:
                        q.put(self._make_batch(pool, chunk))
                    except Exception as e:  # surface decode errors to consumer
                        q.put(e)
                        break
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def load_image_batch(
    paths: Sequence[str],
    out_hw: Tuple[int, int],
    mean: Sequence[float] = (0.0, 0.0, 0.0),
    scale: Sequence[float] = (1.0, 1.0, 1.0),
    quant: Optional[Tuple[float, int]] = None,
) -> np.ndarray:
    """One-shot convenience: decode + preprocess a list of files."""
    with ThreadPoolExecutor(min(8, max(1, len(paths)))) as pool:
        images = list(pool.map(_decode, paths))
    h, w = out_hw
    return native.preprocess_batch(images, h, w, mean, scale, quant=quant)
