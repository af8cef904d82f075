"""Int8 GEMM with fused per-channel requantization: the CUDA kernel of
csrc/qconv.cu launched as a flat [M, K] × [K, N] product, its plain PyTorch
version, and the wrapper that picks between them by device.

Replaces the Pallas TPU kernel tengine_tpu/ops/pallas/qgemm.py:
qgemm_requant — the int-storage tier's pointwise-conv and FC engine:

    x'       = x - 128                          (uint8 operands, in the kernel)
    acc[m,n] = sum_k x'[m,k] * w[k,n]           exact int32
    q[m,n]   = (float(acc) + cw*float(rowsum x'[m])) * M[n] + B[n]
    out      = clip(round_half_away(act clamp around zp_out), lo, hi)

B folds the bias, the colsum / K·cx·cw zero-point terms and zp_out on the
host (ops/quantized.py:_qgemm_inputs), as the JAX lowering folds them.

On the card it is bound by bytes at yolov3-416 batch 8 (the 1×1 convs with
C_in, C_out >= 128 do under 200 int8 operations per byte moved; the card
balances 1,979 TOP/s against 3.35 TB/s of HBM at 590). It is the kh = kw = 1
case of the one int8 tensor-core implicit-GEMM kernel (mma.sync fed by
cp.async; design note in csrc/qconv.cu), with the tile picked per shape by
ops/cuda/qconv.py:pick_tile; the TPU kernel's M/N padding to its tiles has no
counterpart: the kernel masks ragged edges.
"""

from __future__ import annotations

import numpy as np

from .qconv import CHUNK, _dispatch, _ru, launch_igemm, qconv1x1_plain

SOURCE = "tengine_tpu_torch/csrc/qconv.cu"
REPLACES = "tengine_tpu/ops/pallas/qgemm.py:104"


def pack_qgemm_weights(w_flat: np.ndarray, is_u8: bool) -> np.ndarray:
    """Host-side repack: [O, K] stored weights -> [O, 1, Kp] int8, re-centred
    by -128 when the source is uint8, K zero-padded to a multiple of 32."""
    O, K = w_flat.shape
    t = np.asarray(w_flat)
    t = (t.astype(np.int16) - 128).astype(np.int8) if is_u8 else t.astype(np.int8)
    out = np.zeros((O, 1, _ru(K, CHUNK)), np.int8)
    out[:, 0, :K] = t
    return out


def qgemm_requant_plain(x, w, mult, bias, *, cw=0, act=-1, inv_s_out=1.0, zp_out=0,
                        lo=-127, hi=127, out_dtype="int8"):
    """The plain PyTorch version of qgemm_requant: x [M, K], w [N, 1, Kp]."""
    return qconv1x1_plain(x, w, mult, bias, cw=cw, act=act, inv_s_out=inv_s_out,
                          zp_out=zp_out, lo=lo, hi=hi, out_dtype=out_dtype)


def qgemm_requant(x, w, mult, bias, *, cw=0, act=-1, inv_s_out=1.0, zp_out=0,
                  lo=-127, hi=127, out_dtype="int8", tile=None):
    """[M, K] × [K, N] int8 GEMM + requant: x [M, K] s8/u8, w [N, 1, Kp] from
    pack_qgemm_weights, mult/bias f32 [N]. Returns [M, N]. Kernel on a CUDA
    tensor, qgemm_requant_plain on a CPU or meta tensor;
    qgemm_requant.launches counts kernel launches; tile forces one of
    ops/cuda/qconv.py:TILES."""
    M, K = map(int, x.shape)
    ep = dict(cw=cw, act=act, inv_s_out=inv_s_out, zp_out=zp_out, lo=lo, hi=hi,
              out_dtype=out_dtype)

    def kernel():
        out = launch_igemm(
            "qgemm_requant", x, w, mult, bias, None, None, n=1, h=1, w_in=M, c=K,
            oh=1, ow=M, kh=1, kw=1, stride=1, pad_t=0, pad_l=0, zp_in=0,
            out_shape=(M, int(w.shape[0])), tile=tile, **ep,
        )
        qgemm_requant.launches += 1
        return out

    return _dispatch("qgemm_requant", x, kernel,
                     lambda: qgemm_requant_plain(x, w, mult, bias, **ep))


qgemm_requant.launches = 0
