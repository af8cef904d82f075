// The fast tier's requantization: the f32 steps from an exact integer sum
// to a stored integer output (tengine_tpu_torch/ops/quantized.py:
// _requant_conv_out, lower_fc_quant_fast). Two kernels take them:
//
//   qrequant_kernel   (csrc/requant.cu) on the float64 sums of a library
//                     conv or FC, element by element in the output's order;
//   qconv_mma_kernel  (csrc/qconv.cu) in its fast-epilogue mode, on its
//                     int32 accumulators, in their own layout.
//
// Both start from f32(acc): __double2float_rn of an integer-valued double
// and __int2float_rn of the same int32 are the same float (round to nearest
// from the exact value), so the steps below give both kernels one result.
//
//   q = q * M[c] + B[c]                 two roundings (or q - zp_shift)
//   q = q + corr                        conv: per channel, per position
//   q = act(q)                          relu, relu1, relu-n, or SiLU as
//                                       q * (1 / (1 + expf(-(q * s_out))))
//   t = round_half_away(q) + zp_out     trunc, then +-1 where |q - t| >= .5
//   out = clip(t)                       or the fused residual r:
//     exact:   clip(round((((clip(t) - zp_out) * s_out) + (r - zp_r) * s_r)
//                     * inv2) + zp_out2), optional relu at zp_out2
//     relaxed: clip(round(q + r * beta) + zp_out), optional relu first
//
// Every f32 operation is a correctly rounded __f*_rn intrinsic (and the build
// has --fmad=false), expf is the full-precision one, not __expf, and the
// division is IEEE: these are the values ATen's CUDA kernels compute, so the
// output equals the plain version's (ops/cuda/requant.py) bit for bit.

#pragma once

#include <stdint.h>

// Mirrored field for field by RequantSteps in ops/cuda/requant.py (ctypes).
struct RequantSteps {
  int act;       // -1 none, 0 relu, 1 relu1, n > 1 relu-n, 100 SiLU
  int has_bias;  // + B[c]; without it, q - zp_shift where has_shift
  int has_shift;
  int has_corr;  // + a correction after the bias
  int res_mode;  // 0 none, 1 exact, 2 relaxed
  int res_u8, relu2;
  float zp_shift, s_out, a_lo, a_hi, zp_out, lo, hi;
  float s_r, zp_r, inv2, zp_out2, lo2, hi2, beta;
};

namespace requant_steps {

// C round(): trunc, then one step away from zero where the (exact) fraction
// is at least one half; what qmath.round_away computes.
__device__ __forceinline__ float round_away(float x) {
  const float t = truncf(x);
  return fabsf(__fsub_rn(x, t)) >= 0.5f ? __fadd_rn(t, copysignf(1.0f, x)) : t;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The stored output (an integer in [lo, hi], or [lo2, hi2] under an exact
// residual) of q = f32(acc): m = M[c], b = B[c] (read where has_bias), corr
// the late correction (where has_corr), rb the residual's stored byte (where
// res_mode is not 0).
//
// A caller that knows some of the steps when it is compiled says so, and
// the branches it rules out leave the code: SILU 1 (act is SiLU), 0 (it is
// not) or -1 (read act); RES 0 (no residual) or -1 (read res_mode). A
// branch left in is uniform, but the code on either side of it is not
// interleaved with the next element's: a kernel that applies the steps to
// many accumulators in a row leaves out what it can.
template <int SILU = -1, int RES = -1>
__device__ __forceinline__ float apply(const RequantSteps& s, float q, float m, float b, float corr,
                                       uint32_t rb) {
  const bool silu = SILU < 0 ? s.act == 100 : SILU == 1;
  const int res_mode = RES < 0 ? s.res_mode : RES;
  q = __fmul_rn(q, m);
  if (s.has_bias)
    q = __fadd_rn(q, b);
  else if (s.has_shift)
    q = __fsub_rn(q, s.zp_shift);
  if (s.has_corr) q = __fadd_rn(q, corr);
  if (silu) {
    // q * sigmoid(q * s_out), sigmoid as ATen's: 1 / (1 + exp(-z))
    const float z = __fmul_rn(q, s.s_out);
    q = __fmul_rn(q, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
  } else if (s.act == 1) {
    q = clip(q, s.a_lo, s.a_hi);
  } else if (s.act >= 0) {
    q = fmaxf(q, 0.0f);
    if (s.act > 0) q = fminf(q, s.a_hi);
  }
  const float r = s.res_u8 ? (float)(rb & 0xFFu) : (float)(int8_t)(rb & 0xFFu);
  if (res_mode == 2) {
    float y = __fadd_rn(q, __fmul_rn(r, s.beta));
    if (s.relu2) y = fmaxf(y, 0.0f);
    return clip(__fadd_rn(round_away(y), s.zp_out), s.lo, s.hi);
  }
  const float t = clip(__fadd_rn(round_away(q), s.zp_out), s.lo, s.hi);
  if (res_mode == 0) return t;
  const float tf = __fmul_rn(__fsub_rn(t, s.zp_out), s.s_out);
  const float rf = __fmul_rn(__fsub_rn(r, s.zp_r), s.s_r);
  float y = __fadd_rn(round_away(__fmul_rn(__fadd_rn(tf, rf), s.inv2)), s.zp_out2);
  if (s.relu2) y = fmaxf(y, s.zp_out2);
  return clip(y, s.lo2, s.hi2);
}

}  // namespace requant_steps
