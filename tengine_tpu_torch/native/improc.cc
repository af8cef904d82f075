// Native image preprocessing for the serving hot path.
//
// C++ equivalent of the reference's examples/common/tengine_operations.c
// (resize_image / letterbox / per-channel mean+scale normalize) plus the
// host-side input quantization step of the uint8 examples
// (tm_classification_uint8.c: round(x/scale)+zp clipped to [0,255]).
//
// Built with postproc.cc and tm2_parser.cc into one shared library under
// build/native/ and called through ctypes (native/__init__.py); every entry
// point has a numpy fallback so the package works without a compiler.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Bilinear resize HWC uint8 -> HWC uint8 (align_corners=false, half-pixel).
void tt_resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                           uint8_t* dst, int dh, int dw) {
  const float hs = (float)sh / dh;
  const float ws = (float)sw / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * hs - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * ws - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      const uint8_t* p00 = src + (y0 * sw + x0) * c;
      const uint8_t* p01 = src + (y0 * sw + x1) * c;
      const uint8_t* p10 = src + (y1 * sw + x0) * c;
      const uint8_t* p11 = src + (y1 * sw + x1) * c;
      uint8_t* q = dst + (y * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        float v = p00[k] * (1 - wy) * (1 - wx) + p01[k] * (1 - wy) * wx +
                  p10[k] * wy * (1 - wx) + p11[k] * wy * wx;
        q[k] = (uint8_t)std::min(std::max((int)std::lround(v), 0), 255);
      }
    }
  }
}

// HWC uint8 -> CHW fp32 with per-channel (x - mean) * scale
// (tengine_operations.c get_input_data semantics).
void tt_normalize_chw_f32(const uint8_t* src, int h, int w, int c,
                          const float* mean, const float* scale, float* dst) {
  for (int k = 0; k < c; ++k) {
    const float m = mean[k], s = scale[k];
    float* plane = dst + k * h * w;
    for (int i = 0; i < h * w; ++i) {
      plane[i] = ((float)src[i * c + k] - m) * s;
    }
  }
}

// fp32 -> uint8 quantized input: round(x/scale)+zp clip [0,255]
// (tm_classification_uint8.c input quantization).
void tt_quantize_u8(const float* src, int n, float scale, int zero_point,
                    uint8_t* dst) {
  const float inv = 1.0f / scale;
  for (int i = 0; i < n; ++i) {
    int v = (int)std::lround(src[i] * inv) + zero_point;
    dst[i] = (uint8_t)std::min(std::max(v, 0), 255);
  }
}

// Letterbox: resize keeping aspect ratio, pad with `pad_value`
// (examples/common letterbox used by the yolo demos). dst is dh x dw x c.
void tt_letterbox_u8(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                     int dh, int dw, uint8_t pad_value) {
  float r = std::min((float)dh / sh, (float)dw / sw);
  int nh = (int)std::lround(sh * r);
  int nw = (int)std::lround(sw * r);
  // temp resize into a stack-free buffer at the right offset
  std::memset(dst, pad_value, (size_t)dh * dw * c);
  // resize into temp then blit
  uint8_t* tmp = new uint8_t[(size_t)nh * nw * c];
  tt_resize_bilinear_u8(src, sh, sw, c, tmp, nh, nw);
  int oy = (dh - nh) / 2, ox = (dw - nw) / 2;
  for (int y = 0; y < nh; ++y) {
    std::memcpy(dst + ((y + oy) * dw + ox) * c, tmp + y * nw * c, (size_t)nw * c);
  }
  delete[] tmp;
}

// ---------------------------------------------------------------------------
// Threaded batch preprocessor — the data-loader hot path. Each image:
// bilinear resize to (out_h, out_w), per-channel (x-mean)*scale normalize to
// CHW fp32, optionally requantized to uint8 (round(v/qscale)+qzp). Images are
// distributed over a thread pool; this is the native analog of the per-image
// loops in the reference's example/benchmark harnesses, batched for serving.
//
//   imgs:  n pointers to HWC uint8 images, dims[i] = {h_i, w_i}
//   out:   [n, c, out_h, out_w] fp32, or uint8 when quantize != 0
// ---------------------------------------------------------------------------
void tt_preprocess_batch(const uint8_t** imgs, const int32_t* dims, int n,
                         int c, int out_h, int out_w, const float* mean,
                         const float* scale, int quantize, float qscale,
                         int qzp, void* out, int n_threads) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, n > 0 ? n : 1);
  const size_t plane = (size_t)out_h * out_w;
  const size_t img_elems = (size_t)c * plane;
  const float inv_q = quantize ? 1.0f / qscale : 0.0f;

  auto work = [&](int begin, int end) {
    std::vector<uint8_t> resized((size_t)out_h * out_w * c);
    for (int i = begin; i < end; ++i) {
      tt_resize_bilinear_u8(imgs[i], dims[2 * i], dims[2 * i + 1], c,
                            resized.data(), out_h, out_w);
      for (int k = 0; k < c; ++k) {
        const float m = mean[k], s = scale[k];
        if (!quantize) {
          float* dst = (float*)out + i * img_elems + k * plane;
          for (size_t p = 0; p < plane; ++p)
            dst[p] = ((float)resized[p * c + k] - m) * s;
        } else {
          uint8_t* dst = (uint8_t*)out + i * img_elems + k * plane;
          for (size_t p = 0; p < plane; ++p) {
            float v = ((float)resized[p * c + k] - m) * s;
            int q = (int)std::lround(v * inv_q) + qzp;
            dst[p] = (uint8_t)std::min(std::max(q, 0), 255);
          }
        }
      }
    }
  };

  if (n_threads <= 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int b = t * per, e = std::min(n, b + per);
    if (b >= e) break;
    pool.emplace_back(work, b, e);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// TM2 scanner: validate a tmfile and extract the const-buffer table
// (tensor_id, byte offset, byte size) without Python-side struct unpacking.
// Mirrors the pointer walk of tm2_serializer.c:835-913. Returns the number
// of const tensors found, or -1 on a malformed file. `table` must hold
// 3 * max_entries uint64.
// ---------------------------------------------------------------------------
long tt_tm2_scan_buffers(const uint8_t* data, long size, uint64_t* table,
                         long max_entries) {
  if (size < 12) return -1;
  auto u32 = [&](long off) -> uint32_t {
    uint32_t v;
    std::memcpy(&v, data + off, 4);
    return v;
  };
  uint16_t ver;
  std::memcpy(&ver, data, 2);
  if (ver != 2) return -1;
  uint32_t root = u32(8);
  if (root + 16 > (uint64_t)size) return -1;
  uint32_t off_subs = u32(root + 8);
  if (u32(off_subs) != 1) return -1;
  uint32_t sub = u32(off_subs + 4);
  uint32_t off_tensors = u32(sub + 12 + 12);
  uint32_t off_buffers = u32(sub + 12 + 16);
  uint32_t n_tensors = u32(off_tensors);
  long count = 0;
  for (uint32_t i = 0; i < n_tensors && count < max_entries; ++i) {
    uint32_t toff = u32(off_tensors + 4 + 4 * i);
    uint32_t tensor_id = u32(toff);
    uint32_t buffer_id = u32(toff + 4);
    int32_t ttype;
    std::memcpy(&ttype, data + toff + 24, 4);
    if (ttype != 2 /* TENSOR_TYPE_CONST */) continue;
    uint32_t boff = u32(off_buffers + 4 + 4 * buffer_id);
    uint32_t bsize = u32(boff);
    uint32_t bdata = u32(boff + 4);
    table[count * 3 + 0] = tensor_id;
    table[count * 3 + 1] = bdata;
    table[count * 3 + 2] = bsize;
    ++count;
  }
  return count;
}

}  // extern "C"
