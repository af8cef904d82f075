// Native TM2 (tmfile) serializer — the C++ analog of the reference's
// native model loader (source/serializer/tmfile/tm2_serializer.c:835-913 and
// the ~100 per-op param loaders under serializer/tmfile/op/tm2_*.c).
//
// Parses the whole TM2 layout — header, model, subgraph, tensors (dims,
// quant params, buffer table), nodes (inputs/outputs/op) and every per-op
// param record — with full bounds checking (the reference trusts the file;
// we do not), and emits one flat little-endian "wire" buffer that the Python
// side (serializer/tm2/reader.py:_graph_from_wire) turns into the IR.
// Weight payloads are NOT copied: the wire carries (offset, size) pairs and
// Python keeps zero-copy numpy views into the original blob, exactly like
// the reference's pointer fix-ups (tm2_serializer.c:251).
//
// Wire format (all u32/i32/f32 little-endian, strings are u32 len + bytes
// padded to 4):
//   "TTW1" u32 magic | i32 graph_layout | i32 model_layout | i32 orig_format
//   str model_name
//   u32 n_in  + u32[n_in]      graph input node ids
//   u32 n_out + u32[n_out]     graph output node ids
//   u32 n_tensors, then per tensor:
//     u32 id | i32 dtype | i32 ttype | str name
//     u32 n_dims + i32[n_dims]
//     u32 n_quant + n_quant * (i32 zp | f32 scale | i32 width)
//     u32 has_buffer | u32 buf_size | u32 buf_offset   (offsets into blob)
//   u32 n_nodes, then per node:
//     u32 id | u32 op_type | str name
//     u32 n_in + u32[n_in] | u32 n_out + u32[n_out]    tensor ids
//     u32 n_params, then per param: str key | u32 kind | payload
//       kind 0 i32 | 1 f32 | 2 bool(i32) | 3 vec_i32 | 4 vec_f32
//       kind 5 str | 6 anchors(u32 n + f32[4n]) | 7 u32
//
// The param field names and order are kept byte-identical to the Python
// parsers so tests can require native IR == Python IR on real tmfiles.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kNotSet = 0;  // TM2_NOT_SET

struct ParseError : std::runtime_error {
  explicit ParseError(const std::string& m) : std::runtime_error(m) {}
};

class Blob {
 public:
  Blob(const uint8_t* data, uint64_t size) : data_(data), size_(size) {}

  void check(uint64_t off, uint64_t n) const {
    if (off > size_ || n > size_ - off)
      throw ParseError("offset out of range: " + std::to_string(off) + "+" +
                       std::to_string(n) + " > " + std::to_string(size_));
  }
  uint32_t u32(uint64_t off) const {
    check(off, 4);
    uint32_t v;
    std::memcpy(&v, data_ + off, 4);
    return v;
  }
  int32_t i32(uint64_t off) const {
    check(off, 4);
    int32_t v;
    std::memcpy(&v, data_ + off, 4);
    return v;
  }
  float f32(uint64_t off) const {
    check(off, 4);
    float v;
    std::memcpy(&v, data_ + off, 4);
    return v;
  }
  uint8_t u8(uint64_t off) const {
    check(off, 1);
    return data_[off];
  }
  uint16_t u16(uint64_t off) const {
    check(off, 2);
    uint16_t v;
    std::memcpy(&v, data_ + off, 2);
    return v;
  }
  // TM2_String {u32 size, u32 offset_data} (tm2_format.h:360-364); cut at
  // first NUL like the Python reader.
  std::string str(uint64_t off) const {
    if (off == kNotSet) return "";
    uint32_t n = u32(off);
    uint32_t od = u32(off + 4);
    check(od, n);
    const char* p = reinterpret_cast<const char*>(data_ + od);
    size_t len = 0;
    while (len < n && p[len] != '\0') ++len;
    return std::string(p, len);
  }
  // TM2_Vector_* {u32 v_num, elem[v_num]}; returns element base offset.
  uint32_t vec(uint64_t off, uint32_t elem_bytes, uint32_t* n_out) const {
    if (off == kNotSet) {
      *n_out = 0;
      return 0;
    }
    uint32_t n = u32(off);
    check(off + 4, (uint64_t)n * elem_bytes);
    *n_out = n;
    return (uint32_t)(off + 4);
  }
  const uint8_t* ptr(uint64_t off) const { return data_ + off; }
  uint64_t size() const { return size_; }

 private:
  const uint8_t* data_;
  uint64_t size_;
};

class Writer {
 public:
  void u32(uint32_t v) { raw(&v, 4); }
  void i32(int32_t v) { raw(&v, 4); }
  void f32(float v) { raw(&v, 4); }
  void str(const std::string& s) {
    u32((uint32_t)s.size());
    raw(s.data(), s.size());
    while (buf_.size() % 4) buf_.push_back(0);
  }
  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf_.insert(buf_.end(), b, b + n);
  }
  std::vector<uint8_t>& buf() { return buf_; }

 private:
  std::vector<uint8_t> buf_;
};

// ---------------------------------------------------------------------------
// Per-op param schemas. A schema is a NUL-separated sequence of
// "<kind><name>" entries consumed sequentially from the param record;
// explicit skip entries keep offsets aligned with the C struct layouts
// (tm2_format.h:398-1015). Kinds:
//   i  i32        f  f32        u  u32
//   b  u8 bool (advances 1 byte; add 'x<n>' pads to realign)
//   I  u32 offset -> vec_i32    F  u32 offset -> vec_f32
//   A  u32 offset -> anchor vec (f32[n][4])
//   s  u32 offset -> string
//   x<digit> skip that many bytes
// ---------------------------------------------------------------------------

struct Field {
  char kind;
  int pad;  // for 'x'
  const char* name;
};

struct OpSchema {
  uint32_t op_type;
  std::vector<Field> fields;
};

// Op type constants (tm2_format.h:157-264) — only ops with params appear.
const std::vector<OpSchema>& schemas() {
  static const std::vector<OpSchema> kSchemas = {
      {1, {{'f', 0, "rescale_factor"}, {'f', 0, "eps"}, {'i', 0, "caffe_flavor"}}},  // BatchNorm
      {2, {{'f', 0, "scale_x"}, {'f', 0, "scale_y"}, {'i', 0, "type"}}},  // BilinearResize
      {3, {{'i', 0, "axis"}}},                                            // Concat
      {5,
       {{'i', 0, "kernel_h"}, {'i', 0, "kernel_w"}, {'i', 0, "stride_h"},
        {'i', 0, "stride_w"}, {'i', 0, "dilation_h"}, {'i', 0, "dilation_w"},
        {'i', 0, "input_channel"}, {'i', 0, "output_channel"}, {'i', 0, "group"},
        {'i', 0, "activation"}, {'i', 0, "pad_h0"}, {'i', 0, "pad_w0"},
        {'i', 0, "pad_h1"}, {'i', 0, "pad_w1"}}},  // Convolution (tm2_format.h TM2_ConvParam)
      {6,
       {{'i', 0, "num_output"}, {'i', 0, "kernel_h"}, {'i', 0, "kernel_w"},
        {'i', 0, "stride_h"}, {'i', 0, "stride_w"}, {'i', 0, "pad_w0"},
        {'i', 0, "pad_h0"}, {'i', 0, "pad_w1"}, {'i', 0, "pad_h1"},
        {'i', 0, "dilation_h"}, {'i', 0, "dilation_w"}, {'i', 0, "group"},
        {'i', 0, "activation"}, {'i', 0, "output_pad_h0"},
        {'i', 0, "output_pad_w0"}}},  // Deconvolution
      {7,
       {{'i', 0, "num_classes"}, {'i', 0, "keep_top_k"}, {'i', 0, "nms_top_k"},
        {'f', 0, "confidence_threshold"}, {'f', 0, "nms_threshold"}}},  // DetectionOutput
      {9,
       {{'u', 0, "type"}, {'i', 0, "caffe_flavor"}, {'f', 0, "shift"},
        {'f', 0, "power"}, {'f', 0, "scale"}}},  // Eltwise
      {10, {{'i', 0, "axis"}, {'i', 0, "end_axis"}}},  // Flatten
      {11, {{'i', 0, "num_output"}}},                  // FullyConnected
      {13,
       {{'i', 0, "local_size"}, {'f', 0, "alpha"}, {'f', 0, "beta"},
        {'i', 0, "norm_region"}, {'f', 0, "k"}, {'f', 0, "bias"},
        {'b', 0, "is_onnx"}}},  // LRN
      {14, {{'i', 0, "across_spatial"}, {'i', 0, "channel_shared"}}},  // Normalize
      {15,
       {{'i', 0, "flag"}, {'i', 0, "order0"}, {'i', 0, "order1"},
        {'i', 0, "order2"}, {'i', 0, "order3"}}},  // Permute
      {16,
       {{'u', 0, "alg"}, {'i', 0, "kernel_h"}, {'i', 0, "kernel_w"},
        {'i', 0, "stride_h"}, {'i', 0, "stride_w"}, {'i', 0, "global_pool"},
        {'i', 0, "caffe_flavor"}, {'i', 0, "pad_h0"}, {'i', 0, "pad_w0"},
        {'i', 0, "pad_h1"}, {'i', 0, "pad_w1"}}},  // Pooling
      {17, {}},                                     // PReLU (no params)
      {18,
       {{'F', 0, "min_sizes"}, {'F', 0, "max_sizes"}, {'F', 0, "variances"},
        {'F', 0, "aspect_ratios"}, {'i', 0, "flip"}, {'i', 0, "clip"},
        {'i', 0, "img_size"}, {'i', 0, "img_h"}, {'i', 0, "img_w"},
        {'f', 0, "step_w"}, {'f', 0, "step_h"}, {'f', 0, "offset"},
        {'i', 0, "num_priors"}, {'i', 0, "out_dim"}}},  // PriorBox
      {19,
       {{'i', 0, "num_classes"}, {'i', 0, "side"}, {'i', 0, "num_box"},
        {'i', 0, "coords"}, {'f', 0, "confidence_threshold"},
        {'f', 0, "nms_threshold"}, {'F', 0, "biases"}}},  // Region
      {20, {{'f', 0, "negative_slope"}}},                 // ReLu
      {22, {{'i', 0, "stride"}}},                         // Reorg
      {23,
       {{'i', 0, "is_mxnet"}, {'i', 0, "reverse"}, {'I', 0, "shape"},
        {'i', 0, "is_onnx"}}},  // Reshape
      {24,
       {{'i', 0, "pooled_h"}, {'i', 0, "pooled_w"},
        {'f', 0, "spatial_scale"}}},  // ROIPooling
      {25,
       {{'F', 0, "ratios"}, {'F', 0, "anchor_scales"}, {'i', 0, "feat_stride"},
        {'i', 0, "basesize"}, {'i', 0, "min_size"}, {'i', 0, "per_nms_topn"},
        {'i', 0, "post_nms_topn"}, {'f', 0, "nms_thresh"},
        {'A', 0, "anchors"}}},  // RPN
      {26, {{'i', 0, "axis"}, {'i', 0, "num_axes"}, {'i', 0, "bias_term"}}},  // Scale
      {27,
       {{'i', 0, "axis"}, {'I', 0, "slice_points"}, {'I', 0, "begins"},
        {'I', 0, "sizes"}, {'i', 0, "iscaffe"}, {'i', 0, "ismxnet"},
        {'i', 0, "isonnx"}, {'i', 0, "begin"}, {'i', 0, "end"},
        {'i', 0, "step"}}},  // Slice
      {28, {{'i', 0, "axis"}}},  // Softmax
      {29,
       {{'i', 0, "axis"}, {'i', 0, "split_dim"}, {'b', 0, "is_caffe"},
        {'b', 0, "is_onnx"}, {'x', 2, ""}, {'I', 0, "split_sizes"}}},  // Split
      {30,
       {{'i', 0, "max_detections"}, {'i', 0, "max_classes_per_detection"},
        {'f', 0, "nms_score_threshold"}, {'f', 0, "nms_iou_threshold"},
        {'i', 0, "num_classes"}, {'F', 0, "scales"}}},  // DetectionPostProcess
      {31,
       {{'f', 0, "alpha"}, {'f', 0, "beta"}, {'i', 0, "transA"},
        {'i', 0, "transB"}}},  // Gemm
      {32,
       {{'i', 0, "max_input_num"}, {'i', 0, "max_output_num"},
        {'s', 0, "op_name"}}},  // Generic
      {34,
       {{'f', 0, "forget_bias"}, {'f', 0, "clip"}, {'i', 0, "output_len"},
        {'i', 0, "sequence_len"}, {'i', 0, "input_size"}, {'i', 0, "hidden_size"},
        {'i', 0, "cell_size"}, {'i', 0, "has_peephole"}, {'i', 0, "has_projection"},
        {'i', 0, "has_clip"}, {'i', 0, "has_bias"}, {'i', 0, "has_init_state"},
        {'i', 0, "forget_act"}, {'i', 0, "input_act"}, {'i', 0, "output_act"},
        {'i', 0, "cellin_act"}, {'i', 0, "cellout_act"},
        {'i', 0, "mxnet_flag"}}},  // LSTM
      {35,
       {{'f', 0, "clip"}, {'i', 0, "output_len"}, {'i', 0, "sequence_len"},
        {'i', 0, "input_size"}, {'i', 0, "hidden_size"}, {'i', 0, "has_clip"},
        {'i', 0, "has_bias"}, {'i', 0, "has_init_state"},
        {'i', 0, "activation"}}},  // RNN
      {38,
       {{'i', 0, "dim_0"}, {'i', 0, "dim_1"}, {'i', 0, "dim_2"},
        {'i', 0, "dim_3"}}},  // Squeeze
      {40,
       {{'i', 0, "pad_n_0"}, {'i', 0, "pad_n_1"}, {'i', 0, "pad_c_0"},
        {'i', 0, "pad_c_1"}, {'i', 0, "pad_h_0"}, {'i', 0, "pad_h_1"},
        {'i', 0, "pad_w_0"}, {'i', 0, "pad_w_1"}, {'i', 0, "mode"},
        {'f', 0, "value"}}},  // Pad
      {41,
       {{'i', 0, "begin_n"}, {'i', 0, "end_n"}, {'i', 0, "stride_n"},
        {'i', 0, "begin_c"}, {'i', 0, "end_c"}, {'i', 0, "stride_c"},
        {'i', 0, "begin_h"}, {'i', 0, "end_h"}, {'i', 0, "stride_h"},
        {'i', 0, "begin_w"}, {'i', 0, "end_w"}, {'i', 0, "stride_w"}}},  // StridedSlice
      {42, {{'i', 0, "axis"}, {'i', 0, "keepdims"}}},  // ArgMax
      {43, {{'i', 0, "axis"}, {'i', 0, "keepdims"}}},  // ArgMin
      {44, {{'i', 0, "k"}, {'i', 0, "sorted"}}},       // TopKV2
      {45,
       {{'i', 0, "dim_0"}, {'i', 0, "dim_1"}, {'i', 0, "dim_2"},
        {'i', 0, "dim_3"}, {'i', 0, "type"}, {'i', 0, "keepdim"}}},  // Reduction
      {48,
       {{'f', 0, "clip"}, {'i', 0, "output_len"}, {'i', 0, "sequence_len"},
        {'i', 0, "input_size"}, {'i', 0, "hidden_size"}, {'i', 0, "has_clip"},
        {'i', 0, "has_gate_bias"}, {'i', 0, "has_candidate_bias"},
        {'i', 0, "has_init_state"}, {'i', 0, "mxnet_flag"}}},  // GRU
      {49, {{'i', 0, "axis"}}},                                // Addn
      {50, {{'i', 0, "dim_0"}, {'i', 0, "dim_1"}}},            // SwapAxis
      {51, {{'f', 0, "scale"}}},                               // Upsample
      {52,
       {{'i', 0, "dilation_x"}, {'i', 0, "dilation_y"}, {'i', 0, "pad_top"},
        {'i', 0, "pad_bottom"}, {'i', 0, "pad_left"},
        {'i', 0, "pad_right"}}},  // SpaceToBatchND
      {53,
       {{'i', 0, "dilation_x"}, {'i', 0, "dilation_y"}, {'i', 0, "crop_top"},
        {'i', 0, "crop_bottom"}, {'i', 0, "crop_left"},
        {'i', 0, "crop_right"}}},  // BatchToSpaceND
      {54, {{'f', 0, "scale_x"}, {'f', 0, "scale_y"}, {'i', 0, "type"}}},  // Resize
      {55, {{'i', 0, "group"}}},  // ShuffleChannel
      {56,
       {{'i', 0, "num_args"}, {'i', 0, "offset_c"}, {'i', 0, "offset_h"},
        {'i', 0, "offset_w"}, {'i', 0, "crop_h"}, {'i', 0, "crop_w"},
        {'b', 0, "center_crop"}, {'x', 3, ""}, {'i', 0, "axis"},
        {'i', 0, "flag"}}},  // Crop
      {57,
       {{'i', 0, "pooled_width"}, {'i', 0, "pooled_height"},
        {'f', 0, "spatial_scale"}}},  // Roialign
      {58,
       {{'i', 0, "pooled_w"}, {'i', 0, "pooled_h"}, {'f', 0, "spatial_scale"},
        {'i', 0, "output_dim"}}},  // Psroipooling
      {59, {{'i', 0, "type"}}},    // Unary
      {60, {{'i', 0, "axis"}}},    // Expanddims
      {61, {{'i', 0, "bias_size"}}},  // Bias
      {63, {{'f', 0, "threshold"}}},  // Threshold
      {64, {{'f', 0, "alpha"}, {'f', 0, "beta"}}},  // Hardsigmoid
      {65,
       {{'i', 0, "num_output"}, {'i', 0, "input_dim"}, {'i', 0, "bias_term"},
        {'i', 0, "weight_data_size"}}},  // Embedding
      {66, {{'f', 0, "eps"}}},           // InstanceNorm
      {67,
       {{'i', 0, "across_channels"}, {'i', 0, "normalize_variance"},
        {'f', 0, "eps"}}},  // MVN
      {69, {{'i', 0, "type_from"}, {'i', 0, "type_to"}}},  // Cast
      {70, {{'f', 0, "alpha"}, {'f', 0, "beta"}}},         // HardSwish
      {71,
       {{'i', 0, "resize_type"}, {'f', 0, "width_scale"}, {'f', 0, "height_scale"},
        {'i', 0, "output_width"}, {'i', 0, "output_height"}}},  // Interp
      {72, {{'f', 0, "alpha"}, {'f', 0, "lambda_"}}},           // Selu
      {73, {{'f', 0, "alpha"}}},                                // Elu
      {75, {{'u', 0, "type"}}},                                 // Logical
      {76,
       {{'i', 0, "axis"}, {'i', 0, "indices_num"}, {'b', 0, "is_onnx"}}},  // Gather
      {77, {{'I', 0, "perm"}}},   // Transpose
      {78, {{'i', 0, "type"}}},   // Comparison
      {79, {{'i', 0, "block_size"}}},  // SpaceToDepth
      {80, {{'i', 0, "block_size"}}},  // DepthToSpace
      {82,
       {{'i', 0, "output_shape_size0"}, {'i', 0, "output_shape_size1"},
        {'i', 0, "default_value"}}},  // SparseToDense
      {87, {{'f', 0, "max"}, {'f', 0, "min"}}},  // Clip
      {88, {{'I', 0, "axes"}}},                  // Unsqueeze
      {89, {{'i', 0, "axis"}, {'i', 0, "keepdim"}}},  // ReduceL2
      {96, {{'i', 0, "frame_flag"}, {'i', 0, "reps_size"}, {'I', 0, "reps"}}},  // Tile
      {99, {{'i', 0, "axis"}}},  // LogSoftmax
      {93, {{'i', 0, "axis"}, {'b', 0, "is_onnx"}}},  // Scatter
      {98,
       {{'i', 0, "padding_type"}, {'i', 0, "kernel_h"}, {'i', 0, "kernel_w"},
        {'i', 0, "stride_h"}, {'i', 0, "stride_w"}}},  // L2Pool
      {105,
       {{'i', 0, "sampler_type"}, {'i', 0, "transformer_type"}, {'x', 4, ""},
        {'I', 0, "target_shape"}}},  // SpatialTransformer
      {92, {{'I', 0, "shape"}, {'i', 0, "dim_num"}}},  // Expand
      {107, {{'f', 0, "eps"}}},                        // LayerNorm
  };
  return kSchemas;
}

const OpSchema* find_schema(uint32_t op_type) {
  for (const auto& s : schemas())
    if (s.op_type == op_type) return &s;
  return nullptr;
}

// Wire kind codes (must match reader.py:_graph_from_wire).
enum Kind : uint32_t {
  K_I32 = 0,
  K_F32 = 1,
  K_BOOL = 2,
  K_VI32 = 3,
  K_VF32 = 4,
  K_STR = 5,
  K_ANCHORS = 6,
  K_U32 = 7,
};

void emit_params(const Blob& b, uint64_t poff, const OpSchema& schema,
                 Writer& w) {
  uint32_t count = 0;
  for (const auto& f : schema.fields)
    if (f.kind != 'x') ++count;
  w.u32(count);
  uint64_t off = poff;
  for (const auto& f : schema.fields) {
    if (f.kind == 'x') {
      off += f.pad;
      continue;
    }
    w.str(f.name);
    switch (f.kind) {
      case 'i':
        w.u32(K_I32);
        w.i32(b.i32(off));
        off += 4;
        break;
      case 'u':
        w.u32(K_U32);
        w.u32(b.u32(off));
        off += 4;
        break;
      case 'f':
        w.u32(K_F32);
        w.f32(b.f32(off));
        off += 4;
        break;
      case 'b':
        w.u32(K_BOOL);
        w.i32(b.u8(off) ? 1 : 0);
        off += 1;
        break;
      case 'I': {
        uint32_t voff = b.u32(off);
        off += 4;
        uint32_t n;
        uint32_t base = b.vec(voff, 4, &n);
        w.u32(K_VI32);
        w.u32(n);
        for (uint32_t k = 0; k < n; ++k) w.i32(b.i32(base + 4ull * k));
        break;
      }
      case 'F': {
        uint32_t voff = b.u32(off);
        off += 4;
        uint32_t n;
        uint32_t base = b.vec(voff, 4, &n);
        w.u32(K_VF32);
        w.u32(n);
        for (uint32_t k = 0; k < n; ++k) w.f32(b.f32(base + 4ull * k));
        break;
      }
      case 'A': {
        uint32_t voff = b.u32(off);
        off += 4;
        uint32_t n;
        uint32_t base = b.vec(voff, 16, &n);
        w.u32(K_ANCHORS);
        w.u32(n);
        for (uint32_t k = 0; k < n * 4; ++k) w.f32(b.f32(base + 4ull * k));
        break;
      }
      case 's': {
        uint32_t soff = b.u32(off);
        off += 4;
        w.u32(K_STR);
        w.str(b.str(soff));
        break;
      }
      default:
        throw ParseError("bad schema kind");
    }
  }
}

void parse(const Blob& b, Writer& w) {
  // Header (TM2_Header: u16 ver_main, u16 ver_sub, u16 ver_compile, pad,
  // u32 offset_root — tm2_format.h:267-272).
  if (b.size() < 12) throw ParseError("file too small");
  uint16_t ver_main = b.u16(0);
  if (ver_main != 2)
    throw ParseError("unsupported tmfile version " + std::to_string(ver_main));
  uint32_t root = b.u32(8);

  // TM2_Model {i32 orig_format, i32 sub_format, u32 offset_vo_subgraphs,
  // u32 offset_s_mname}.
  int32_t orig_format = b.i32(root);
  uint32_t off_subgraphs = b.u32(root + 8);
  uint32_t off_mname = b.u32(root + 12);
  uint32_t n_subs;
  uint32_t subs_base = b.vec(off_subgraphs, 4, &n_subs);
  if (n_subs != 1)
    throw ParseError("expected 1 subgraph, got " + std::to_string(n_subs));
  uint32_t soff = b.u32(subs_base);

  // TM2_Subgraph {u32 id, i32 graph_layout, i32 model_layout, 7 offsets}.
  int32_t graph_layout = b.i32(soff + 4);
  int32_t model_layout = b.i32(soff + 8);
  uint32_t off_in = b.u32(soff + 12);
  uint32_t off_out = b.u32(soff + 16);
  uint32_t off_nodes = b.u32(soff + 20);
  uint32_t off_tensors = b.u32(soff + 24);
  uint32_t off_buffers = b.u32(soff + 28);

  w.raw("TTW1", 4);
  w.i32(graph_layout);
  w.i32(model_layout);
  w.i32(orig_format);
  w.str(b.str(off_mname));

  for (uint32_t off_io : {off_in, off_out}) {
    uint32_t n;
    uint32_t base = b.vec(off_io, 4, &n);
    w.u32(n);
    for (uint32_t k = 0; k < n; ++k) w.u32(b.u32(base + 4ull * k));
  }

  uint32_t n_buffers;
  uint32_t buffers_base = b.vec(off_buffers, 4, &n_buffers);

  // --- tensors (TM2_Tensor, tm2_format.h:343-357) ---
  uint32_t n_tensors;
  uint32_t tensors_base = b.vec(off_tensors, 4, &n_tensors);
  w.u32(n_tensors);
  for (uint32_t i = 0; i < n_tensors; ++i) {
    uint32_t toff = b.u32(tensors_base + 4ull * i);
    uint32_t tensor_id = b.u32(toff);
    uint32_t buffer_id = b.u32(toff + 4);
    uint32_t off_dims = b.u32(toff + 8);
    uint32_t off_tname = b.u32(toff + 12);
    uint32_t off_qp = b.u32(toff + 16);
    int32_t ttype = b.i32(toff + 24);
    int32_t dtype = b.i32(toff + 28);

    w.u32(tensor_id);
    w.i32(dtype);
    w.i32(ttype);
    w.str(b.str(off_tname));

    uint32_t nd;
    uint32_t dims_base = b.vec(off_dims, 4, &nd);
    w.u32(nd);
    for (uint32_t k = 0; k < nd; ++k) w.i32(b.i32(dims_base + 4ull * k));

    // quant params: vector of offsets to TM2_QuantParam {i32 zp, f32 scale,
    // i32 width} (tm2_format.h:335-340)
    uint32_t nq = 0, q_base = 0;
    if (off_qp != kNotSet) q_base = b.vec(off_qp, 4, &nq);
    w.u32(nq);
    for (uint32_t k = 0; k < nq; ++k) {
      uint32_t qo = b.u32(q_base + 4ull * k);
      w.i32(b.i32(qo));      // zero_point
      w.f32(b.f32(qo + 4));  // scale
      w.i32(b.i32(qo + 8));  // width
    }

    if (ttype == 2 /* CONST */) {
      if (buffer_id >= n_buffers)
        throw ParseError("const tensor " + std::to_string(tensor_id) +
                         ": buffer id out of range");
      uint32_t boff = b.u32(buffers_base + 4ull * buffer_id);
      uint32_t bsize = b.u32(boff);
      uint32_t bdata = b.u32(boff + 4);
      if (bdata != kNotSet) b.check(bdata, bsize);  // validate payload range
      w.u32(1);
      w.u32(bsize);
      w.u32(bdata);
    } else {
      w.u32(0);
      w.u32(0);
      w.u32(0);
    }
  }

  // --- nodes (TM2_Node, tm2_format.h:313-321; TM2_Operator :325-330) ---
  uint32_t n_nodes;
  uint32_t nodes_base = b.vec(off_nodes, 4, &n_nodes);
  w.u32(n_nodes);
  for (uint32_t i = 0; i < n_nodes; ++i) {
    uint32_t noff = b.u32(nodes_base + 4ull * i);
    uint32_t node_id = b.u32(noff);
    uint32_t off_nin = b.u32(noff + 4);
    uint32_t off_nout = b.u32(noff + 8);
    uint32_t off_op = b.u32(noff + 12);
    uint32_t off_nname = b.u32(noff + 16);

    uint32_t op_type = b.u32(off_op + 4);
    uint32_t off_param = b.u32(off_op + 8);

    w.u32(node_id);
    w.u32(op_type);
    w.str(b.str(off_nname));
    for (uint32_t off_io : {off_nin, off_nout}) {
      uint32_t n;
      uint32_t base = b.vec(off_io, 4, &n);
      w.u32(n);
      for (uint32_t k = 0; k < n; ++k) w.u32(b.u32(base + 4ull * k));
    }
    const OpSchema* schema = find_schema(op_type);
    if (off_param != kNotSet && schema != nullptr && !schema->fields.empty()) {
      emit_params(b, off_param, *schema, w);
    } else {
      w.u32(0);
    }
  }
}

thread_local std::string g_error;

}  // namespace

extern "C" {

// Parse a tmfile blob into the wire format. On success returns 0 and sets
// (*out, *out_len) to a malloc'd buffer the caller frees with tt_buffer_free.
// On failure returns -1; tt_last_error() describes the problem.
int tt_tm2_parse(const uint8_t* data, long size, uint8_t** out,
                 long* out_len) {
  try {
    Blob b(data, (uint64_t)size);
    Writer w;
    parse(b, w);
    uint8_t* buf = (uint8_t*)::malloc(w.buf().size());
    if (!buf) {
      g_error = "out of memory";
      return -1;
    }
    std::memcpy(buf, w.buf().data(), w.buf().size());
    *out = buf;
    *out_len = (long)w.buf().size();
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

void tt_buffer_free(uint8_t* p) { ::free(p); }

const char* tt_last_error() { return g_error.c_str(); }

}  // extern "C"
