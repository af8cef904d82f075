"""TM2 ("tmfile") binary format tables.

Spec: Tengine's `source/serializer/tmfile/tm2_format.h` (struct layouts,
op-type constants, param records). The file is one blob of little-endian
C structs addressed by u32 offsets from the file base; offset 0 (TM2_NOT_SET)
means "absent". All multi-byte fields are 4-byte aligned, so most structs are
plain arrays of u32/i32/f32; the few containing tm_bool_t are handled with
explicit padding in the reader.
"""

from __future__ import annotations

TM2_NOT_SET = 0

# Op-type constants (tm2_format.h:157-264) -> canonical op names
# (tm2_format.h:49-154). The name is what the rest of the framework keys on.
OP_TYPE_TO_NAME = {
    0: "Accuracy",
    1: "BatchNormalization",
    2: "BilinearResize",
    3: "Concat",
    4: "Const",
    5: "Convolution",
    6: "Deconvolution",
    7: "DetectionOutput",
    8: "Dropout",
    9: "Eltwise",
    10: "Flatten",
    11: "FullyConnected",
    12: "InputOp",
    13: "LRN",
    14: "Normalize",
    15: "Permute",
    16: "Pooling",
    17: "PReLU",
    18: "PriorBox",
    19: "Region",
    20: "ReLu",
    21: "ReLu6",
    22: "Reorg",
    23: "Reshape",
    24: "ROIPooling",
    25: "RPN",
    26: "Scale",
    27: "Slice",
    28: "Softmax",
    29: "Split",
    30: "DetectionPostProcess",
    31: "Gemm",
    32: "Generic",
    33: "Logistic",
    34: "LSTM",
    35: "RNN",
    36: "Tanh",
    37: "Sigmoid",
    38: "Squeeze",
    39: "FusedBNScaleReLu",
    40: "Pad",
    41: "StridedSlice",
    42: "ArgMax",
    43: "ArgMin",
    44: "TopKV2",
    45: "Reduction",
    46: "Maximum",
    47: "Minimum",
    48: "GRU",
    49: "Addn",
    50: "SwapAxis",
    51: "Upsample",
    52: "SpaceToBatchND",
    53: "BatchToSpaceND",
    54: "Resize",
    55: "ShuffleChannel",
    56: "Crop",
    57: "Roialign",
    58: "Psroipooling",
    59: "Unary",
    60: "Expanddims",
    61: "Bias",
    62: "Noop",
    63: "Threshold",
    64: "Hardsigmoid",
    65: "Embedding",
    66: "InstanceNorm",
    67: "MVN",
    68: "Absval",
    69: "Cast",
    70: "HardSwish",
    71: "Interp",
    72: "Selu",
    73: "Elu",
    74: "BroadMul",
    75: "Logical",
    76: "Gather",
    77: "Transpose",
    78: "Comparison",
    79: "SpaceToDepth",
    80: "DepthToSpace",
    81: "Reverse",
    82: "SparseToDense",
    83: "Ceil",
    84: "SquaredDifference",
    85: "Round",
    86: "ZerosLike",
    87: "Clip",
    88: "Unsqueeze",
    89: "ReduceL2",
    90: "Mean",
    91: "MatMul",
    92: "Expand",
    93: "Scatter",
    94: "Shape",
    95: "Where",
    96: "Tile",
    97: "Mish",
    98: "L2Pool",
    99: "LogSoftmax",
    100: "ReLU1",
    101: "L2Normalization",
    102: "Softplus",
    103: "Reciprocal",
    105: "SpatialTransformer",
    106: "Gelu",
    107: "LayerNorm",
}

OP_NAME_TO_TYPE = {v: k for k, v in OP_TYPE_TO_NAME.items()}

# Eltwise sub-types (operator/prototype/eltwise_param.h:29-48)
ELT_PROD = 0
ELT_PROD_SCALAR = 1
ELT_SUM = 2
ELT_SUM_SCALAR = 3
ELT_SUB = 4
ELT_SUB_SCALAR = 5
ELT_MAX = 6
ELT_RSQRT = 7
ELT_MIN_SCALAR = 8
ELT_LAST = 9
ELT_DIV = 10
ELT_LOG = 11
ELT_EXP = 12
ELT_SQRT = 13
ELT_FLOOR = 14
ELT_SQUARE = 15
ELT_POW = 16
ELT_POWER = 17

# Pooling algs (operator/prototype/pooling_param.h:32-33)
POOL_MAX = 0
POOL_AVG = 1

# Unary sub-types (operator/prototype/unary_param.h)
UNARY_NAMES = {
    0: "abs", 1: "neg", 2: "floor", 3: "ceil", 4: "square", 5: "sqrt",
    6: "rsqrt", 7: "exp", 8: "log", 9: "sin", 10: "cos", 11: "tan",
    12: "asin", 13: "acos", 14: "atan", 15: "reciprocal", 16: "tanh",
}

# Reduction sub-types — numbered per the reference RUNTIME dispatch
# (reduction_kernel_ref.h), not its param-header comments: 7 duplicates asum,
# 8 ("l2") is elementwise sqrt(x^2) summed == asum, 9 log(sum), 10 logsumexp.
REDUCE_NAMES = {
    0: "sum", 1: "mean", 2: "asum", 3: "sqsum", 4: "max", 5: "min",
    6: "prod", 7: "asum2", 8: "l2", 9: "logsum", 10: "logsumexp",
}
