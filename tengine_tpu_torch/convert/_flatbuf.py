"""A FlatBuffers reader for the TFLite model file, with struct and numpy only.

It reads what convert/tflite_frontend.py reads and nothing more: the tables
Model, SubGraph, Tensor, Buffer, QuantizationParameters, Operator and
OperatorCode, and the builtin options tables of the operators the importer
maps. Field slots follow tensorflow/lite/schema/schema.fbs (a field's slot is
its position in its table); an absent field reads its schema default.

Layout (the FlatBuffers binary format): the file starts with the root
table's uoffset (u32, from its own position) and the 4-byte identifier
"TFL3". A table starts with an soffset (i32) back to its vtable: the vtable
holds its own size (u16), the table's size (u16) and one u16 per slot, the
field's offset from the table start (0: absent). A field that refers to a
table, vector or string holds a uoffset from the field's own position. A
vector is a u32 length and its elements; a string a u32 length and its
bytes. A union is two fields: a u8 type and a uoffset to the table.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

# --- schema.fbs slots ------------------------------------------------------

# table Model
MODEL_OPERATOR_CODES = 1  # operator_codes:[OperatorCode]
MODEL_SUBGRAPHS = 2  # subgraphs:[SubGraph]
MODEL_BUFFERS = 4  # buffers:[Buffer]
# table SubGraph
SUBGRAPH_TENSORS = 0  # tensors:[Tensor]
SUBGRAPH_INPUTS = 1  # inputs:[int]
SUBGRAPH_OUTPUTS = 2  # outputs:[int]
SUBGRAPH_OPERATORS = 3  # operators:[Operator]
# table Tensor
TENSOR_SHAPE = 0  # shape:[int]
TENSOR_TYPE = 1  # type:TensorType (byte) = FLOAT32
TENSOR_BUFFER = 2  # buffer:uint
TENSOR_NAME = 3  # name:string
TENSOR_QUANTIZATION = 4  # quantization:QuantizationParameters
# table Buffer
BUFFER_DATA = 0  # data:[ubyte]
BUFFER_OFFSET = 1  # offset:ulong, from the start of the file; set where > 1
BUFFER_SIZE = 2  # size:ulong
# table QuantizationParameters
QUANT_SCALE = 2  # scale:[float]
QUANT_ZERO_POINT = 3  # zero_point:[long]
# table Operator
OPERATOR_OPCODE_INDEX = 0  # opcode_index:uint
OPERATOR_INPUTS = 1  # inputs:[int]
OPERATOR_OUTPUTS = 2  # outputs:[int]
OPERATOR_BUILTIN_OPTIONS = 4  # builtin_options:BuiltinOptions (slot 3: its type)
# table OperatorCode
OPCODE_DEPRECATED_BUILTIN_CODE = 0  # deprecated_builtin_code:byte
OPCODE_BUILTIN_CODE = 3  # builtin_code:BuiltinOperator (int) = ADD

# table Conv2DOptions
CONV_PADDING = 0  # padding:Padding (byte) = SAME
CONV_STRIDE_W = 1  # stride_w:int
CONV_STRIDE_H = 2  # stride_h:int
CONV_FUSED_ACTIVATION = 3  # fused_activation_function:ActivationFunctionType (byte)
CONV_DILATION_W = 4  # dilation_w_factor:int = 1
CONV_DILATION_H = 5  # dilation_h_factor:int = 1
# table DepthwiseConv2DOptions
DW_PADDING = 0  # padding:Padding
DW_STRIDE_W = 1  # stride_w:int
DW_STRIDE_H = 2  # stride_h:int
DW_DEPTH_MULTIPLIER = 3  # depth_multiplier:int
DW_FUSED_ACTIVATION = 4  # fused_activation_function
DW_DILATION_W = 5  # dilation_w_factor:int = 1
DW_DILATION_H = 6  # dilation_h_factor:int = 1
# table FullyConnectedOptions
FC_FUSED_ACTIVATION = 0  # fused_activation_function
# table Pool2DOptions
POOL_PADDING = 0  # padding:Padding
POOL_STRIDE_W = 1  # stride_w:int
POOL_STRIDE_H = 2  # stride_h:int
POOL_FILTER_W = 3  # filter_width:int
POOL_FILTER_H = 4  # filter_height:int
# table ConcatenationOptions
CONCAT_AXIS = 0  # axis:int
# table ReshapeOptions
RESHAPE_NEW_SHAPE = 0  # new_shape:[int]

# enum BuiltinOperator: the builtins the importer maps
ADD = 0
AVERAGE_POOL_2D = 1
CONCATENATION = 2
CONV_2D = 3
DEPTHWISE_CONV_2D = 4
FULLY_CONNECTED = 9
LOGISTIC = 14
MAX_POOL_2D = 17
MUL = 18
RELU = 19
RELU6 = 21
RESHAPE = 22
SOFTMAX = 25
PAD = 34
MEAN = 40
RESIZE_NEAREST_NEIGHBOR = 97


class Table:
    """A table at byte `pos` of `buf`."""

    __slots__ = ("buf", "pos", "_vt", "_vt_len")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        (soff,) = struct.unpack_from("<i", buf, pos)
        self._vt = pos - soff
        (vt_size,) = struct.unpack_from("<H", buf, self._vt)
        self._vt_len = (vt_size - 4) // 2

    def _off(self, slot: int) -> int:
        """The field's offset from the table start, 0 when absent."""
        if slot >= self._vt_len:
            return 0
        return struct.unpack_from("<H", self.buf, self._vt + 4 + 2 * slot)[0]

    def has(self, slot: int) -> bool:
        return self._off(slot) != 0

    def scalar(self, slot: int, fmt: str, default=0):
        o = self._off(slot)
        return default if o == 0 else struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0]

    def _ref(self, slot: int) -> Optional[int]:
        o = self._off(slot)
        if o == 0:
            return None
        at = self.pos + o
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, slot: int) -> Optional["Table"]:
        at = self._ref(slot)
        return None if at is None else Table(self.buf, at)

    def string(self, slot: int) -> Optional[bytes]:
        at = self._ref(slot)
        if at is None:
            return None
        (n,) = struct.unpack_from("<I", self.buf, at)
        return bytes(self.buf[at + 4: at + 4 + n])

    def vector(self, slot: int, dtype) -> np.ndarray:
        """A vector of scalars as numpy (empty when absent)."""
        at = self._ref(slot)
        dt = np.dtype(dtype).newbyteorder("<")
        if at is None:
            return np.zeros(0, dt)
        (n,) = struct.unpack_from("<I", self.buf, at)
        return np.frombuffer(self.buf, dt, n, at + 4)

    def tables(self, slot: int) -> List["Table"]:
        """A vector of tables (empty when absent)."""
        at = self._ref(slot)
        if at is None:
            return []
        (n,) = struct.unpack_from("<I", self.buf, at)
        out = []
        for i in range(n):
            el = at + 4 + 4 * i
            out.append(Table(self.buf, el + struct.unpack_from("<I", self.buf, el)[0]))
        return out


def root(buf: bytes) -> Table:
    """The root table of a FlatBuffer (a TFLite Model)."""
    (off,) = struct.unpack_from("<I", buf, 0)
    return Table(buf, off)


class Model:
    """The Model fields the importer reads, as the schema's generated class
    names them (operator codes, subgraphs, buffers)."""

    def __init__(self, buf: bytes):
        if len(buf) < 8 or bytes(buf[4:8]) != b"TFL3":
            raise ValueError("not a TFLite flatbuffer (no TFL3 identifier)")
        self.buf = buf
        m = root(buf)
        self.operator_codes = m.tables(MODEL_OPERATOR_CODES)
        self.subgraphs = m.tables(MODEL_SUBGRAPHS)
        self.buffers = m.tables(MODEL_BUFFERS)

    def builtin_code(self, opcode_index: int) -> int:
        """An operator's BuiltinOperator: the larger of builtin_code and
        deprecated_builtin_code (files before schema v3a set only the
        latter; later ones set both, the old one clamped to 127)."""
        oc = self.operator_codes[opcode_index]
        return max(oc.scalar(OPCODE_BUILTIN_CODE, "i", 0),
                   oc.scalar(OPCODE_DEPRECATED_BUILTIN_CODE, "b", 0))

    def buffer_data(self, index: int) -> np.ndarray:
        """A buffer's bytes (uint8, empty when it has none): inline, or,
        where its offset is set (> 1, schema.fbs), `size` bytes at `offset`
        from the start of the file, after the flatbuffer (a model over 2 GB
        is written so)."""
        buf = self.buffers[index]
        offset = buf.scalar(BUFFER_OFFSET, "Q", 0)
        if offset > 1:
            size = buf.scalar(BUFFER_SIZE, "Q", 0)
            if offset + size > len(self.buf):
                raise ValueError(f"buffer {index}: {size} bytes at {offset} past the file's "
                                 f"{len(self.buf)}")
            return np.frombuffer(self.buf, np.uint8, size, offset)
        return buf.vector(BUFFER_DATA, np.uint8)
