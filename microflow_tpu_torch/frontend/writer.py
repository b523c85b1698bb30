"""Minimal FlatBuffers *writer* + TFLite model assembly: the port's copy of
``microflow_tpu.frontend.writer``, byte for byte the same output.

Complements ``flatbuffer.py`` (the read path): it writes valid ``.tflite``
files for export (``frontend/export.py``), for the synthetic models
(``models/synth.py``) and for round-trip tests of the front end, without a
TensorFlow dependency.

Wire format notes (mirrors the reader's docstring): buffers are built
back-to-front like the official builders; "offset" here always means
*offset from the end* of the growing buffer, so a uoffset field's stored
value is ``field_offset - target_offset``.
"""

from __future__ import annotations

import struct

import numpy as np

from .tflite import (
    ActivationFunctionType,
    BuiltinOperator,
    Padding,
    TensorType,
)

# BuiltinOptions union indices (tflite.fbs:421-560)
_UNION = {
    BuiltinOperator.ADD: 11,
    BuiltinOperator.CONV_2D: 1,
    BuiltinOperator.DEPTHWISE_CONV_2D: 2,
    BuiltinOperator.AVERAGE_POOL_2D: 5,
    BuiltinOperator.FULLY_CONNECTED: 8,
    BuiltinOperator.SOFTMAX: 9,
    BuiltinOperator.RESHAPE: 17,
    BuiltinOperator.QUANTIZE: 89,
}


class Writer:
    """Back-to-front flatbuffer builder (prepend-only)."""

    def __init__(self):
        self.buf = bytearray()

    # -- low-level ---------------------------------------------------------

    def _prepend(self, b: bytes):
        self.buf[:0] = b

    def _align(self, n: int):
        while len(self.buf) % n:
            self._prepend(b"\x00")

    def offset(self) -> int:
        return len(self.buf)

    def vector_numeric(self, arr, dtype) -> int:
        arr = np.ascontiguousarray(np.asarray(arr, dtype=np.dtype(dtype).newbyteorder("<")))
        self._align(max(4, arr.dtype.itemsize))
        self._prepend(arr.tobytes())
        self._prepend(struct.pack("<I", arr.size))
        return self.offset()

    def vector_bytes(self, data: bytes) -> int:
        self._align(4)
        # pad payload so following (earlier-address) objects stay aligned
        pad = (-len(data)) % 4
        self._prepend(data + b"\x00" * pad)
        self._prepend(struct.pack("<I", len(data)))
        return self.offset()

    def write_string(self, s: str) -> int:
        b = s.encode("utf-8")
        self._align(4)
        pad = (-(len(b) + 1)) % 4
        self._prepend(b + b"\x00" + b"\x00" * pad)
        self._prepend(struct.pack("<I", len(b)))
        return self.offset()

    def vector_offsets(self, offsets: list[int]) -> int:
        self._align(4)
        total = 4 * len(offsets)
        self._prepend(b"\x00" * total)
        self._prepend(struct.pack("<I", len(offsets)))
        pos = self.offset()
        # patch each uoffset: stored at field position p = pos - 4 - 4*i
        for i, t in enumerate(offsets):
            p = pos - 4 - 4 * i
            struct.pack_into("<I", self.buf, len(self.buf) - p, p - t)
        return pos

    def table(self, fields: list) -> int:
        """fields: list of (field_id, kind, value); kind in
        {"i8","u8","i32","u32","f32","offset"}.  Absent fields omitted."""
        fields = [f for f in fields if f is not None]
        max_id = max((f[0] for f in fields), default=-1)
        sizes = {"i8": 1, "u8": 1, "i32": 4, "u32": 4, "f32": 4, "offset": 4}
        fmts = {"i8": "b", "u8": "B", "i32": "i", "u32": "I", "f32": "f"}
        # lay out table body: soffset(4) then fields, each aligned
        body = bytearray()
        rel = {}  # field_id -> rel pos in table
        for fid, kind, val in sorted(fields, key=lambda f: -sizes[f[1]]):
            sz = sizes[kind]
            while (4 + len(body)) % sz:
                body.append(0)
            rel[fid] = 4 + len(body)
            if kind == "offset":
                body += b"\x00\x00\x00\x00"
            else:
                body += struct.pack("<" + fmts[kind], val)
        table_size = 4 + len(body)
        vtable_size = 4 + 2 * (max_id + 1)
        # prepend table (aligned), then vtable; pad the body tail so the
        # table start address stays 4-aligned
        self._align(4)
        while len(body) % 4:
            body.append(0)
        self._prepend(bytes(body))
        self._prepend(b"\x00" * 4)  # soffset placeholder
        table_pos = self.offset()
        vt = bytearray(struct.pack("<HH", vtable_size, table_size))
        for fid in range(max_id + 1):
            vt += struct.pack("<H", rel.get(fid, 0))
        self._align(2)
        self._prepend(bytes(vt))
        vtable_pos = self.offset()
        # patch soffset: stored i32 at table start; vtable = table_addr - soffset
        # addresses: addr = L - off  ->  soffset = addr_t - addr_vt = vtable_pos - table_pos
        struct.pack_into(
            "<i", self.buf, len(self.buf) - table_pos, vtable_pos - table_pos
        )
        # patch uoffset fields
        for fid, kind, val in fields:
            if kind == "offset" and val:
                p = table_pos - rel[fid]
                struct.pack_into("<I", self.buf, len(self.buf) - p, p - val)
        return table_pos

    def finish(self, root: int, identifier: bytes = b"TFL3") -> bytes:
        self._align(8)
        # header: u32 root uoffset (from its own position 0) + identifier
        total = len(self.buf) + 8
        header = struct.pack("<I", total - root) + identifier
        return header + bytes(self.buf)


class ModelWriter:
    """High-level TFLite model assembly (subgraph 0 only, like the engine)."""

    def __init__(self, description: str = "microflow_tpu synthetic model"):
        self.description = description
        self.tensors = []  # (shape, TensorType, buffer_idx, name, scale, zp, qdim)
        self.buffers = [b""]  # buffer 0 = empty sentinel (tflite convention)
        self.operators = []  # (opcode, inputs, outputs, options_builder)
        self.opcodes = []  # BuiltinOperator list, dedup

    def tensor(self, shape, ttype: TensorType, scale, zero_point,
               data: np.ndarray | None = None, name: str = "t",
               quantized_dimension: int = 0) -> int:
        buf_idx = 0
        if data is not None:
            data = np.asarray(data, dtype=ttype.np_dtype)
            self.buffers.append(data.tobytes())
            buf_idx = len(self.buffers) - 1
        self.tensors.append(
            (list(shape), ttype, buf_idx, f"{name}_{len(self.tensors)}",
             np.atleast_1d(scale).astype(np.float32),
             np.atleast_1d(zero_point).astype(np.int64),
             quantized_dimension)
        )
        return len(self.tensors) - 1

    def _opcode(self, op: BuiltinOperator) -> int:
        if op not in self.opcodes:
            self.opcodes.append(op)
        return self.opcodes.index(op)

    def add_op(self, op: BuiltinOperator, inputs, outputs, options):
        """``options``: a field list, a callable(Writer) -> field list (for
        options that embed vectors, e.g. ReshapeOptions.new_shape), or None."""
        self.operators.append((self._opcode(op), op, list(inputs), list(outputs), options))

    # -- option builders (field ids per tflite.fbs) -------------------------

    @staticmethod
    def conv_options(padding: Padding, stride: tuple, act: ActivationFunctionType):
        return [(0, "i8", int(padding)), (1, "i32", stride[1]), (2, "i32", stride[0]),
                (3, "i8", int(act))]

    @staticmethod
    def dwconv_options(padding: Padding, stride: tuple, depth_multiplier: int,
                       act: ActivationFunctionType):
        return [(0, "i8", int(padding)), (1, "i32", stride[1]), (2, "i32", stride[0]),
                (3, "i32", depth_multiplier), (4, "i8", int(act))]

    @staticmethod
    def pool_options(padding: Padding, stride: tuple, filt: tuple,
                     act: ActivationFunctionType):
        return [(0, "i8", int(padding)), (1, "i32", stride[1]), (2, "i32", stride[0]),
                (3, "i32", filt[1]), (4, "i32", filt[0]), (5, "i8", int(act))]

    @staticmethod
    def fc_options(act: ActivationFunctionType):
        return [(0, "i8", int(act))]

    @staticmethod
    def add_options(act: ActivationFunctionType):
        return [(0, "i8", int(act))]

    @staticmethod
    def softmax_options(beta: float = 1.0):
        return [(0, "f32", beta)]

    @staticmethod
    def reshape_options(new_shape):
        """ReshapeOptions.new_shape (tflite.fbs:793-795) -- required for the
        official TFLite runtime, which otherwise defaults the target to a
        scalar when no shape input tensor is present."""
        shape = list(new_shape)
        return lambda w: [(0, "offset", w.vector_numeric(shape, np.int32))]

    def finish(self, inputs: list, outputs: list, num_subgraphs: int = 1) -> bytes:
        """``num_subgraphs`` > 1 duplicates subgraph 0 -- used by the
        rejection tests to prove the front-end aborts on multi-subgraph
        models instead of silently compiling index 0."""
        w = Writer()
        # buffers
        buffer_offs = []
        for data in self.buffers:
            off = w.vector_bytes(data) if data else 0
            buffer_offs.append(w.table([(0, "offset", off)] if off else []))
        buffers_vec = w.vector_offsets(buffer_offs)
        # tensors
        tensor_offs = []
        for shape, ttype, buf_idx, name, scale, zp, qdim in self.tensors:
            scale_off = w.vector_numeric(scale, np.float32)
            zp_off = w.vector_numeric(zp, np.int64)
            q_off = w.table([(2, "offset", scale_off), (3, "offset", zp_off),
                             (6, "i32", qdim)])
            shape_off = w.vector_numeric(shape, np.int32)
            name_off = w.write_string(name)
            tensor_offs.append(w.table([
                (0, "offset", shape_off), (1, "i8", int(ttype)),
                (2, "u32", buf_idx), (3, "offset", name_off),
                (4, "offset", q_off),
            ]))
        tensors_vec = w.vector_offsets(tensor_offs)
        # operators
        op_offs = []
        for opcode_idx, op, ins, outs, options in self.operators:
            ins_off = w.vector_numeric(ins, np.int32)
            outs_off = w.vector_numeric(outs, np.int32)
            fields = [(0, "u32", opcode_idx), (1, "offset", ins_off),
                      (2, "offset", outs_off)]
            if options is not None:
                fields_list = options(w) if callable(options) else options
                opt_off = w.table(fields_list)
                fields += [(3, "u8", _UNION[op]), (4, "offset", opt_off)]
            op_offs.append(w.table(fields))
        ops_vec = w.vector_offsets(op_offs)
        # subgraph
        in_off = w.vector_numeric(inputs, np.int32)
        out_off = w.vector_numeric(outputs, np.int32)
        sg_name = w.write_string("main")
        subgraph = w.table([(0, "offset", tensors_vec), (1, "offset", in_off),
                            (2, "offset", out_off), (3, "offset", ops_vec),
                            (4, "offset", sg_name)])
        subgraphs_vec = w.vector_offsets([subgraph] * num_subgraphs)
        # operator codes (write both deprecated byte and new i32 field)
        oc_offs = [
            w.table([(0, "i8", min(int(op), 127)), (2, "i32", 1), (3, "i32", int(op))])
            for op in self.opcodes
        ]
        opcodes_vec = w.vector_offsets(oc_offs)
        desc_off = w.write_string(self.description)
        root = w.table([(0, "u32", 3), (1, "offset", opcodes_vec),
                        (2, "offset", subgraphs_vec), (3, "offset", desc_off),
                        (4, "offset", buffers_vec)])
        return w.finish(root)
