"""Minimal, dependency-free FlatBuffers reader.

The equivalent of the reference's flatc-generated accessor layer
(``microflow-macros/flatbuffers/tflite_generated.rs``, 23 kLoC) -- we only
need the read path for the handful of TFLite tables the engine consumes,
so a ~100-line vtable walker replaces the generated code.

FlatBuffers wire format (little-endian):
* root:   u32 offset at byte 0 to the root table
* table:  i32 soffset to its vtable (``vtable_pos = table_pos - soffset``)
* vtable: u16 vtable_size, u16 table_size, then u16 per-field offsets
          (relative to table start); 0 or out-of-range = field absent
* offset fields: u32 relative to the field's own location
* vector/string: u32 length, then payload
"""

from __future__ import annotations

import struct

import numpy as np


class Table:
    """A lazily-decoded flatbuffer table."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    def _field_pos(self, field_id: int) -> int:
        """Absolute position of field ``field_id``, or 0 if absent."""
        vtable = self.pos - struct.unpack_from("<i", self.buf, self.pos)[0]
        vtable_size = struct.unpack_from("<H", self.buf, vtable)[0]
        entry = 4 + 2 * field_id
        if entry >= vtable_size:
            return 0
        off = struct.unpack_from("<H", self.buf, vtable + entry)[0]
        return self.pos + off if off else 0

    def scalar(self, field_id: int, fmt: str, default=0):
        p = self._field_pos(field_id)
        if not p:
            return default
        return struct.unpack_from("<" + fmt, self.buf, p)[0]

    def int8(self, field_id, default=0):
        return self.scalar(field_id, "b", default)

    def uint8(self, field_id, default=0):
        return self.scalar(field_id, "B", default)

    def int32(self, field_id, default=0):
        return self.scalar(field_id, "i", default)

    def uint32(self, field_id, default=0):
        return self.scalar(field_id, "I", default)

    def float32(self, field_id, default=0.0):
        return self.scalar(field_id, "f", default)

    def _indirect(self, p: int) -> int:
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, field_id: int) -> "Table | None":
        p = self._field_pos(field_id)
        if not p:
            return None
        return Table(self.buf, self._indirect(p))

    def _vector(self, field_id: int) -> tuple[int, int]:
        """(payload_pos, length) of a vector field, or (0, 0)."""
        p = self._field_pos(field_id)
        if not p:
            return 0, 0
        vec = self._indirect(p)
        n = struct.unpack_from("<I", self.buf, vec)[0]
        return vec + 4, n

    def string(self, field_id: int) -> str | None:
        payload, n = self._vector(field_id)
        if not payload:
            return None
        return self.buf[payload : payload + n].decode("utf-8")

    def vector_numeric(self, field_id: int, dtype) -> np.ndarray:
        payload, n = self._vector(field_id)
        dtype = np.dtype(dtype).newbyteorder("<")
        if not payload:
            return np.empty(0, dtype)
        return np.frombuffer(self.buf, dtype, count=n, offset=payload)

    def vector_bytes(self, field_id: int) -> bytes:
        payload, n = self._vector(field_id)
        return self.buf[payload : payload + n] if payload else b""

    def vector_tables(self, field_id: int) -> list["Table"]:
        payload, n = self._vector(field_id)
        if not payload:
            return []
        return [
            Table(self.buf, self._indirect(payload + 4 * i)) for i in range(n)
        ]


def root_table(buf: bytes) -> Table:
    return Table(buf, struct.unpack_from("<I", buf, 0)[0])


def file_identifier(buf: bytes) -> str:
    return buf[4:8].decode("ascii", errors="replace")
