"""Logical types and schemas (port of blaze_tpu/schema.py).

The logical type system is Arrow's, restricted to what Spark emits.  On the
device a fixed-width column is one torch data tensor plus a bool validity
tensor, padded to the batch capacity: int8/16/32/64, float32/64, bool,
date32, timestamp_us and decimals of precision <= 18, whose unscaled
values ride as int64 (Spark's long-backed decimals).  Wider decimals and
the var-width and nested types stay host columns (Arrow arrays).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import pyarrow as pa
import torch


class TypeId(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DATE32 = "date32"          # days since epoch, int32
    TIMESTAMP_MICROS = "timestamp_us"  # int64
    DECIMAL = "decimal"        # unscaled int64 (precision <= 18)
    UTF8 = "utf8"
    BINARY = "binary"
    NULL = "null"
    LIST = "list"
    STRUCT = "struct"
    MAP = "map"


_TORCH_DTYPES = {
    TypeId.BOOL: torch.bool,
    TypeId.INT8: torch.int8,
    TypeId.INT16: torch.int16,
    TypeId.INT32: torch.int32,
    TypeId.INT64: torch.int64,
    TypeId.FLOAT32: torch.float32,
    TypeId.FLOAT64: torch.float64,
    TypeId.DATE32: torch.int32,
    TypeId.TIMESTAMP_MICROS: torch.int64,
    TypeId.DECIMAL: torch.int64,
}

#: torch dtype -> numpy dtype of the same width and kind
TORCH_TO_NP = {
    torch.bool: np.dtype(bool), torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}


@dataclass(frozen=True)
class DataType:
    id: TypeId
    precision: int = 0       # decimal only
    scale: int = 0           # decimal only
    children: Tuple["Field", ...] = ()  # nested only

    @property
    def is_fixed_width(self) -> bool:
        if self.id == TypeId.DECIMAL:
            return self.precision <= 18
        return self.id not in (TypeId.UTF8, TypeId.BINARY, TypeId.LIST,
                               TypeId.STRUCT, TypeId.MAP, TypeId.NULL)

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def is_integer(self) -> bool:
        return self.id in (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
                           TypeId.DATE32, TypeId.TIMESTAMP_MICROS)

    def torch_dtype(self) -> torch.dtype:
        """Device representation (the counterpart of `jnp_dtype`)."""
        if self.id not in _TORCH_DTYPES:
            raise TypeError(f"{self} has no device dtype")
        return _TORCH_DTYPES[self.id]

    def np_dtype(self):
        return TORCH_TO_NP[self.torch_dtype()]

    def to_arrow(self) -> pa.DataType:
        m = {
            TypeId.BOOL: pa.bool_(),
            TypeId.INT8: pa.int8(),
            TypeId.INT16: pa.int16(),
            TypeId.INT32: pa.int32(),
            TypeId.INT64: pa.int64(),
            TypeId.FLOAT32: pa.float32(),
            TypeId.FLOAT64: pa.float64(),
            TypeId.DATE32: pa.date32(),
            TypeId.TIMESTAMP_MICROS: pa.timestamp("us"),
            TypeId.UTF8: pa.utf8(),
            TypeId.BINARY: pa.binary(),
            TypeId.NULL: pa.null(),
        }
        if self.id == TypeId.DECIMAL:
            return pa.decimal128(self.precision, self.scale)
        if self.id == TypeId.LIST:
            return pa.list_(self.children[0].data_type.to_arrow())
        if self.id == TypeId.STRUCT:
            return pa.struct([(f.name, f.data_type.to_arrow())
                              for f in self.children])
        if self.id == TypeId.MAP:
            return pa.map_(self.children[0].data_type.to_arrow(),
                           self.children[1].data_type.to_arrow())
        return m[self.id]

    @staticmethod
    def from_arrow(t: pa.DataType) -> "DataType":
        if pa.types.is_boolean(t):
            return BOOL
        if pa.types.is_int8(t):
            return INT8
        if pa.types.is_int16(t):
            return INT16
        if pa.types.is_int32(t):
            return INT32
        if pa.types.is_int64(t):
            return INT64
        if pa.types.is_float32(t):
            return FLOAT32
        if pa.types.is_float64(t):
            return FLOAT64
        if pa.types.is_date32(t):
            return DATE32
        if pa.types.is_timestamp(t):
            return TIMESTAMP_MICROS
        if pa.types.is_decimal(t):
            return DataType(TypeId.DECIMAL, t.precision, t.scale)
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            return UTF8
        if pa.types.is_binary(t) or pa.types.is_large_binary(t):
            return BINARY
        if pa.types.is_null(t):
            return NULL
        if pa.types.is_dictionary(t):
            return DataType.from_arrow(t.value_type)
        if pa.types.is_list(t):
            return DataType(TypeId.LIST, children=(
                Field("item", DataType.from_arrow(t.value_type), True),))
        if pa.types.is_struct(t):
            return DataType(TypeId.STRUCT, children=tuple(
                Field(f.name, DataType.from_arrow(f.type), f.nullable)
                for f in t))
        if pa.types.is_map(t):
            return DataType(TypeId.MAP, children=(
                Field("key", DataType.from_arrow(t.key_type), False),
                Field("value", DataType.from_arrow(t.item_type), True)))
        raise TypeError(f"unsupported arrow type {t}")

    def __repr__(self):
        if self.id == TypeId.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.id.value


BOOL = DataType(TypeId.BOOL)
INT8 = DataType(TypeId.INT8)
INT16 = DataType(TypeId.INT16)
INT32 = DataType(TypeId.INT32)
INT64 = DataType(TypeId.INT64)
FLOAT32 = DataType(TypeId.FLOAT32)
FLOAT64 = DataType(TypeId.FLOAT64)
DATE32 = DataType(TypeId.DATE32)
TIMESTAMP_MICROS = DataType(TypeId.TIMESTAMP_MICROS)
UTF8 = DataType(TypeId.UTF8)
BINARY = DataType(TypeId.BINARY)
NULL = DataType(TypeId.NULL)

_BY_TORCH = {torch.bool: BOOL, torch.int8: INT8, torch.int16: INT16,
             torch.int32: INT32, torch.int64: INT64, torch.float32: FLOAT32,
             torch.float64: FLOAT64}


def dtype_of(data: torch.Tensor) -> DataType:
    """Logical type of a device tensor by its storage dtype (date32 reads as
    int32, timestamps as int64: the hash of the underlying integer is the
    same)."""
    return _BY_TORCH[data.dtype]


@dataclass(frozen=True)
class Field:
    name: str
    data_type: DataType
    nullable: bool = True

    def to_arrow(self) -> pa.Field:
        return pa.field(self.name, self.data_type.to_arrow(), self.nullable)

    @staticmethod
    def from_arrow(f: pa.Field) -> "Field":
        return Field(f.name, DataType.from_arrow(f.type), f.nullable)


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i):
        return self.fields[i]

    def index_of(self, name: str, case_sensitive: bool = False) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name or (not case_sensitive
                                  and f.name.lower() == name.lower()):
                return i
        raise KeyError(name)

    def field(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def to_arrow(self) -> pa.Schema:
        return pa.schema([f.to_arrow() for f in self.fields])

    @staticmethod
    def from_arrow(s: pa.Schema) -> "Schema":
        return Schema([Field.from_arrow(f) for f in s])

    def select(self, indices) -> "Schema":
        return Schema([self.fields[i] for i in indices])
