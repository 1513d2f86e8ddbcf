"""Spark-compatible logical type system (PyTorch/CUDA port).

A copy of spark_rapids_tpu/types.py (the port imports nothing of the JAX
package); the one change is DOUBLE's storage lane, which is native
float64 here (see physical_np_dtype).


Mirrors the role of Spark's DataType hierarchy plus the reference's TypeSig
algebra (reference: sql-plugin/.../TypeChecks.scala:168-757) which declares,
per operator/expression, which input/output types are supported on the
accelerator.  Unsupported types cause a per-operator CPU fallback with a
recorded reason instead of a query failure.

Device mapping notes:
  - Integral/floating types map 1:1 to torch dtypes.
  - DATE   -> int32 days since epoch (Spark internal representation).
  - TIMESTAMP -> int64 microseconds since epoch UTC (Spark internal).
  - STRING -> dictionary-encoded on device (int32 codes + host dictionary) or
    raw (offsets,bytes) tensors for byte-level kernels; see columnar/device.py.
  - DECIMAL(p<=18) -> int64 unscaled value; device-computed wider results
    stay one int64 lane with overflow-to-null (ops/decimal.py).
  - NULL literal type -> carried logically; materializes as all-null int32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class DataType:
    """Base logical type. Instances are value objects: equality by fields."""

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))

    def __repr__(self):
        return self.simple_string

    @property
    def simple_string(self) -> str:
        return type(self).__name__.replace("Type", "").lower()


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    pass


class ByteType(IntegralType):
    pass


class ShortType(IntegralType):
    pass


class IntegerType(IntegralType):
    @property
    def simple_string(self):
        return "int"


class LongType(IntegralType):
    @property
    def simple_string(self):
        return "bigint"


class FloatType(FractionalType):
    pass


class DoubleType(FractionalType):
    pass


class StringType(DataType):
    pass


class BinaryType(DataType):
    pass


class DateType(DataType):
    pass


class TimestampType(DataType):
    pass


class NullType(DataType):
    @property
    def simple_string(self):
        return "void"


class DecimalType(FractionalType):
    MAX_PRECISION = 38

    def __init__(self, precision: int = 10, scale: int = 0):
        if not (0 < precision <= self.MAX_PRECISION):
            raise ValueError(f"decimal precision {precision} out of range")
        if not (0 <= scale <= precision):
            raise ValueError(f"decimal scale {scale} invalid for precision {precision}")
        self.precision = precision
        self.scale = scale

    @property
    def simple_string(self):
        return f"decimal({self.precision},{self.scale})"

    @property
    def is_wide(self) -> bool:
        """True when the unscaled value does not fit an int64 (precision > 18)."""
        return self.precision > 18


class ArrayType(DataType):
    def __init__(self, element_type: DataType, contains_null: bool = True):
        self.element_type = element_type
        self.contains_null = contains_null

    @property
    def simple_string(self):
        return f"array<{self.element_type.simple_string}>"


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


class StructType(DataType):
    def __init__(self, fields):
        self.fields = tuple(fields)

    @property
    def simple_string(self):
        inner = ",".join(f"{f.name}:{f.data_type.simple_string}" for f in self.fields)
        return f"struct<{inner}>"

    @property
    def names(self):
        return [f.name for f in self.fields]

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __getitem__(self, name: str) -> StructField:
        return self.fields[self.field_index(name)]

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)


class MapType(DataType):
    def __init__(self, key_type: DataType, value_type: DataType,
                 value_contains_null: bool = True):
        self.key_type = key_type
        self.value_type = value_type
        self.value_contains_null = value_contains_null

    @property
    def simple_string(self):
        return f"map<{self.key_type.simple_string},{self.value_type.simple_string}>"


# Singletons for the simple types (Spark-style convenience).
BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
BINARY = BinaryType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()


_NP_DTYPES = {
    BooleanType: np.bool_,
    ByteType: np.int8,
    ShortType: np.int16,
    IntegerType: np.int32,
    LongType: np.int64,
    FloatType: np.float32,
    DoubleType: np.float64,
    DateType: np.int32,        # days since epoch
    TimestampType: np.int64,   # micros since epoch
    NullType: np.int32,
}


def physical_np_dtype(dt: DataType):
    """numpy dtype of the on-device *storage* representation of `dt`.

    Strings are dictionary codes (int32); decimals are int64 unscaled;
    DOUBLE is native float64 (the card computes IEEE doubles exactly, so
    no bit-pattern lane is needed).
    """
    if isinstance(dt, StringType):
        return np.int32
    if isinstance(dt, DecimalType):
        # device-computed wide results are single-lane int64 with
        # overflow-to-null (ops/decimal.py module docs)
        return np.int64
    if isinstance(dt, ArrayType):
        # a ragged ARRAY column's data lane is its flat values lane
        return physical_np_dtype(dt.element_type)
    try:
        return _NP_DTYPES[type(dt)]
    except KeyError:
        raise TypeError(f"no physical dtype for {dt}") from None


def is_integral(dt: DataType) -> bool:
    return isinstance(dt, IntegralType)


def is_numeric(dt: DataType) -> bool:
    return isinstance(dt, NumericType)


def is_floating(dt: DataType) -> bool:
    return isinstance(dt, (FloatType, DoubleType))


# Numeric widening order for implicit binary-op promotion (Spark semantics).
_NUMERIC_RANK = {ByteType: 0, ShortType: 1, IntegerType: 2, LongType: 3,
                 FloatType: 4, DoubleType: 5}


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary arithmetic common type for non-decimal numerics."""
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise TypeError("decimal promotion handled by DecimalPrecision rules")
    ra, rb = _NUMERIC_RANK[type(a)], _NUMERIC_RANK[type(b)]
    winner = a if ra >= rb else b
    return winner


# ---------------------------------------------------------------------------
# TypeSig: declarative per-operator type support (reference TypeChecks.scala).
# ---------------------------------------------------------------------------

_ALL_TYPE_TAGS = (
    "BOOLEAN BYTE SHORT INT LONG FLOAT DOUBLE STRING BINARY DATE TIMESTAMP "
    "NULL DECIMAL64 DECIMAL128 ARRAY STRUCT MAP"
).split()


def _tag_of(dt: DataType) -> str:
    if isinstance(dt, DecimalType):
        return "DECIMAL128" if dt.is_wide else "DECIMAL64"
    if isinstance(dt, ArrayType):
        return "ARRAY"
    if isinstance(dt, StructType):
        return "STRUCT"
    if isinstance(dt, MapType):
        return "MAP"
    return {
        BooleanType: "BOOLEAN", ByteType: "BYTE", ShortType: "SHORT",
        IntegerType: "INT", LongType: "LONG", FloatType: "FLOAT",
        DoubleType: "DOUBLE", StringType: "STRING", BinaryType: "BINARY",
        DateType: "DATE", TimestampType: "TIMESTAMP", NullType: "NULL",
    }[type(dt)]


class TypeSig:
    """A set of supported type tags, with optional nested-type signature.

    Combinators mirror the reference's algebra: `+` union, `-` removal.
    """

    def __init__(self, tags=frozenset(), nested: Optional["TypeSig"] = None):
        self.tags = frozenset(tags)
        self.nested = nested

    def __add__(self, other: "TypeSig") -> "TypeSig":
        nested = self.nested or other.nested
        if self.nested and other.nested:
            nested = self.nested + other.nested
        return TypeSig(self.tags | other.tags, nested)

    def __sub__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.tags - other.tags, self.nested)

    def with_nested(self, nested: "TypeSig") -> "TypeSig":
        return TypeSig(self.tags, nested)

    def supports(self, dt: DataType) -> bool:
        tag = _tag_of(dt)
        if tag not in self.tags:
            return False
        inner = self.nested or self
        if isinstance(dt, ArrayType):
            return inner.supports(dt.element_type)
        if isinstance(dt, StructType):
            return all(inner.supports(f.data_type) for f in dt.fields)
        if isinstance(dt, MapType):
            return inner.supports(dt.key_type) and inner.supports(dt.value_type)
        return True

    def reason_not_supported(self, dt: DataType) -> Optional[str]:
        if self.supports(dt):
            return None
        return f"type {dt.simple_string} is not supported"

    def __repr__(self):
        return f"TypeSig({sorted(self.tags)})"


def _sig(*tags) -> TypeSig:
    return TypeSig(frozenset(tags))


class T:
    """Namespace of common TypeSigs (reference TypeSig object:543)."""
    BOOLEAN = _sig("BOOLEAN")
    INTEGRAL = _sig("BYTE", "SHORT", "INT", "LONG")
    FP = _sig("FLOAT", "DOUBLE")
    DECIMAL_64 = _sig("DECIMAL64")
    DECIMAL_128 = _sig("DECIMAL64", "DECIMAL128")
    NUMERIC = INTEGRAL + FP + DECIMAL_128
    STRING = _sig("STRING")
    BINARY = _sig("BINARY")
    DATE = _sig("DATE")
    TIMESTAMP = _sig("TIMESTAMP")
    DATETIME = DATE + TIMESTAMP
    NULL = _sig("NULL")
    ARRAY = _sig("ARRAY")
    STRUCT = _sig("STRUCT")
    MAP = _sig("MAP")
    NESTED = ARRAY + STRUCT + MAP
    ORDERABLE = NUMERIC + STRING + BOOLEAN + DATETIME + NULL
    COMPARABLE = ORDERABLE
    ALL_SIMPLE = NUMERIC + STRING + BINARY + BOOLEAN + DATETIME + NULL
    ALL = (ALL_SIMPLE + NESTED).with_nested(ALL_SIMPLE + NESTED)
    # What the device kernels handle (grows as slices are ported).
    DEVICE_COMMON = NUMERIC + STRING + BOOLEAN + DATETIME + NULL
