"""DataType / Schema serde for the plan IR (port of
blaze_tpu/plan/types.py).  Each logical type maps to a JSON-friendly dict
({"id": ...}); the protobuf wire maps onto the same dicts."""

from __future__ import annotations

from typing import Any, Dict

from blaze_tpu_torch.schema import DataType, Field, Schema, TypeId


def type_to_dict(t: DataType) -> Dict[str, Any]:
    out: Dict[str, Any] = {"id": t.id.value}
    if t.id == TypeId.DECIMAL:
        out["precision"] = t.precision
        out["scale"] = t.scale
    if t.children:
        out["children"] = [field_to_dict(f) for f in t.children]
    return out


def type_from_dict(d: Dict[str, Any]) -> DataType:
    tid = TypeId(d["id"])
    children = tuple(field_from_dict(c) for c in d.get("children", ()))
    return DataType(tid, d.get("precision", 0), d.get("scale", 0), children)


def field_to_dict(f: Field) -> Dict[str, Any]:
    return {"name": f.name, "type": type_to_dict(f.data_type),
            "nullable": f.nullable}


def field_from_dict(d: Dict[str, Any]) -> Field:
    return Field(d["name"], type_from_dict(d["type"]), d.get("nullable", True))


def schema_to_dict(s: Schema) -> Dict[str, Any]:
    return {"fields": [field_to_dict(f) for f in s]}


def schema_from_dict(d: Dict[str, Any]) -> Schema:
    return Schema([field_from_dict(f) for f in d["fields"]])
