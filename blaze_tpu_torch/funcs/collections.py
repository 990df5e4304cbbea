"""Array and map functions on the host over Arrow (port of
blaze_tpu/funcs/collections.py): make_array/array, array_contains
(NaN equals NaN, a NULL element makes a miss NULL), size/cardinality,
array_union, array_distinct, array_max/array_min (NaN largest),
array_join, str_to_map, map_keys, map_values and element_at (1-based,
negative from the end; under ANSI an index out of range raises for a
selected row).
"""

from __future__ import annotations

import pyarrow as pa

from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.funcs.common import host as _host, per_row as _per_row
from blaze_tpu_torch.funcs.common import selected_mask
from blaze_tpu_torch.schema import BOOL, DataType, Field, INT32, TypeId, UTF8


def _list_type(ts):
    """make_array-style: element types in -> list<element> out."""
    item = ts[0] if ts else UTF8
    return DataType(TypeId.LIST, children=(Field("item", item),))


def _same_list_type(ts):
    """array-in, array-out (array_distinct/array_union): identity type.
    Wrapping through _list_type double-nested the type and broke any
    consumer that trusted the declared schema (corpus-caught)."""
    return ts[0] if ts else _list_type(ts)


def _element_type(ts):
    t = ts[0] if ts else UTF8
    if t.id == TypeId.LIST:
        return t.children[0].data_type
    return t


@register("make_array", _list_type)
@register("array", _list_type)
def _make_array(args, batch, out_type):
    arrs = _host(args, batch)
    n = batch.num_rows
    py = [[a[i].as_py() if a[i].is_valid else None for a in arrs]
          for i in range(n)]
    return ColVal.host(out_type, pa.array(py, type=out_type.to_arrow()))


@register("array_contains", lambda ts: BOOL)
def _array_contains(args, batch, out_type):
    arrs = _host(args, batch)
    needles = _per_row(arrs[1])
    py = []

    def _eq(a, b):
        # Spark ArrayContains compares via ordering.equiv: NaN == NaN
        if isinstance(a, float) and isinstance(b, float) \
                and a != a and b != b:
            return True
        return a == b

    for x, needle in zip(arrs[0], needles):
        if not x.is_valid or needle is None:
            py.append(None)
            continue
        vals = x.as_py() or []
        if any(_eq(v, needle) for v in vals if v is not None):
            py.append(True)
        else:
            # no match + a null element -> NULL (ArrayContains 3VL)
            py.append(None if any(v is None for v in vals) else False)
    return ColVal.host(BOOL, pa.array(py, type=pa.bool_()))


@register("size", lambda ts: INT32)
@register("cardinality", lambda ts: INT32)
def _size(args, batch, out_type):
    (a,) = _host(args, batch)
    from blaze_tpu_torch.ops.generate import list_lengths
    return ColVal.host(INT32, list_lengths(a).cast(pa.int32()))


@register("array_union", _same_list_type)
def _array_union(args, batch, out_type):
    a, b = _host(args, batch)
    py = []
    for x, y in zip(a, b):
        if not x.is_valid or not y.is_valid:
            py.append(None)
        else:
            py.append(list(dict.fromkeys((x.as_py() or []) + (y.as_py() or []))))
    return ColVal.host(out_type, pa.array(py, type=a.type))


@register("array_distinct", _same_list_type)
def _array_distinct(args, batch, out_type):
    (a,) = _host(args, batch)
    py = [None if not x.is_valid else list(dict.fromkeys(x.as_py() or []))
          for x in a]
    return ColVal.host(out_type, pa.array(py, type=a.type))


@register("array_max", _element_type)
def _array_max(args, batch, out_type):
    (a,) = _host(args, batch)
    py = []
    for x in a:
        vals = [v for v in (x.as_py() or []) if v is not None] \
            if x.is_valid else None
        if not vals:
            py.append(None)
        elif any(isinstance(v, float) and v != v for v in vals):
            py.append(float("nan"))  # Spark total order: NaN is largest
        else:
            py.append(max(vals))
    return ColVal.host(out_type, pa.array(py, type=a.type.value_type))


@register("array_min", _element_type)
def _array_min(args, batch, out_type):
    (a,) = _host(args, batch)
    py = []
    for x in a:
        vals = [v for v in (x.as_py() or []) if v is not None] \
            if x.is_valid else None
        if not vals:
            py.append(None)
        else:
            real = [v for v in vals
                    if not (isinstance(v, float) and v != v)]
            # NaN is LARGEST in Spark's total order: min skips it
            # unless the array is all-NaN
            py.append(min(real) if real else float("nan"))
    return ColVal.host(out_type, pa.array(py, type=a.type.value_type))


@register("array_join", lambda ts: UTF8)
def _array_join(args, batch, out_type):
    arrs = _host(args, batch)
    seps = _per_row(arrs[1])
    null_repls = _per_row(arrs[2]) if len(arrs) > 2 else [None] * batch.num_rows
    py = []
    for x, sep, null_repl in zip(arrs[0], seps, null_repls):
        if not x.is_valid or sep is None:
            py.append(None)
            continue
        vals = []
        for v in x.as_py() or []:
            if v is None:
                if null_repl is not None:
                    vals.append(null_repl)
            else:
                vals.append(str(v))
        py.append(sep.join(vals))
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


def _map_type(ts):
    return DataType(TypeId.MAP, children=(Field("key", UTF8, False),
                                          Field("value", UTF8)))


@register("str_to_map", _map_type)
def _str_to_map(args, batch, out_type):
    """str_to_map(text, pair_delim=',', kv_delim=':') (ref spark_map.rs +
    JniBridge.strToMapSplit fallback)."""
    arrs = _host(args, batch)
    n = batch.num_rows
    pair_ds = _per_row(arrs[1]) if len(arrs) > 1 else [","] * n
    kv_ds = _per_row(arrs[2]) if len(arrs) > 2 else [":"] * n
    py = []
    for x, pair_d, kv_d in zip(arrs[0], pair_ds, kv_ds):
        # Spark StringToMap is null-intolerant: NULL text or delimiter -> NULL
        if not x.is_valid or pair_d is None or kv_d is None:
            py.append(None)
            continue
        out = {}
        pairs = x.as_py().split(pair_d) if pair_d else list(x.as_py())
        for pair in pairs:
            if kv_d and kv_d in pair:
                k, v = pair.split(kv_d, 1)
            else:
                k, v = pair, None
            out[k] = v  # Spark keeps the LAST duplicate
        py.append(list(out.items()))
    return ColVal.host(out_type, pa.array(py, type=pa.map_(pa.utf8(),
                                                           pa.utf8())))


@register("map_keys", lambda ts: _list_type([ts[0].children[0].data_type
                                            if ts and ts[0].children else UTF8]))
def _map_keys(args, batch, out_type):
    (a,) = _host(args, batch)
    py = [None if not x.is_valid else [k for k, _ in x.as_py() or []]
          for x in a]
    return ColVal.host(out_type, pa.array(py, type=pa.list_(a.type.key_type)))


@register("map_values", lambda ts: _list_type([ts[0].children[1].data_type
                                              if ts and ts[0].children else UTF8]))
def _map_values(args, batch, out_type):
    (a,) = _host(args, batch)
    py = [None if not x.is_valid else [v for _, v in x.as_py() or []]
          for x in a]
    return ColVal.host(out_type, pa.array(py, type=pa.list_(a.type.item_type)))


@register("element_at")
def _element_at(args, batch, out_type, ansi=None):
    from blaze_tpu_torch import config
    a, k = _host(args, batch)
    if ansi is None:
        ansi = config.ANSI_ENABLED.get()
    # a raise fires only for a row the batch's selection keeps (the host
    # mask is read once, when a raise path first asks)
    mask = []

    def _selected(row: int) -> bool:
        if not mask:
            mask.append(selected_mask(batch))
        return row >= len(mask[0]) or bool(mask[0][row])
    py = []
    if pa.types.is_map(a.type):
        for row, (x, key) in enumerate(zip(a, k)):
            if not x.is_valid or not key.is_valid:
                py.append(None)
                continue
            val, hit = None, False
            for kk, vv in x.as_py() or []:
                if kk == key.as_py():
                    val, hit = vv, True
            if not hit and ansi and _selected(row):
                raise ValueError(
                    f"[MAP_KEY_DOES_NOT_EXIST] key {key.as_py()!r} "
                    f"not found (ANSI mode)")
            py.append(val)
        return ColVal.host(out_type, pa.array(py, type=a.type.item_type))
    for row, (x, idx) in enumerate(zip(a, k)):
        if not x.is_valid or not idx.is_valid:
            py.append(None)
            continue
        lst = x.as_py() or []
        i = int(idx.as_py())
        # Spark element_at is 1-based; negative indexes from the end;
        # index 0 is an error in every mode (ElementAt.nullSafeEval)
        if i == 0 and _selected(row):
            raise ValueError(
                "[INVALID_INDEX_OF_ZERO] element_at: SQL array indices "
                "start at 1")
        if i == 0 or abs(i) > len(lst):
            if ansi and i != 0 and _selected(row):
                raise ValueError(
                    f"[INVALID_ARRAY_INDEX_IN_ELEMENT_AT] index {i} "
                    f"out of bounds for array of {len(lst)} elements")
            py.append(None)
        else:
            py.append(lst[i - 1] if i > 0 else lst[i])
    return ColVal.host(out_type, pa.array(py, type=a.type.value_type))
