"""JSON functions on the host (port of blaze_tpu/funcs/json_fns.py):
get_json_object over a JSONPath subset ($.field, $.a.b, $.a[0],
$.a[0].b, $[0], and $.a[*] wildcards returning JSON arrays), and
to_json with Jackson's shapes (null struct fields omitted at every
depth, null map values and array elements kept, an empty map `{}`).
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Optional

import pyarrow as pa

from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.schema import UTF8

_TOKEN = re.compile(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+|\*)\]|\['([^']*)'\]")


def parse_path(path: str) -> Optional[List[object]]:
    if not path or not path.startswith("$"):
        return None
    out: List[object] = []
    i = 1
    for m in _TOKEN.finditer(path, 1):
        if m.start() != i:
            return None
        i = m.end()
        if m.group(1) is not None:
            out.append(m.group(1))
        elif m.group(2) is not None:
            out.append("*" if m.group(2) == "*" else int(m.group(2)))
        else:
            out.append(m.group(3))
    if i != len(path):
        return None
    return out


def _walk(doc: Any, steps: List[object], i: int = 0):
    if i == len(steps):
        yield doc
        return
    s = steps[i]
    if s == "*":
        if isinstance(doc, list):
            for item in doc:
                yield from _walk(item, steps, i + 1)
    elif isinstance(s, int):
        if isinstance(doc, list) and 0 <= s < len(doc):
            yield from _walk(doc[s], steps, i + 1)
    else:
        if isinstance(doc, dict) and s in doc:
            yield from _walk(doc[s], steps, i + 1)


def _render(values: List[Any], has_wildcard: bool) -> Optional[str]:
    if not values:
        return None
    if has_wildcard:
        # wildcard returns a JSON array of all matches (Spark semantics)
        if len(values) == 1:
            v = values[0]
            return json.dumps(v) if isinstance(v, (dict, list)) else \
                (None if v is None else str(v))
        return json.dumps(values)
    v = values[0]
    if v is None:
        return None
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


@register("get_json_object", lambda ts: UTF8)
def _get_json_object(args, batch, out_type):
    arrs = [a.to_host(batch.num_rows) for a in args]
    path_lit = arrs[1][0].as_py() if len(arrs[1]) and arrs[1][0].is_valid \
        else None
    steps = parse_path(path_lit) if path_lit is not None else None
    py = []
    for x in arrs[0]:
        if not x.is_valid or steps is None:
            py.append(None)
            continue
        try:
            doc = json.loads(x.as_py())
        except (ValueError, TypeError):
            py.append(None)
            continue
        vals = list(_walk(doc, steps))
        py.append(_render(vals, "*" in steps))
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("to_json", lambda ts: UTF8)
def _to_json(args, batch, out_type):
    (a,) = [x.to_host(batch.num_rows) for x in args[:1]]
    if isinstance(a, pa.ChunkedArray):
        a = a.combine_chunks()

    def render(v, t):
        """Type-driven JSON shape (JacksonGenerator parity): null
        STRUCT fields are omitted at every depth (ignoreNullFields
        default true), null MAP values and ARRAY elements are kept,
        an empty map is {} not []."""
        if v is None:
            return None
        if pa.types.is_struct(t):
            return {f.name: render(v.get(f.name), f.type)
                    for f in t if v.get(f.name) is not None}
        if pa.types.is_map(t):
            return {k: render(val, t.item_type) for k, val in v}
        if pa.types.is_list(t) or pa.types.is_large_list(t):
            return [render(e, t.value_type) for e in v]
        return v

    py = []
    for x in a:
        if not x.is_valid:
            py.append(None)
        else:
            py.append(json.dumps(render(x.as_py(), a.type),
                                 separators=(",", ":")))
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))
