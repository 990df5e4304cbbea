"""String functions on the host over Arrow arrays (port of
blaze_tpu/funcs/strings.py): concat, concat_ws, upper, lower, the trims,
length, octet_length, substring, locate, instr, the pads, repeat,
reverse, split, replace, regexp_replace, regexp_extract, translate,
initcap, substring_index, ascii, chr and space, with Spark's semantics
(1-based positions, code points rather than bytes).

`substring` with a literal start and length takes one vectorised Arrow
slice over code points (`pc.utf8_slice_codeunits`, which counts code
points on utf8); any other form walks the rows as the JAX package does.
`SUBSTRING_STATS` sums the calls, rows and host seconds of both routes.
"""

from __future__ import annotations

import re
import time
from typing import Optional

import pyarrow as pa
import pyarrow.compute as pc

from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.funcs.common import const_arg, host as _host
from blaze_tpu_torch.funcs.common import per_row as _per_row
from blaze_tpu_torch.schema import DataType, Field, INT32, TypeId, UTF8

#: calls, rows and host seconds of `substring` ("vector" counts the
#: literal-argument route)
SUBSTRING_STATS = {"calls": 0, "vector": 0, "rows": 0, "seconds": 0.0}


def _utf8(ts):
    return UTF8


def _int32(ts):
    return INT32


def _null_utf8(n: int) -> "ColVal":
    return ColVal.host(UTF8, pa.nulls(n, type=pa.utf8()))


@register("concat", _utf8)
def _concat(args, batch, out_type):
    arrs = _host(args, batch)
    out = arrs[0].cast(pa.utf8())
    for a in arrs[1:]:
        out = pc.binary_join_element_wise(out, a.cast(pa.utf8()), "")
    return ColVal.host(UTF8, out)


@register("concat_ws", _utf8)
def _concat_ws(args, batch, out_type):
    arrs = _host(args, batch)
    seps = _per_row(arrs[0])
    # Spark concat_ws accepts both strings and ARRAY<STRING> arguments
    # (ConcatWs flattens arrays in place, skipping null elements)
    parts = [a if pa.types.is_list(a.type) else a.cast(pa.utf8())
             for a in arrs[1:]]
    if not parts:
        # Spark: NULL separator -> NULL result
        return ColVal.host(UTF8, pa.array(
            ["" if s is not None else None for s in seps], type=pa.utf8()))
    # Spark concat_ws SKIPS null arguments instead of nulling the result
    py = []
    for i in range(batch.num_rows):
        if seps[i] is None:
            py.append(None)
            continue
        vals = []
        for p in parts:
            if not p[i].is_valid:
                continue
            v = p[i].as_py()
            if isinstance(v, list):
                vals.extend(str(x) for x in v if x is not None)
            else:
                vals.append(v)
        py.append(seps[i].join(vals))
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("upper", _utf8)
def _upper(args, batch, out_type):
    (a,) = _host(args, batch)
    return ColVal.host(UTF8, pc.utf8_upper(a))


@register("lower", _utf8)
def _lower(args, batch, out_type):
    (a,) = _host(args, batch)
    return ColVal.host(UTF8, pc.utf8_lower(a))


@register("trim", _utf8)
def _trim(args, batch, out_type):
    arrs = [args[0].to_host(batch.num_rows)]
    if len(args) == 1:
        # Spark's UTF8String.trim strips ONLY the space character
        # (0x20), not tabs/newlines (ref spark TrimFunctionsSuite)
        return ColVal.host(UTF8, pc.utf8_trim(arrs[0], characters=" "))
    chars = const_arg(args[1], batch, "trim")
    if chars is None:
        return _null_utf8(batch.num_rows)
    return ColVal.host(UTF8, pc.utf8_trim(arrs[0], characters=chars))


@register("ltrim", _utf8)
def _ltrim(args, batch, out_type):
    arrs = [args[0].to_host(batch.num_rows)]
    if len(args) == 1:
        # Spark's UTF8String.trim strips ONLY the space character
        # (0x20), not tabs/newlines (ref spark TrimFunctionsSuite)
        return ColVal.host(UTF8, pc.utf8_ltrim(arrs[0], characters=" "))
    chars = const_arg(args[1], batch, "ltrim")
    if chars is None:
        return _null_utf8(batch.num_rows)
    return ColVal.host(UTF8, pc.utf8_ltrim(arrs[0], characters=chars))


@register("rtrim", _utf8)
def _rtrim(args, batch, out_type):
    arrs = [args[0].to_host(batch.num_rows)]
    if len(args) == 1:
        # Spark's UTF8String.trim strips ONLY the space character
        # (0x20), not tabs/newlines (ref spark TrimFunctionsSuite)
        return ColVal.host(UTF8, pc.utf8_rtrim(arrs[0], characters=" "))
    chars = const_arg(args[1], batch, "rtrim")
    if chars is None:
        return _null_utf8(batch.num_rows)
    return ColVal.host(UTF8, pc.utf8_rtrim(arrs[0], characters=chars))


@register("length", _int32)
@register("char_length", _int32)
def _length(args, batch, out_type):
    (a,) = _host(args, batch)
    if pa.types.is_binary(a.type):
        return ColVal.host(INT32, pc.binary_length(a).cast(pa.int32()))
    return ColVal.host(INT32, pc.utf8_length(a).cast(pa.int32()))


@register("octet_length", _int32)
def _octet_length(args, batch, out_type):
    (a,) = _host(args, batch)
    return ColVal.host(INT32, pc.binary_length(a).cast(pa.int32()))


@register("substring", _utf8)
@register("substr", _utf8)
def _substring(args, batch, out_type):
    t0 = time.perf_counter()
    s = args[0].to_host(batch.num_rows)
    consts = _literal_slice(args, batch)
    if consts is None:
        out = substring_rows(s, *_host(args[1:], batch))
    else:
        out = substring_const(s, *consts)
        SUBSTRING_STATS["vector"] += 1
    SUBSTRING_STATS["calls"] += 1
    SUBSTRING_STATS["rows"] += batch.num_rows
    SUBSTRING_STATS["seconds"] += time.perf_counter() - t0
    return ColVal.host(UTF8, out)


def _literal_slice(args, batch):
    """(start, length or None) when both are Literals, else None."""
    if not all(a.literal for a in args[1:]):
        return None
    vals = [const_arg(a, batch, "substring") for a in args[1:]]
    return vals[0], (vals[1] if len(vals) > 1 else None), len(vals) > 1


def substring_rows(s: pa.Array, starts: pa.Array,
                   lengths: Optional[pa.Array] = None) -> pa.Array:
    """Spark's substring(s, start[, length]) row by row over code points:
    start 0 acts as 1, a negative start counts from the end, and the
    window's end comes from the unclamped start, so a window reaching
    past the front shrinks; the 2-argument form runs to the end, a NULL
    length gives NULL."""
    has_len = lengths is not None
    starts = _per_row(starts)
    lens = _per_row(lengths) if has_len else [None] * len(s)
    py = []
    for v, start, length in zip(s.to_pylist(), starts, lens):
        if v is None or start is None or (has_len and length is None):
            py.append(None)
            continue
        n = len(v)
        pos = int(start)
        st = pos - 1 if pos > 0 else (n + pos if pos < 0 else 0)
        end = n if not has_len else st + int(length)
        py.append(v[max(st, 0):max(min(end, n), 0)])
    return pa.array(py, type=pa.utf8())


def substring_const(s: pa.Array, start, length, has_len: bool = True
                    ) -> pa.Array:
    """`substring_rows` for one start and length, as one Arrow slice over
    code points; a NULL start or length gives NULL rows."""
    if isinstance(s, pa.ChunkedArray):
        s = s.combine_chunks()
    if start is None or (has_len and length is None):
        return pa.nulls(len(s), type=pa.utf8())
    s = s.cast(pa.utf8())
    pos = int(start)
    if pos >= 0:
        st = max(pos - 1, 0)
        if not has_len:
            return pc.utf8_slice_codeunits(s, start=st)
        return pc.utf8_slice_codeunits(s, start=st,
                                       stop=max(st + int(length), st))
    # negative: Arrow counts a negative start and stop from the end and
    # clamps both at the front, as the row form's max(., 0) does; a stop
    # at or past the end is no stop
    if not has_len or pos + int(length) >= 0:
        return pc.utf8_slice_codeunits(s, start=pos)
    return pc.utf8_slice_codeunits(s, start=pos, stop=pos + int(length))


@register("locate", _int32)
@register("position", _int32)
def _locate(args, batch, out_type):
    """Spark's locate/position take (substr, str[, start]) — the REVERSE
    of instr/strpos's (str, substr).  The wire's Strpos decodes to
    "strpos" (DataFusion order, ref planner.rs:1379), so only
    Catalyst-order call sites reach this swap.  An optional 1-based
    `start` offsets the search; Spark returns 0 when start < 1 and NULL
    when start is NULL."""
    n = batch.num_rows
    if len(args) <= 2:
        return _instr([args[1], args[0]], batch, out_type)
    starts = args[2].to_host(n).to_pylist()
    hays = args[1].to_host(n).to_pylist()
    needles = args[0].to_host(n).to_pylist()
    out = []
    for st, h, nd in zip(starts, hays, needles):
        if st is None:
            # Spark's StringLocate: a NULL start yields 0, not NULL
            # (the explicit Hive/MySQL-conformance branch in
            # stringExpressions.scala)
            out.append(0)
        elif h is None or nd is None:
            out.append(None)
        elif st < 1:
            out.append(0)
        else:
            pos = h.find(nd, st - 1)
            out.append(0 if pos < 0 else pos + 1)
    return ColVal.host(INT32, pa.array(out, type=pa.int32()))


@register("strpos", _int32)
@register("instr", _int32)
def _instr(args, batch, out_type):
    hay = args[0].to_host(batch.num_rows)
    arr1 = args[1].to_host(batch.num_rows)
    try:
        needle = const_arg(args[1], batch, "instr", arr=arr1)
        if needle is None:
            # NULL needle -> NULL result
            return ColVal.host(INT32, pa.nulls(batch.num_rows,
                                               type=pa.int32()))
    except NotImplementedError:
        # column-valued needle: per-row search
        needles = _per_row(arr1)
        py = []
        for x, nd in zip(hay, needles):
            if not x.is_valid or nd is None:
                py.append(None)
            else:
                py.append(x.as_py().find(nd) + 1)
        return ColVal.host(INT32, pa.array(py, type=pa.int32()))
    found = pc.find_substring(hay, pattern=needle)
    # arrow: -1 when missing; Spark: 0 missing, 1-based otherwise
    out = pc.add(found, 1)
    return ColVal.host(INT32, out.cast(pa.int32()))


def _pad(args, batch, left: bool):
    arrs = _host(args, batch)
    nrows = batch.num_rows
    widths = _per_row(arrs[1])
    fills = _per_row(arrs[2]) if len(args) > 2 else [" "] * nrows
    py = []
    for x, width, fill in zip(arrs[0], widths, fills):
        if not x.is_valid or width is None or fill is None:
            py.append(None)
            continue
        v = x.as_py()
        width = int(width)
        if width <= 0:
            py.append("")
        elif len(v) >= width:
            py.append(v[:width])
        elif not fill:
            py.append(v)  # Spark: empty pad string pads nothing
        else:
            pad = (fill * width)[:width - len(v)]
            py.append(pad + v if left else v + pad)
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("lpad", _utf8)
def _lpad(args, batch, out_type):
    return _pad(args, batch, left=True)


@register("rpad", _utf8)
def _rpad(args, batch, out_type):
    return _pad(args, batch, left=False)


@register("repeat", _utf8)
def _repeat(args, batch, out_type):
    arrs = _host(args, batch)
    ns = _per_row(arrs[1])
    py = [None if (not x.is_valid or n is None) else x.as_py() * max(int(n), 0)
          for x, n in zip(arrs[0], ns)]
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("reverse", _utf8)
def _reverse(args, batch, out_type):
    (a,) = _host(args, batch)
    return ColVal.host(UTF8, pc.utf8_reverse(a))


@register("split", lambda ts: DataType(TypeId.LIST, children=(
    Field("item", UTF8),)))
def _split(args, batch, out_type):
    arrs = [args[0].to_host(batch.num_rows)]
    pattern = const_arg(args[1], batch, "split")
    if pattern is None:
        return ColVal.host(out_type, pa.nulls(batch.num_rows,
                                              type=pa.list_(pa.utf8())))
    if len(args) > 2:
        limit = const_arg(args[2], batch, "split")
        if limit is None:
            return ColVal.host(out_type, pa.nulls(batch.num_rows,
                                                  type=pa.list_(pa.utf8())))
        limit = int(limit)
    else:
        limit = -1
    prog = re.compile(pattern)
    py = []
    for x in arrs[0]:
        if not x.is_valid:
            py.append(None)
        elif limit == 1:
            py.append([x.as_py()])  # Java Pattern.split: at most 1 element
        else:
            parts = prog.split(x.as_py(),
                               maxsplit=0 if limit <= 0 else limit - 1)
            if limit == 0:  # Java limit=0 drops trailing empty strings
                while parts and parts[-1] == "":
                    parts.pop()
            py.append(parts)
    return ColVal.host(out_type, pa.array(py, type=pa.list_(pa.utf8())))


@register("replace", _utf8)
def _replace(args, batch, out_type):
    arrs = [args[0].to_host(batch.num_rows)]
    search = const_arg(args[1], batch, "replace")
    repl = const_arg(args[2], batch, "replace") if len(args) > 2 else ""
    if search is None or repl is None:
        return _null_utf8(batch.num_rows)
    return ColVal.host(UTF8, pc.replace_substring(arrs[0], pattern=search,
                                                  replacement=repl))


@register("regexp_replace", _utf8)
def _regexp_replace(args, batch, out_type):
    arrs = [args[0].to_host(batch.num_rows)]
    pattern = const_arg(args[1], batch, "regexp_replace")
    repl = const_arg(args[2], batch, "regexp_replace") if len(args) > 2 else ""
    if pattern is None or repl is None:
        return _null_utf8(batch.num_rows)
    # Spark uses Java Matcher replacement semantics: $N is a group
    # reference, \$ a literal dollar, \X a literal X.  RE2 spells group
    # refs \N — protect escapes first (a literal \1 must NOT become a
    # group ref, an escaped \$ must survive the $N translation), then
    # translate unescaped $N (single digit: RE2 rewrites know \0-\9).
    repl = re.sub(r"\\(.)",
                   lambda m: "\x00" if m.group(1) == "$"
                   else ("\\\\" if m.group(1) == "\\" else m.group(1)),
                   repl)
    repl = re.sub(r"\$(\d)", r"\\\1", repl)
    repl = repl.replace("\x00", "$")
    return ColVal.host(UTF8, pc.replace_substring_regex(
        arrs[0], pattern=pattern, replacement=repl))


@register("regexp_extract", _utf8)
def _regexp_extract(args, batch, out_type):
    arrs = [args[0].to_host(batch.num_rows)]
    pattern = const_arg(args[1], batch, "regexp_extract")
    group_v = const_arg(args[2], batch, "regexp_extract") if len(args) > 2 else 1
    if pattern is None or group_v is None:
        return _null_utf8(batch.num_rows)
    prog = re.compile(pattern)
    group = int(group_v)
    py = []
    for x in arrs[0]:
        if not x.is_valid:
            py.append(None)
            continue
        m = prog.search(x.as_py())
        py.append(m.group(group) if m and group <= (m.lastindex or 0) or
                  (m and group == 0) else "")
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("translate", _utf8)
def _translate(args, batch, out_type):
    arrs = [args[0].to_host(batch.num_rows)]
    src = const_arg(args[1], batch, "translate")
    dst = const_arg(args[2], batch, "translate")
    if src is None or dst is None:
        return _null_utf8(batch.num_rows)
    table = {}
    for i, ch in enumerate(src):
        table[ord(ch)] = dst[i] if i < len(dst) else None
    py = [None if not x.is_valid else x.as_py().translate(table)
          for x in arrs[0]]
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("initcap", _utf8)
def _initcap(args, batch, out_type):
    (a,) = _host(args, batch)
    py = []
    for x in a:
        if not x.is_valid:
            py.append(None)
        else:
            py.append(" ".join(w[:1].upper() + w[1:].lower() if w else w
                               for w in x.as_py().split(" ")))
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("substring_index", _utf8)
def _substring_index(args, batch, out_type):
    arrs = _host(args, batch)
    delims = _per_row(arrs[1])
    counts = _per_row(arrs[2])
    py = []
    for x, delim, count in zip(arrs[0], delims, counts):
        if not x.is_valid or delim is None or count is None:
            py.append(None)
            continue
        v = x.as_py()
        count = int(count)
        if not delim or count == 0:
            py.append("")
            continue
        parts = v.split(delim)
        if count > 0:
            py.append(delim.join(parts[:count]))
        else:
            py.append(delim.join(parts[count:]))
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("ascii", _int32)
def _ascii(args, batch, out_type):
    (a,) = _host(args, batch)
    py = [None if not x.is_valid else (ord(x.as_py()[0]) if x.as_py() else 0)
          for x in a]
    return ColVal.host(INT32, pa.array(py, type=pa.int32()))


@register("chr", _utf8)
def _chr(args, batch, out_type):
    (a,) = _host(args, batch)
    py = []
    for x in a:
        if not x.is_valid:
            py.append(None)
        else:
            n = int(x.as_py())
            # Spark Chr: negative -> empty string; multiples of 256 ->
            # the NUL character, NOT empty (ref stringExpressions.Chr)
            if n < 0:
                py.append("")
            else:
                code = n & 255
                py.append("\u0000" if code == 0 else chr(code))
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("space", _utf8)
def _space(args, batch, out_type):
    (a,) = _host(args, batch)
    py = [None if not x.is_valid else " " * max(int(x.as_py()), 0) for x in a]
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))
