"""Digest and hash functions (port of blaze_tpu/funcs/crypto.py).

md5, sha1, sha2 and crc32 run over each row's UTF-8 or binary bytes on
the host.  Spark's crc32() is the IEEE CRC-32 of java.util.zip.CRC32,
which binascii computes; the shuffle frames' checksum is another
function, CRC32C (shuffle/crc32c.py).  Spark's hash() (murmur3, seed 42)
and xxhash64() run over every argument with the port's
`kernels/hashing.py`, the functions the shuffle partitions with, as torch
ops on the batch's device; a string argument goes there as the padded
byte matrix of `padded_string_key`.
"""

from __future__ import annotations

import binascii
import hashlib

import pyarrow as pa

from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.kernels import hashing as H
from blaze_tpu_torch.schema import INT32, INT64, TypeId, UTF8


def _digest(fn_name: str):
    def impl(args, batch, out_type):
        (a,) = [x.to_host(batch.num_rows) for x in args[:1]]
        py = []
        for x in a:
            if not x.is_valid:
                py.append(None)
                continue
            v = x.as_py()
            data = v.encode() if isinstance(v, str) else bytes(v)
            py.append(hashlib.new(fn_name, data).hexdigest())
        return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))
    return impl


register("md5", lambda ts: UTF8)(_digest("md5"))
register("sha1", lambda ts: UTF8)(_digest("sha1"))


@register("sha2", lambda ts: UTF8)
def _sha2(args, batch, out_type):
    a = args[0].to_host(batch.num_rows)
    bits = 256
    if len(args) > 1:
        b = args[1].to_host(batch.num_rows)
        if len(b) and b[0].is_valid:
            bits = int(b[0].as_py())
    if bits == 0:
        bits = 256
    name = {224: "sha224", 256: "sha256", 384: "sha384", 512: "sha512"}.get(bits)
    py = []
    for x in a:
        if not x.is_valid or name is None:
            py.append(None)
            continue
        v = x.as_py()
        data = v.encode() if isinstance(v, str) else bytes(v)
        py.append(hashlib.new(name, data).hexdigest())
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


@register("crc32", lambda ts: INT64)
def _crc32(args, batch, out_type):
    a = args[0].to_host(batch.num_rows)
    py = []
    for x in a:
        if not x.is_valid:
            py.append(None)
            continue
        v = x.as_py()
        data = v.encode() if isinstance(v, str) else bytes(v)
        py.append(binascii.crc32(data) & 0xFFFFFFFF)
    return ColVal.host(INT64, pa.array(py, type=pa.int64()))


def _hash_impl(algo: str, out_dtype):
    def impl(args, batch, out_type):
        cap, device = batch.capacity, batch.device
        cols = []
        for v in args:
            if v.dtype.id == TypeId.DECIMAL and not v.dtype.is_fixed_width:
                # precision > 18: the bytes of the unscaled BigInteger
                cols.append((*H.wide_decimal_key(v.to_host(batch.num_rows),
                                                 cap, device), "binary"))
            elif v.dtype.is_fixed_width:
                d = v.to_device(cap, device)
                cols.append((d.data, d.validity, d.dtype.id.value))
            else:
                (mat, lengths), valid = H.padded_string_key(
                    v.to_host(batch.num_rows), cap, device)
                cols.append(((mat, lengths), valid, "utf8"))
        h = H.hash_columns(cols, seed=42, algo=algo)
        return ColVal.device(out_dtype, h.to(out_dtype.torch_dtype()))
    return impl


register("hash", lambda ts: INT32)(_hash_impl("murmur3", INT32))
register("murmur3_hash", lambda ts: INT32)(_hash_impl("murmur3", INT32))
register("xxhash64", lambda ts: INT64)(_hash_impl("xxhash64", INT64))
