"""CRC32C (Castagnoli) of shuffle frame payloads.

`crc32c_built` calls the port's own C implementation (csrc/crc32c.cu,
slicing-by-8 host code that `nvcc` builds into build/kernels/ like the
kernel sources, at first use); `crc32c_plain` is the same function in
Python over one 256-entry table, the reference the tests and
`chip_smoke.py` hold the built one to.  shuffle/ipc.py takes the
google_crc32c package where it is installed and the built version
otherwise.
"""

from __future__ import annotations

_POLY = 0x82F63B78  # reflected Castagnoli polynomial


def _table():
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        out.append(c)
    return tuple(out)


_TABLE = _table()


def crc32c_plain(data, crc: int = 0) -> int:
    """CRC32C of `data` (bytes-like), continuing from `crc`."""
    c = crc ^ 0xFFFFFFFF
    t = _TABLE
    for b in bytes(data):
        c = (c >> 8) ^ t[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def crc32c_built(data, crc: int = 0) -> int:
    """CRC32C of `data` (bytes-like) through the built C entry; builds the
    library on first use and raises where it cannot be built."""
    from blaze_tpu_torch.kernels import build
    if not isinstance(data, bytes):
        data = bytes(data)
    return build.bound("crc32c", "blaze_crc32c")(data, len(data), crc)
