"""The shuffle frame checksum of the port (blaze_tpu_torch/shuffle/crc32c.py
and shuffle/ipc.py `_crc32c`): `crc32c_plain` against the google_crc32c
package on numpy-seeded payloads and against the CRC32C check value; the
choice of implementation (google_crc32c where installed, else the port's
built CRC32C, never zlib's CRC-32, raising where neither is there); and a
frame written by the port carries a checksum that `crc32c_plain` and the
JAX package's reader accept.  Exact.  The built version (csrc/crc32c.cu)
runs only where nvcc is: `chip_smoke.py` holds it to `crc32c_plain`."""

import io
import struct
import sys
from pathlib import Path

import google_crc32c
import numpy as np
import pyarrow as pa
import pytest

from blaze_tpu_torch.kernels import build
from blaze_tpu_torch.shuffle import crc32c as C
from blaze_tpu_torch.shuffle import ipc

CHECK = 0xE3069283  # CRC32C("123456789")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 4096, 65537])
def test_plain_equals_google(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert C.crc32c_plain(data) == google_crc32c.value(data)
    # continuing from a partial result gives the whole buffer's
    h = n // 3
    assert C.crc32c_plain(data[h:], C.crc32c_plain(data[:h])) == \
        google_crc32c.value(data)


def test_check_value():
    assert C.crc32c_plain(b"123456789") == CHECK
    assert google_crc32c.value(b"123456789") == CHECK
    assert C.crc32c_plain(memoryview(b"123456789")) == CHECK


@pytest.fixture
def no_google(monkeypatch):
    """google_crc32c made unimportable and the checksum choice undone."""
    monkeypatch.setitem(sys.modules, "google_crc32c", None)
    monkeypatch.setattr(ipc, "_crc32c_fn", None)


def test_without_google_takes_the_built_crc32c(no_google, monkeypatch):
    calls = []

    def built(data, crc=0):
        calls.append(len(data))
        return C.crc32c_plain(data, crc)
    monkeypatch.setattr(C, "crc32c_built", built)
    assert ipc._crc32c(b"123456789") == CHECK
    assert calls[-1] == 9


def test_without_either_raises_instead_of_zlib(no_google, monkeypatch,
                                               tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_bound", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        ipc._crc32c(b"123456789")
    with pytest.raises(RuntimeError, match="nvcc"):
        w = ipc.IpcCompressionWriter(io.BytesIO(), codec_name="raw",
                                     checksum=True)
        w.write_batch(pa.record_batch({"a": pa.array([1, 2, 3])}))
        w.finish()


def test_no_module_of_the_port_uses_zlib_crc32():
    pkg = Path(C.__file__).resolve().parents[1]
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert "import zlib" not in text and "zlib.crc32" not in text, path


def frames(data: bytes):
    """(stored CRC, payload) of each checksummed frame in `data`."""
    out, off = [], 0
    while off < len(data):
        codec, length = struct.unpack_from("<BI", data, off)
        assert codec & ipc.FLAG_CRC
        (crc,) = struct.unpack_from("<I", data, off + 5)
        out.append((crc, data[off + 9:off + 9 + length]))
        off += 9 + length
    return out


@pytest.mark.parametrize("codec", ["raw", "lz4", "zstd"])
def test_written_frames_verify_through_plain_and_jax(codec):
    from blaze_tpu.shuffle.ipc import read_batches_from_bytes
    rng = np.random.default_rng(3)
    rb = pa.record_batch({"a": pa.array(rng.integers(0, 9, 5000)),
                          "b": pa.array(rng.random(5000))})
    sink = io.BytesIO()
    w = ipc.IpcCompressionWriter(sink, target_frame_bytes=20_000,
                                 codec_name=codec, checksum=True)
    for i in range(0, 5000, 1000):
        w.write_batch(rb.slice(i, 1000))
    w.finish()
    data = sink.getvalue()
    got = frames(data)
    assert len(got) > 1
    for crc, payload in got:
        assert crc == C.crc32c_plain(payload)
    back = pa.Table.from_batches(list(read_batches_from_bytes(data)))
    assert back.equals(pa.Table.from_batches([rb]))
