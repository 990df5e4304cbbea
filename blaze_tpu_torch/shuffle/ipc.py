"""Framed compressed Arrow-IPC block format (a copy of the file-frame part
of blaze_tpu/shuffle/ipc.py).

Frame layout (little-endian):
    [u8  codec]  low 7 bits: 0 = raw, 1 = zstd, 2 = lz4-frame.  High bit
                 (FLAG_CRC): a u32 CRC32C of the payload follows the length.
    [u32 length] compressed payload size
    [u32 crc32c] only when FLAG_CRC: checksum of the payload bytes
    [payload]    one Arrow IPC *stream* (schema + N record batches)

Frames are self-describing and concatenable: a reader can start at any
frame boundary, which is what the shuffle `.index` file points at.  Batches
are buffered until the target frame size.  A CRC mismatch, or a codec byte
with unknown bits, raises ShuffleChecksumError.

The checksum is CRC32C wherever the port runs: the `google_crc32c`
package where it is installed, else the port's own build of it
(csrc/crc32c.cu); with neither, writing or checking a frame raises.
Socket transports, fault sites and the worker wire belong to later slices.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Iterator, List, Optional

import pyarrow as pa

from blaze_tpu_torch import config


class ShuffleChecksumError(IOError):
    """A shuffle frame failed its CRC32C check or carries a codec byte this
    reader does not know (a copy of blaze_tpu.faults.ShuffleChecksumError)."""


_HEADER = struct.Struct("<BI")
_CRC = struct.Struct("<I")
CODEC_RAW = 0
CODEC_ZSTD = 1
CODEC_LZ4 = 2
FLAG_CRC = 0x80
_CODEC_MASK = 0x7F
_KNOWN_CODECS = (CODEC_RAW, CODEC_ZSTD, CODEC_LZ4)

_crc32c_fn = None


def _pick_crc32c():
    """google_crc32c where it is installed, else the port's built CRC32C
    (shuffle/crc32c.py); raises where neither is there.  Never zlib's
    CRC-32: that is another polynomial, and frames carrying it fail the
    check of every other installation."""
    try:
        from google_crc32c import value
    except ImportError:
        from blaze_tpu_torch.shuffle.crc32c import crc32c_built
        crc32c_built(b"")  # builds and loads it now, or raises
        return crc32c_built

    def google(data) -> int:
        if not isinstance(data, bytes):
            data = bytes(data)  # google_crc32c rejects memoryviews
        return value(data)
    return google


def _crc32c(data) -> int:
    global _crc32c_fn
    if _crc32c_fn is None:
        _crc32c_fn = _pick_crc32c()
    return _crc32c_fn(data)


def _check_frame_byte(raw_codec: int) -> int:
    codec = raw_codec & _CODEC_MASK
    if codec not in _KNOWN_CODECS or (raw_codec & ~(FLAG_CRC | _CODEC_MASK)):
        raise ShuffleChecksumError(
            f"unknown shuffle frame codec byte 0x{raw_codec:02x}: frame "
            f"written by a newer format than this reader understands")
    return codec


def _verify_crc(expected: int, payload) -> None:
    actual = _crc32c(payload)
    if actual != expected:
        raise ShuffleChecksumError(
            f"shuffle frame CRC32C mismatch: stored 0x{expected:08x}, "
            f"computed 0x{actual:08x} over {len(payload)} bytes "
            f"(corrupted block)")


def _lz4():
    return pa.Codec("lz4") if pa.Codec.is_available("lz4") else None


def _codec_from_name(name: str) -> int:
    name = name.lower()
    if name == "lz4" and _lz4() is not None:
        return CODEC_LZ4
    return CODEC_ZSTD if name in ("zstd", "zstandard") else CODEC_RAW


def _get_codec() -> int:
    if config.conf.is_set(config.IO_COMPRESSION_CODEC):
        name = config.IO_COMPRESSION_CODEC.get()
    elif config.conf.is_set(config.SPILL_COMPRESSION_CODEC):
        name = config.SPILL_COMPRESSION_CODEC.get()
    else:
        name = config.IO_COMPRESSION_CODEC.get()  # default: lz4
    return _codec_from_name(name)


def _compress(codec: int, payload: bytes) -> bytes:
    if codec == CODEC_LZ4:
        # lz4 payloads lead with the raw size (Arrow's Codec.decompress
        # requires it)
        return (struct.pack("<I", len(payload)) +
                _lz4().compress(payload, asbytes=True))
    if codec == CODEC_ZSTD:
        import zstandard
        return zstandard.ZstdCompressor(level=1).compress(payload)
    return payload


def _decompress(codec: int, payload) -> bytes:
    if codec == CODEC_LZ4:
        codec_obj = _lz4()
        if codec_obj is None:
            raise RuntimeError("shuffle frame is lz4-compressed but this "
                               "Arrow build lacks the lz4 codec")
        (raw_size,) = struct.unpack_from("<I", payload)
        return codec_obj.decompress(bytes(payload[4:]),
                                    decompressed_size=raw_size, asbytes=True)
    if codec == CODEC_ZSTD:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(bytes(payload))
    return payload


class IpcCompressionWriter:
    """Streams record batches into framed compressed IPC blocks."""

    def __init__(self, sink: BinaryIO,
                 target_frame_bytes: Optional[int] = None,
                 codec_name: Optional[str] = None,
                 checksum: Optional[bool] = None):
        self._sink = sink
        self._codec = (_codec_from_name(codec_name) if codec_name
                       else _get_codec())
        self._target = (target_frame_bytes or
                        config.SHUFFLE_COMPRESSION_TARGET_BUF_SIZE.get())
        self._checksum = (config.SHUFFLE_CHECKSUM_ENABLE.get()
                          if checksum is None else checksum)
        self._pending: List[pa.RecordBatch] = []
        self._pending_bytes = 0
        self.raw_bytes_written = 0
        self.frames_written = 0

    def write_batch(self, batch: pa.RecordBatch) -> int:
        """Buffer a batch; flush a frame when the target size is reached.
        Returns the batch's in-memory size."""
        nbytes = batch.nbytes
        self._pending.append(batch)
        self._pending_bytes += nbytes
        if self._pending_bytes >= self._target:
            self.flush_frame()
        return nbytes

    def flush_frame(self) -> None:
        if not self._pending:
            return
        buf = io.BytesIO()
        with pa.ipc.new_stream(buf, self._pending[0].schema) as w:
            for b in self._pending:
                w.write_batch(b)
        payload = _compress(self._codec, buf.getvalue())
        if self._checksum:
            self._sink.write(_HEADER.pack(self._codec | FLAG_CRC,
                                          len(payload)))
            self._sink.write(_CRC.pack(_crc32c(payload)))
        else:
            self._sink.write(_HEADER.pack(self._codec, len(payload)))
        self._sink.write(payload)
        self.raw_bytes_written += self._pending_bytes
        self.frames_written += 1
        self._pending.clear()
        self._pending_bytes = 0

    def finish(self) -> None:
        self.flush_frame()


class IpcCompressionReader:
    """Reads frames until EOF (or a byte limit for file-segment blocks)."""

    def __init__(self, source: BinaryIO, limit: Optional[int] = None):
        self._source = source
        self._remaining = limit

    def _read_exact(self, n: int) -> Optional[bytes]:
        if self._remaining is not None:
            if self._remaining == 0:
                return None
            if self._remaining < n:
                raise EOFError("frame crosses segment boundary")
        data = self._source.read(n)
        if not data:
            return None
        while len(data) < n:
            more = self._source.read(n - len(data))
            if not more:
                raise EOFError("truncated IPC frame")
            data += more
        if self._remaining is not None:
            self._remaining -= n
        return data

    def read_batches(self) -> Iterator[pa.RecordBatch]:
        while True:
            header = self._read_exact(_HEADER.size)
            if header is None:
                return
            raw_codec, length = _HEADER.unpack(header)
            codec = _check_frame_byte(raw_codec)
            crc = None
            if raw_codec & FLAG_CRC:
                crc_bytes = self._read_exact(_CRC.size)
                if crc_bytes is None:
                    raise EOFError("truncated IPC frame checksum")
                (crc,) = _CRC.unpack(crc_bytes)
            payload = self._read_exact(length)
            if payload is None:
                raise EOFError("truncated IPC frame payload")
            if crc is not None:
                _verify_crc(crc, payload)
            raw = _decompress(codec, payload)
            with pa.ipc.open_stream(io.BytesIO(raw)) as r:
                yield from r


def read_frames_from_buffer(buf: "pa.Buffer") -> Iterator[pa.RecordBatch]:
    """Decode frames out of a zero-copy buffer (an mmap-backed file
    segment): raw frames hand Arrow IPC an aligned copy of the payload,
    compressed frames go through the decompressor."""
    mv = memoryview(buf)
    pos = 0
    end = len(buf)
    while pos < end:
        raw_codec, length = _HEADER.unpack_from(mv, pos)
        pos += _HEADER.size
        codec = _check_frame_byte(raw_codec)
        if raw_codec & FLAG_CRC:
            (crc,) = _CRC.unpack_from(mv, pos)
            pos += _CRC.size
            _verify_crc(crc, mv[pos:pos + length])
        if codec == CODEC_RAW:
            payload = buf.slice(pos, length)
            if payload.address % 64:
                # frames sit behind a 5- or 9-byte header, so mmap slices
                # are never 64-byte aligned: one aligned copy
                aligned = pa.allocate_buffer(length)
                memoryview(aligned)[:] = memoryview(payload)
                payload = aligned
            with pa.ipc.open_stream(pa.BufferReader(payload)) as r:
                yield from r
        else:
            raw = _decompress(codec, bytes(mv[pos:pos + length]))
            with pa.ipc.open_stream(io.BytesIO(raw)) as r:
                yield from r
        pos += length
