"""Minimal TensorBoard event-file writer, dependency-free.

The port's own copy of video_chapter_generation_tpu/core/tb_writer.py (every definition;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import os
import socket
import struct
import time
from typing import Optional


_CRC_TABLE = []


def _build_table():
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:25."""
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:37."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:44."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:54."""
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:66."""
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:70."""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _double(field: int, value: float) -> bytes:
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:74."""
    return _tag(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:78."""
    return _tag(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:82."""
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    # Summary.Value { tag=1 (string), simple_value=2 (float) }
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:86."""
    sval = _len_delim(1, tag.encode()) + _float(2, value)
    # Summary { value=1 (repeated Value) }
    summary = _len_delim(1, sval)
    # Event { wall_time=1 (double), step=2 (int64), summary=5 }
    return _double(1, wall_time) + _int64(2, step) + _len_delim(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    # Event { wall_time=1, file_version=3 (string) }
    """Copied from video_chapter_generation_tpu/core/tb_writer.py:96."""
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


class TensorBoardWriter:
    """Scalar-only TensorBoard writer (add_scalar / flush / close).

    Copied from video_chapter_generation_tpu/core/tb_writer.py:101.
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.v2"
        )
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_file_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _scalar_event(tag, float(value), int(step), time.time())
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
