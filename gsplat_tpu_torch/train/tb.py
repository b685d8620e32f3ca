"""Minimal TensorBoard event-file writer (scalars), dependency-free: the
port's copy of gsplat_tpu/train/tb.py.

The reference explicitly skips TensorBoard ('// ignore tensorboard writer!!',
src/utils/train_utils.cpp:92); upstream 3DGS logs loss/PSNR scalars to TB.
This writes the same `events.out.tfevents.*` files TensorBoard reads, by
hand-encoding the two protos involved (Event, Summary) and the TFRecord
framing (length + masked CRC32C), so no tensorflow/tensorboard import is
needed at train time.

Wire format notes:
- protobuf: varint keys `(field_num << 3) | wire_type`; doubles/floats are
  fixed64/fixed32 little-endian; submessages are length-delimited.
- TFRecord: u64-LE length, masked crc32c(length), payload, masked crc32c(payload)
  where masked(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32 and crc32c is
  the reflected Castagnoli CRC (poly 0x82F63B78).
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path
from typing import Optional

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, *, file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    out = _key(1, 1) + struct.pack("<d", wall_time)  # wall_time: double
    if step:
        out += _key(2, 0) + _varint(step)            # step: int64 (non-negative here)
    if file_version is not None:
        out += _ld(3, file_version.encode())
    if summary is not None:
        out += _ld(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _ld(1, tag.encode()) + _key(2, 5) + struct.pack("<f", float(value))
    return _ld(1, val)  # Summary.value (repeated)


class TBWriter:
    """Append-only scalar writer producing TensorBoard-readable event files."""

    def __init__(self, logdir: str | Path):
        p = Path(logdir)
        p.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(p / fname, "ab")
        self._record(_event(time.time(), 0, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        hdr = struct.pack("<Q", len(payload))
        self._f.write(
            hdr + struct.pack("<I", _masked_crc(hdr)) + payload
            + struct.pack("<I", _masked_crc(payload))
        )

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._f is None:
            return
        self._record(_event(time.time(), int(step),
                            summary=_scalar_summary(tag, value)))

    def scalars(self, step: int, prefix: str = "", **values) -> None:
        for k, v in values.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            self.scalar(prefix + k, f, step)

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
