"""Minimal TensorBoard scalar-event writer (no TensorFlow dependency; the
port's own copy of the JAX package's ``utils/tbwriter.py``).

The reference config's ``tb_log_interval`` key (``srdiff/config.yaml:60``)
names the upstream trainer's TensorBoard cadence; the reference repo itself
has no TB code. Here the trainer honors the key twice: a JSONL metrics log
(grep-able, the primary artifact) and real TB event files this module emits,
so ``tensorboard --logdir work_dir`` works out of the box.

The wire format is stable and tiny — a TFRecord stream of serialized
``tensorflow.Event`` protos, each record framed as::

    uint64 length | uint32 masked_crc32c(length) | bytes data
                  | uint32 masked_crc32c(data)

with scalar summaries using only proto fields that haven't changed since
TF 1.0 (``Event.wall_time``/``step``/``summary``; ``Summary.Value.tag``/
``simple_value``). Both the protobuf encoding and the CRC32C (Castagnoli)
are hand-rolled below (~60 lines) rather than pulling in tensorflow.
"""

from __future__ import annotations

import os
import socket
import struct
import time


# --------------------------------------------------------------- crc32c
def _make_crc32c_table() -> list[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC mask: rotate right 15 and add a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def scalar_event(tag: str, value: float, step: int, wall_time: float | None = None) -> bytes:
    """Serialized ``Event`` proto with one scalar ``Summary.Value``."""
    sv = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))  # Summary.Value
    summary = _pb_bytes(1, sv)  # Summary.value (repeated, field 1)
    return (
        _pb_double(1, time.time() if wall_time is None else wall_time)  # wall_time
        + _pb_int64(2, int(step))  # step
        + _pb_bytes(5, summary)  # summary
    )


def file_version_event(wall_time: float | None = None) -> bytes:
    return (
        _pb_double(1, time.time() if wall_time is None else wall_time)
        + _pb_bytes(3, b"brain.Event:2")  # file_version
    )


def write_record(f, data: bytes) -> None:
    header = struct.pack("<Q", len(data))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(data)
    f.write(struct.pack("<I", masked_crc32c(data)))


def read_records(path: str):
    """Inverse of :func:`write_record` (tests + debugging): yields the data
    bytes of each record, verifying both CRCs."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == masked_crc32c(header), "corrupt record header"
            (n,) = struct.unpack("<Q", header)
            data = f.read(n)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert dcrc == masked_crc32c(data), "corrupt record data"
            yield data


class TBWriter:
    """Append-only scalar writer; one ``events.out.tfevents.*`` file per run."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        write_record(self._f, file_version_event())
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        write_record(self._f, scalar_event(tag, value, step))

    def add_scalars(self, scalars: dict, step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            self.add_scalar(prefix + k, fv, step)
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
