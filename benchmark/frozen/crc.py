"""CRC-8 (poly 0x07, init 0, no reflection) — the checksum used for per-oligo
framing by the reference (helper.py:260, via the pypi ``crc8`` package).

Provides a table-based numpy implementation for batches of byte arrays plus a
single-buffer helper. Validated against the standard CRC-8 check value
crc8(b"123456789") == 0xF4.

Frozen copy of ``nanopore_dna_storage_tpu_torch/coding/crc.py`` at commit 35018d1,
kept by the benchmark so that its yardstick does not move with the program.
"""
from __future__ import annotations

import numpy as np


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint8)
    for byte in range(256):
        c = byte
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if (c & 0x80) else (c << 1) & 0xFF
        table[byte] = c
    return table


_TABLE = _make_table()


def crc8(data: bytes | np.ndarray) -> int:
    """CRC-8 of one byte buffer."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    c = np.uint8(0)
    for b in arr:
        c = _TABLE[c ^ b]
    return int(c)


def crc8_batch(data: np.ndarray) -> np.ndarray:
    """CRC-8 over the last axis of a uint8 array [..., n] -> uint8 [...]."""
    data = np.asarray(data, dtype=np.uint8)
    c = np.zeros(data.shape[:-1], dtype=np.uint8)
    for i in range(data.shape[-1]):
        c = _TABLE[c ^ data[..., i]]
    return c


def crc8_table() -> np.ndarray:
    """The 256-entry lookup table (for jnp-side batched checking)."""
    return _TABLE.copy()
