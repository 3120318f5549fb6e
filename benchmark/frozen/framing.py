"""Per-oligo framing: PRP-scrambled index + payload + CRC8 (+ optional pad bit).

Vectorized equivalents of the reference's per-oligo Python loop
(helper.py:256-264 for encode; helper.py:371-388 for list decode). All
operations work on uint8 bit arrays over a batch of oligos.

Frozen copy of ``nanopore_dna_storage_tpu_torch/coding/framing.py`` at commit 35018d1,
kept by the benchmark so that its yardstick does not move with the program.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .config import FramingConfig
from .crc import crc8_batch


def prp_index(indices: np.ndarray, f: FramingConfig) -> np.ndarray:
    """Pseudorandom-permute oligo indices: x -> a*x + b mod 2^index_len."""
    return (f.prp_a * np.asarray(indices, dtype=np.int64) + f.prp_b) % (
        1 << f.index_len)


def prp_index_inverse(scrambled: np.ndarray, f: FramingConfig) -> np.ndarray:
    """Inverse PRP: x -> a_inv*(x - b) mod 2^index_len."""
    return (f.prp_a_inv * (np.asarray(scrambled, dtype=np.int64) - f.prp_b)) % (
        1 << f.index_len)


def bytes_to_bits(data: np.ndarray) -> np.ndarray:
    """uint8 [..., n] bytes -> uint8 [..., 8n] bits, MSB first."""
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1)


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """uint8 [..., 8n] bits (MSB first) -> uint8 [..., n] bytes."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1)


def int_to_bits_msb(values: np.ndarray, nbits: int) -> np.ndarray:
    """int [...,] -> uint8 [..., nbits] bits, MSB first."""
    shifts = np.arange(nbits - 1, -1, -1)
    return ((np.asarray(values, dtype=np.int64)[..., None] >> shifts) & 1).astype(
        np.uint8)


def bits_to_int_msb(bits: np.ndarray) -> np.ndarray:
    nbits = bits.shape[-1]
    weights = 1 << np.arange(nbits - 1, -1, -1, dtype=np.int64)
    return (np.asarray(bits, dtype=np.int64) @ weights)


def frame_oligos(payloads: np.ndarray, f: FramingConfig,
                 pad: bool = False) -> np.ndarray:
    """Attach PRP index and CRC to payload bytes.

    Args:
      payloads: uint8 [num_oligos, bytes_per_oligo].
    Returns:
      uint8 [num_oligos, msg_len] message bits where
      msg_len = index_len + 8*bytes_per_oligo + crc_len + pad.

    Matches helper.py:256-264: the CRC is computed over the index packed into
    ceil(index_len/8) bytes (zero-padded high bits) concatenated with the
    payload; the message carries only the low index_len index bits.
    """
    payloads = np.atleast_2d(np.asarray(payloads, dtype=np.uint8))
    num = payloads.shape[0]
    index_bytes_len = -(-f.index_len // 8)
    scrambled = prp_index(np.arange(num), f)
    index_bits_full = int_to_bits_msb(scrambled, 8 * index_bytes_len)
    index_bytes = bits_to_bytes(index_bits_full)
    crc = crc8_batch(np.concatenate([index_bytes, payloads], axis=1))
    msg = np.concatenate(
        [index_bits_full[:, -f.index_len:], bytes_to_bits(payloads),
         int_to_bits_msb(crc, f.crc_len)], axis=1)
    if pad:
        msg = np.concatenate([msg, np.zeros((num, 1), dtype=np.uint8)], axis=1)
    return msg


def check_and_extract(msgs: np.ndarray, f: FramingConfig, num_oligos: int,
                      pad: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched CRC + index check of candidate messages.

    Args:
      msgs: uint8 [..., msg_len] candidate message bits.
    Returns:
      (ok, index): ok bool [...] true iff CRC matches and the descrambled
      index is < num_oligos; index int64 [...] (descrambled; valid where ok).

    Mirrors decode_list_CRC_index (helper.py:371-388): the bit string minus
    the pad bit is left-zero-padded to a whole number of bytes, CRC8 over all
    bytes but the last must equal the last byte.
    """
    msgs = np.asarray(msgs, dtype=np.uint8)
    if pad:
        msgs = msgs[..., :-1]
    nbits = msgs.shape[-1]
    total_bits = -(-nbits // 8) * 8
    lead = total_bits - nbits
    padded = np.concatenate(
        [np.zeros(msgs.shape[:-1] + (lead,), dtype=np.uint8), msgs], axis=-1)
    as_bytes = bits_to_bytes(padded)
    crc = crc8_batch(as_bytes[..., :-1])
    ok = crc == as_bytes[..., -1]
    scrambled = bits_to_int_msb(msgs[..., : f.index_len])
    index = prp_index_inverse(scrambled, f)
    ok = ok & (index < num_oligos)
    return ok, index


def extract_payload(msgs: np.ndarray, f: FramingConfig,
                    bytes_per_oligo: int, pad: bool = False) -> np.ndarray:
    """Payload bytes from message bits: bits [index_len, index_len+8*bpo)."""
    msgs = np.asarray(msgs, dtype=np.uint8)
    if pad:
        msgs = msgs[..., :-1]
    payload_bits = msgs[..., f.index_len: f.index_len + 8 * bytes_per_oligo]
    return bits_to_bytes(payload_bits)
