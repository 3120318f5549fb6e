"""``.post`` binary interchange (reference format: raw little-endian float32,
40 values = one 5x8 transition matrix per signal block; written by flappie.c:
267-272, read by viterbi_convolutional_code.cpp:553-575).

Also provides batched padding/packing of variable-length posts for the
decoder's fixed-shape device input.

The port's own copy of ``nanopore_dna_storage_tpu/io/post.py`` (numpy only,
unchanged), so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

BYTES_PER_BLK = 160  # 40 * sizeof(float) — helper.py:211-216


def read_post(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype="<f4")
    if raw.size % 40:
        raise ValueError(f"{path}: size not a multiple of 160 bytes/blk")
    return raw.reshape(-1, 5, 8)


def write_post(path: str, post: np.ndarray) -> None:
    post = np.asarray(post, dtype=np.float32)
    assert post.ndim == 3 and post.shape[1:] == (5, 8)
    post.astype("<f4").tofile(path)


def pack_posts(posts: Sequence[np.ndarray], pad_to: int | None = None,
               bucket: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of [T_i, 5, 8] posts to a common bucketed length.

    Returns (batch [B, T, 5, 8] float32 zero-padded, nblks [B] int64).
    Bucketing lengths to multiples of ``bucket`` keeps the jit cache small.
    """
    nblks = np.asarray([p.shape[0] for p in posts], dtype=np.int64)
    T = int(nblks.max()) if pad_to is None else pad_to
    T = -(-T // bucket) * bucket
    out = np.zeros((len(posts), T, 5, 8), dtype=np.float32)
    for i, p in enumerate(posts):
        out[i, : p.shape[0]] = p
    return out, nblks
