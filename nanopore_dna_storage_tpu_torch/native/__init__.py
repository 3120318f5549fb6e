"""ctypes bindings for the port's native host runtime (``ndsio.cpp``).

Counterpart of ``nanopore_dna_storage_tpu/native/__init__.py``, with the
same functions and results. The library is built from this directory's
``ndsio.cpp`` with the system ``g++`` at first use, into ``build/native/``
beside ``ops/_build.py``'s kernels (for an installed package, under
``~/.cache/nanopore_dna_storage_tpu_torch``), named by a hash of the source
and flags; no library is kept in the package. This is host code, so every
function falls back to the port's numpy version where the library cannot
be built; ``available()`` says which one runs.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
from typing import List, Optional, Tuple

import numpy as np

from ..ops._build import BUILD_DIR, compiled

SOURCE = pathlib.Path(__file__).resolve().parent / "ndsio.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
_lib: Optional[ctypes.CDLL] = None


def build() -> pathlib.Path:
    """Compile ``ndsio.cpp`` into ``build/native/libndsio-<hash>.so``
    unless it is there; raises RuntimeError if g++ is missing or fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    return compiled(cxx, CXX_FLAGS, [SOURCE], BUILD_DIR.parent / "native",
                    "libndsio")


def ensure_built(quiet: bool = True) -> bool:
    """Build and load the library if not loaded yet. Returns availability;
    with ``quiet=False`` a failed build raises instead."""
    global _lib
    if _lib is not None:
        return True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        if not quiet:
            raise
        return False
    c = ctypes
    lib.nds_load_posts_batch.argtypes = [
        c.POINTER(c.c_char_p), c.c_int, c.POINTER(c.c_float), c.c_longlong,
        c.POINTER(c.c_longlong), c.c_int]
    lib.nds_load_posts_batch.restype = c.c_int
    lib.nds_crc8_batch.argtypes = [c.POINTER(c.c_uint8), c.c_longlong,
                                   c.c_longlong, c.POINTER(c.c_uint8)]
    lib.nds_crc8_batch.restype = None
    lib.nds_levenshtein_windows.argtypes = [
        c.c_char_p, c.c_int, c.c_char_p, c.POINTER(c.c_int), c.c_int,
        c.c_int, c.POINTER(c.c_int)]
    lib.nds_levenshtein_windows.restype = None
    _lib = lib
    return True


def available() -> bool:
    """True when the native library runs, False when the numpy fallback
    does."""
    return ensure_built()


def load_posts_batch(paths: List[str], max_blocks: int,
                     nthreads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Read+pad .post files into [B, max_blocks, 5, 8] float32 + nblocks [B].

    Uses the native threaded loader when available, else numpy.
    """
    n = len(paths)
    if ensure_built():
        out = np.zeros((n, max_blocks, 40), dtype=np.float32)
        nblk = np.zeros(n, dtype=np.int64)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = _lib.nds_load_posts_batch(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_longlong(max_blocks),
            nblk.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            ctypes.c_int(nthreads))
        if rc != 0:
            raise IOError(f"failed reading {paths[rc - 1]}")
        return out.reshape(n, max_blocks, 5, 8), nblk
    from ..io.post import pack_posts, read_post

    posts = [read_post(p) for p in paths]
    return pack_posts(posts, pad_to=max_blocks, bucket=1)


def crc8_batch_native(rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if rows.ndim == 1:
        rows = rows[None]
    if ensure_built():
        out = np.zeros(rows.shape[0], dtype=np.uint8)
        _lib.nds_crc8_batch(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(rows.shape[0]),
            ctypes.c_longlong(rows.shape[1]),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
    from ..coding.crc import crc8_batch

    return crc8_batch(rows)


def levenshtein_windows_native(needle: str, haystack: str,
                               starts: np.ndarray, wlen: int) -> np.ndarray:
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    if ensure_built():
        out = np.zeros(len(starts), dtype=np.int32)
        _lib.nds_levenshtein_windows(
            needle.encode(), ctypes.c_int(len(needle)), haystack.encode(),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ctypes.c_int(len(starts)), ctypes.c_int(wlen),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out
    from ..signal.barcode import levenshtein_windows

    return levenshtein_windows(needle, haystack, starts, wlen)
