"""The port's native host runtime (``native/``, ``ndsio.cpp`` built with
g++) against the port's numpy versions and the JAX package's functions.

Every function is integer or byte work (CRC8, edit distances, a padded
copy of ``.post`` files), so the results must be equal exactly. The tests
that build the library skip where ``g++`` is missing.
"""
import pathlib
import shutil

import numpy as np
import pytest

from nanopore_dna_storage_tpu import native as jax_native
from nanopore_dna_storage_tpu.coding.crc import crc8_batch as jax_crc8_batch
from nanopore_dna_storage_tpu.signal.barcode import \
    levenshtein_windows as jax_levenshtein_windows
from nanopore_dna_storage_tpu_torch import native
from nanopore_dna_storage_tpu_torch.coding.crc import crc8_batch
from nanopore_dna_storage_tpu_torch.io.post import pack_posts, write_post
from nanopore_dna_storage_tpu_torch.signal.barcode import levenshtein_windows

PACKAGE = pathlib.Path(native.__file__).resolve().parent


@pytest.fixture
def built():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native library cannot be built")
    assert native.ensure_built(quiet=False)
    return native


@pytest.fixture
def fallback(monkeypatch):
    """The port's native module with its library unavailable."""
    monkeypatch.setattr(native, "ensure_built", lambda quiet=True: False)
    return native


def test_library_is_built_outside_the_package(built):
    path = built.build()
    assert path.is_file() and path.parent.name == "native"
    assert PACKAGE not in path.parents
    assert not list(PACKAGE.glob("*.so"))
    assert built.available() and built.build() == path


@pytest.mark.parametrize("shape", [(50, 23), (1, 9), (7, 1), (3, 0)])
def test_crc8_matches_numpy_and_jax(built, rows_of, shape):
    rows = rows_of(shape)
    got = built.crc8_batch_native(rows)
    assert got.dtype == np.uint8
    assert np.array_equal(got, crc8_batch(rows))
    assert np.array_equal(got, jax_crc8_batch(rows))
    assert np.array_equal(got, jax_native.crc8_batch_native(rows))
    one = np.frombuffer(b"123456789", np.uint8)
    assert built.crc8_batch_native(one)[0] == 0xF4


@pytest.fixture
def rows_of():
    def make(shape):
        return np.random.default_rng(shape[0] * 31 + shape[1]).integers(
            0, 256, shape, dtype=np.uint8)
    return make


@pytest.mark.parametrize("needle_len,wlen", [(10, 10), (25, 25), (6, 9),
                                             (12, 4)])
def test_levenshtein_windows_match_numpy_and_jax(built, needle_len, wlen):
    rng = np.random.default_rng(needle_len * 7 + wlen)
    hay = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    needle = "".join("ACGT"[i] for i in rng.integers(0, 4, needle_len))
    starts = np.concatenate([np.arange(0, 300 - wlen, 3), [300 - wlen]])
    got = built.levenshtein_windows_native(needle, hay, starts, wlen)
    want = levenshtein_windows(needle, hay, starts, wlen)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_levenshtein_windows(needle, hay, starts,
                                                       wlen))
    assert np.array_equal(got, jax_native.levenshtein_windows_native(
        needle, hay, starts, wlen))


def _post_files(tmp_path, n=5):
    rng = np.random.default_rng(2)
    posts, paths = [], []
    for i in range(n):
        p = rng.standard_normal((10 + 3 * i, 5, 8)).astype(np.float32)
        path = tmp_path / f"{i}.post"
        write_post(str(path), p)
        posts.append(p)
        paths.append(str(path))
    return posts, paths


def test_post_batch_loader_matches_numpy_and_jax(built, tmp_path):
    posts, paths = _post_files(tmp_path)
    batch, nblk = built.load_posts_batch(paths, max_blocks=24, nthreads=3)
    assert batch.shape == (5, 24, 5, 8) and batch.dtype == np.float32
    want, want_n = pack_posts(posts, pad_to=24, bucket=1)
    assert np.array_equal(batch.view(np.uint32), want.view(np.uint32))
    assert nblk.dtype == want_n.dtype and np.array_equal(nblk, want_n)
    jb, jn = jax_native.load_posts_batch(paths, max_blocks=24)
    assert np.array_equal(batch.view(np.uint32), jb.view(np.uint32))
    assert np.array_equal(nblk, jn)


def test_post_batch_loader_reports_the_bad_file(built, tmp_path):
    _, paths = _post_files(tmp_path, 3)
    (tmp_path / "odd.post").write_bytes(b"\0" * 100)  # not 160-byte blocks
    with pytest.raises(IOError, match="odd.post"):
        built.load_posts_batch(paths + [str(tmp_path / "odd.post")], 24)
    with pytest.raises(IOError, match="missing.post"):
        built.load_posts_batch([str(tmp_path / "missing.post")], 24)
    with pytest.raises(IOError, match="2.post"):  # 16 blocks > 12
        built.load_posts_batch(paths[:1] + paths[2:], 12)


def test_fallback_gives_the_same_results(fallback, tmp_path):
    assert not fallback.available()
    rows = np.random.default_rng(5).integers(0, 256, (9, 23), dtype=np.uint8)
    assert np.array_equal(fallback.crc8_batch_native(rows), crc8_batch(rows))
    hay = "ACGTTGCA" * 20
    starts = np.arange(0, 150)
    assert np.array_equal(
        fallback.levenshtein_windows_native("GTTGCAAC", hay, starts, 8),
        levenshtein_windows("GTTGCAAC", hay, starts, 8))
    posts, paths = _post_files(tmp_path)
    batch, nblk = fallback.load_posts_batch(paths, max_blocks=24)
    want, want_n = pack_posts(posts, pad_to=24, bucket=1)
    assert np.array_equal(batch, want) and np.array_equal(nblk, want_n)
