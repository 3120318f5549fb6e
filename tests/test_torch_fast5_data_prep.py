"""The port's fast5 IO (``io/fast5.py``) and data preparation
(``pipeline/data_prep.py``) against the JAX package's.

A file written by one package is read by the other: signals and read ids
must be bit-equal (the digitisation is the same numpy on the same input).
The archive round trip, SAM parsing, sampling and sharding, ``align_counts``
and ``basecall_accuracy`` must give equal results on seeded inputs. Needs
``h5py``; without it this file alone skips.
"""
import numpy as np
import pytest

pytest.importorskip("h5py")

from nanopore_dna_storage_tpu.io import fast5 as jax_fast5  # noqa: E402
from nanopore_dna_storage_tpu.pipeline import \
    data_prep as jax_prep  # noqa: E402
from nanopore_dna_storage_tpu_torch.io import fast5 as port_fast5  # noqa: E402
from nanopore_dna_storage_tpu_torch.pipeline import \
    data_prep as port_prep  # noqa: E402

PACKAGES = {"jax": (jax_fast5, jax_prep), "port": (port_fast5, port_prep)}


def _signals(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(500, 40, 700 + 37 * i).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fast5_cross_read(tmp_path, writer):
    w = PACKAGES[writer][0]
    raws = _signals()
    for i, raw in enumerate(raws):
        w.write_fast5(str(tmp_path / f"r{i}.fast5"), raw, read_number=i + 1)
    for i, raw in enumerate(raws):
        path = str(tmp_path / f"r{i}.fast5")
        got = port_fast5.read_fast5_raw(path)
        want = jax_fast5.read_fast5_raw(path)
        assert got.dtype == want.dtype and got.shape == raw.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.corrcoef(got, raw)[0, 1] > 0.999


def test_fast5_digitisation_is_the_same(tmp_path):
    """Each package's file of the same signal: the same int16 samples and
    channel attributes (the read and run ids are random uuids)."""
    import h5py

    raw = _signals(1, seed=3)[0]
    for name, (f5, _) in PACKAGES.items():
        f5.write_fast5(str(tmp_path / f"{name}.fast5"), raw)
    files = {name: h5py.File(tmp_path / f"{name}.fast5", "r")
             for name in PACKAGES}
    try:
        sig = {n: f["Raw/Reads/Read_1/Signal"][()] for n, f in files.items()}
        assert sig["port"].dtype == sig["jax"].dtype == np.int16
        assert np.array_equal(sig["port"], sig["jax"])
        ch = {n: dict(f["UniqueGlobalKey/channel_id"].attrs)
              for n, f in files.items()}
        assert ch["port"] == ch["jax"]
    finally:
        for f in files.values():
            f.close()


def test_archive_round_trip_matches_jax(tmp_path):
    raws = _signals(5, seed=1)
    for i, raw in enumerate(raws):
        jax_fast5.write_fast5(str(tmp_path / f"r{i}.fast5"), raw)
    (tmp_path / "broken.fast5").write_bytes(b"not hdf5")
    sam = tmp_path / "a.sam"
    ids = [_read_id(tmp_path / f"r{i}.fast5") for i in range(5)]
    sam.write_text(
        "@HD\tVN:1.6\n"
        + f"{ids[0]}\t0\toligo_5\t1\t60\t4M\t*\t0\t0\tACGT\t*\n"
        + f"{ids[1]}\t16\toligo_2\t1\t60\t4M\t*\t0\t0\tACGT\t*\n"
        + f"{ids[2]}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n"
        + f"{ids[3]}\t0\toligo_7\t1\t60\t4M\t*\t0\t0\tACGT\t*\n")
    out = {}
    for name, (f5, prep) in PACKAGES.items():
        arch = tmp_path / f"{name}.h5"
        whole = tmp_path / f"{name}_all.h5"
        n_all = prep.build_raw_signal_archive(str(tmp_path), str(whole))
        n = prep.build_raw_signal_archive(str(tmp_path), str(arch),
                                          sam_path=str(sam))
        n_lim = prep.build_raw_signal_archive(
            str(tmp_path), str(tmp_path / f"{name}_lim.h5"), limit=2)
        # each package reads the other's archive
        other = PACKAGES["port" if name == "jax" else "jax"][0]
        read = list(other.iter_raw_signals(str(arch)))
        sample = prep.sample_read_ids(str(whole), 3, seed=4)
        out[name] = (n_all, n, n_lim, [(r, s.tobytes(), ref)
                                       for r, s, ref in read],
                     sample, prep.shard_read_ids(sample, 2))
    assert out["port"] == out["jax"]
    n_all, n, n_lim, read, sample, shards = out["port"]
    assert (n_all, n, n_lim) == (5, 3, 2)
    assert sorted(r for r, _, _ in read) == sorted(ids[i] for i in (0, 1, 3))
    assert {ref for _, _, ref in read} == {"oligo_5", "oligo_2", "oligo_7"}
    assert len(sample) == 3 and sorted(sum(shards, [])) == sorted(sample)


def _read_id(path) -> str:
    import h5py

    with h5py.File(path, "r") as f:
        return f["Raw/Reads/Read_1"].attrs["read_id"]


def test_sam_parsing_matches_jax(tmp_path):
    sam = tmp_path / "a.sam"
    sam.write_text(
        "@HD\tVN:1.6\n@SQ\tSN:oligo_5\tLN:10\n"
        "read1\t0\toligo_5\t1\t60\t10M\t*\t0\t0\tACGTACGTAC\t*\n"
        "read2\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n"
        "read3\t256\toligo_2\t1\t0\t4M\t*\t0\t0\tACGT\t*\n"
        "read4\t2048\toligo_1\t1\t0\t4M\t*\t0\t0\tACGT\t*\n"
        "read5\t16\toligo_9\t1\t60\t4M\t*\t0\t0\tACGT\t*\n"
        "read5\t0\toligo_3\t1\t60\t4M\t*\t0\t0\tACGT\t*\n"
        "short\t0\n"
        "read6\t0\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n")
    got = port_prep.parse_sam_mappings(str(sam))
    assert got == jax_prep.parse_sam_mappings(str(sam))
    assert got == {"read1": "oligo_5", "read5": "oligo_9"}


@pytest.mark.parametrize("seed", range(3))
def test_align_counts_and_accuracy_match_jax(seed):
    rng = np.random.default_rng(seed)
    calls, refs = {}, {}
    for i in range(12):
        ref = "".join(rng.choice(list("ACGT"), rng.integers(0, 40)))
        call = list(ref)
        for _ in range(rng.integers(0, 6)):
            j = int(rng.integers(0, len(call) + 1))
            op = rng.integers(3)
            if op == 0 and j < len(call):
                call[j] = "ACGT"[rng.integers(4)]
            elif op == 1:
                call.insert(j, "ACGT"[rng.integers(4)])
            elif call:
                del call[min(j, len(call) - 1)]
        calls[f"r{i}"] = "".join(call)
        if i % 5:
            refs[f"r{i}"] = ref
    for rid, call in calls.items():
        ref = refs.get(rid, "")
        assert port_prep.align_counts(call, ref) == \
            jax_prep.align_counts(call, ref)
    got = port_prep.basecall_accuracy(calls, refs)
    want = jax_prep.basecall_accuracy(calls, refs)
    assert got == want
    assert got["compared"] == 9 and got["unaligned"] == 3
    # no read aligned: the rates are NaN in both
    got = port_prep.basecall_accuracy({"a": "AC"}, {})
    want = jax_prep.basecall_accuracy({"a": "AC"}, {})
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v == want[k] or (np.isnan(v) and np.isnan(want[k])), k
