"""The port's ``utils/profiling.py`` against the JAX package's: the timing
registry's summary, the posterior trace dump (datasets equal byte for
byte), the read-length histogram, and the ``torch.profiler`` context
(a no-op without a directory, a trace file with one)."""
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.utils import profiling as jax_prof
from nanopore_dna_storage_tpu_torch.utils import profiling as port_prof


@pytest.fixture
def registries():
    """Both packages' registries empty before and after the test."""
    jax_prof.reset_timings()
    port_prof.reset_timings()
    yield
    jax_prof.reset_timings()
    port_prof.reset_timings()


def test_timing_registry(registries):
    for name in ("a", "b", "a"):
        with port_prof.timed(name):
            pass
    with pytest.raises(KeyError):
        with port_prof.timed("c"):
            raise KeyError("c")  # a section that raises is still timed
    got = port_prof.timing_summary()
    assert {k: v["n"] for k, v in got.items()} == {"a": 2, "b": 1, "c": 1}
    # the same readings give the JAX package's summary
    for name, secs in port_prof._TIMINGS.items():
        jax_prof._TIMINGS[name].extend(secs)
    assert got == jax_prof.timing_summary()
    port_prof.reset_timings()
    assert port_prof.timing_summary() == {}


def test_timed_synchronises_cuda_when_in_use(registries, monkeypatch):
    """With CUDA in use, ``timed`` waits for the device before each reading
    of the clock; without it, it never touches CUDA."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: calls.append(1))
    with port_prof.timed("cpu"):
        pass
    assert calls == [] or torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    calls.clear()
    with port_prof.timed("card"):
        assert len(calls) == 1
    assert len(calls) == 2


def test_dump_trace_hdf5_matches(tmp_path):
    pytest.importorskip("h5py")
    import h5py

    rng = np.random.default_rng(3)
    posts = {}
    for i, T in enumerate((7, 30)):
        x = rng.standard_normal((T, 5, 8)).astype(np.float32) * 3
        posts[f"read_{i}"] = x - np.log(np.exp(x).reshape(T, 40).sum(1))[
            :, None, None]
    port_prof.dump_trace_hdf5(str(tmp_path / "port.h5"), posts)
    jax_prof.dump_trace_hdf5(str(tmp_path / "jax.h5"), posts)
    with h5py.File(tmp_path / "port.h5") as got, \
            h5py.File(tmp_path / "jax.h5") as want:
        assert sorted(got) == sorted(want) == sorted(posts)
        for rid in want:
            assert got[rid].dtype == np.uint8 and got[rid].shape == (
                posts[rid].shape[0], 40)
            assert np.array_equal(got[rid][()], want[rid][()])


def test_read_length_histogram_matches(tmp_path):
    rng = np.random.default_rng(4)
    lines = []
    for i, n in enumerate((5, 12, 5, 0, 33, 12, 12)):
        seq = "".join("ACGT"[b] for b in rng.integers(0, 4, n))
        lines += [f"@r{i}", seq, "+", "5" * n]
    fq = tmp_path / "calls.fastq"
    fq.write_text("\n".join(lines) + "\n")
    got = port_prof.read_length_histogram(str(fq))
    assert got == jax_prof.read_length_histogram(str(fq))
    assert got == {5: 2, 12: 3, 0: 1, 33: 1}


def test_profile_without_a_directory_is_a_noop(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("profile(None) started the profiler")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    for logdir in (None, ""):
        with port_prof.profile(logdir):
            x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0


def test_profile_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with port_prof.profile(str(logdir)):
        torch.ones(64).cumsum(0)
    traces = list(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
