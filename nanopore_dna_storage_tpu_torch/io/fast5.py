"""Raw-signal HDF5 IO.

Two formats from the reference pipeline:

* the per-experiment raw-signal archive ``{read_id: raw_signal}`` with an
  oligo-reference attribute, produced by util/extract_data_fast5.py:19-48 and
  consumed by generate_decoded_lists.py:48-56;
* single-read fast5 files (digitized int16 + channel metadata) as written by
  helper.create_fast5 (helper.py:85-121) and read by flappie's
  fast5_interface.c:209-318 (signal scaled by range/digitisation + offset).

h5py only; no fast5_research dependency.

The port's own copy of ``nanopore_dna_storage_tpu/io/fast5.py`` (numpy only),
so that the port imports nothing of the JAX package. One change: ``h5py`` is
imported inside each function, not with the module, so that the modules
that import this one (``pipeline/real_data.py``, the CLI) import where
h5py is not installed; only the fast5 functions themselves need it.
"""
from __future__ import annotations

import uuid
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# raw_signal_<exp>.hdf5 archives
# ---------------------------------------------------------------------------

def iter_raw_signals(path: str, read_ids=None
                     ) -> Iterator[Tuple[str, np.ndarray, Optional[str]]]:
    """Yield (read_id, raw_signal float32, ref_or_None) from an archive."""
    import h5py

    with h5py.File(path, "r") as f:
        ids = read_ids if read_ids is not None else list(f.keys())
        for rid in ids:
            ds = f[rid]
            ref = ds.attrs.get("ref")
            if isinstance(ref, bytes):
                ref = ref.decode()
            yield rid, np.asarray(ds[()], dtype=np.float32), ref


def write_raw_signals(path: str, signals: Dict[str, np.ndarray],
                      refs: Optional[Dict[str, str]] = None) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for rid, sig in signals.items():
            ds = f.create_dataset(rid, data=np.asarray(sig))
            if refs and rid in refs:
                ds.attrs["ref"] = refs[rid]


# ---------------------------------------------------------------------------
# single-read fast5
# ---------------------------------------------------------------------------

def write_fast5(path: str, raw: np.ndarray, read_number: int = 1) -> None:
    """Digitize and write a single-read fast5 (helper.py:85-121 semantics:
    uniform binning to int16 with digitisation 8192)."""
    import h5py

    raw = np.asarray(raw, dtype=np.float64)
    start, stop = int(raw.min() - 1), int(raw.max() + 1)
    rng = stop - start
    digitisation = 8192.0
    bins = np.arange(start, stop, rng / digitisation)
    binned = np.digitize(raw, bins).astype(np.int16)
    read_id = str(uuid.uuid4())
    with h5py.File(path, "w") as f:
        f.attrs["file_version"] = 2.0
        grp = f.create_group(f"Raw/Reads/Read_{read_number}")
        grp.attrs["read_id"] = read_id
        grp.attrs["read_number"] = read_number
        grp.attrs["start_time"] = 0
        grp.attrs["duration"] = len(raw)
        grp.attrs["start_mux"] = 1
        grp.create_dataset("Signal", data=binned, dtype="<i2")
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = digitisation
        ch.attrs["offset"] = 0.0
        ch.attrs["range"] = float(rng)
        ch.attrs["sampling_rate"] = 4000.0
        ch.attrs["channel_number"] = "1"
        trk = f.create_group("UniqueGlobalKey/tracking_id")
        trk.attrs["exp_start_time"] = "1970-01-01T00:00:00Z"
        trk.attrs["run_id"] = uuid.uuid4().hex
        trk.attrs["flow_cell_id"] = "FAH00000"


def read_fast5_raw(path: str) -> np.ndarray:
    """Raw signal in pA-equivalent units: (signal + offset) * range /
    digitisation (fast5_interface.c:282-300)."""
    import h5py

    with h5py.File(path, "r") as f:
        reads = f["Raw/Reads"]
        key = next(iter(reads.keys()))
        sig = np.asarray(reads[key]["Signal"][()], dtype=np.float32)
        ch = f["UniqueGlobalKey/channel_id"]
        rng = float(ch.attrs["range"])
        digitisation = float(ch.attrs["digitisation"])
        offset = float(ch.attrs["offset"])
    return (sig + offset) * rng / digitisation
