"""Data preparation utilities (the reference's util/ scripts, hermetic).

* build_raw_signal_archive: SAM + fast5 directory -> per-experiment HDF5
  {read_id: raw_signal, attrs[ref]} (util/extract_data_fast5.py:19-48).
  The SAM parser is a minimal text-format reader (no pysam dependency):
  mapped primary alignments only, reference name recorded per read.
* sample_read_ids: random read-id subset (util/generate_read_id_file.py).
* shard_read_ids: N-way split for parallel jobs
  (util/extra/generate_read_id_files.py).
* basecall_accuracy: per-read edit distance of basecalls vs references —
  the hermetic stand-in for the minimap2/samtools stats pipeline
  (util/align_compute_stats.sh).

The port's own copy of ``nanopore_dna_storage_tpu/pipeline/data_prep.py``
(numpy only, unchanged), so that the port imports nothing of the JAX
package; ``h5py`` is imported where a function reads or writes HDF5
(``io/fast5.py``).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..io import fast5 as fast5_io
from ..signal.barcode import levenshtein


def parse_sam_mappings(sam_path: str) -> Dict[str, str]:
    """read_id -> reference name for mapped primary alignments."""
    out: Dict[str, str] = {}
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 4:
                continue
            qname, flag, rname = fields[0], int(fields[1]), fields[2]
            if rname == "*" or (flag & 0x4) or (flag & 0x100) or (flag & 0x800):
                continue
            out.setdefault(qname, rname)
    return out


def build_raw_signal_archive(fast5_dir: str, out_path: str,
                             sam_path: Optional[str] = None,
                             limit: Optional[int] = None) -> int:
    """Collect raw signals from single-read fast5 files into one archive."""
    mappings = parse_sam_mappings(sam_path) if sam_path else {}
    signals: Dict[str, np.ndarray] = {}
    refs: Dict[str, str] = {}
    files = sorted(glob.glob(os.path.join(fast5_dir, "*.fast5")))
    for path in files:
        if limit and len(signals) >= limit:
            break
        try:
            import h5py

            with h5py.File(path, "r") as f:
                reads = f["Raw/Reads"]
                key = next(iter(reads.keys()))
                rid = reads[key].attrs.get("read_id", os.path.basename(path))
                if isinstance(rid, bytes):
                    rid = rid.decode()
            if sam_path and rid not in mappings:
                continue
            raw = fast5_io.read_fast5_raw(path)
        except (OSError, KeyError):
            continue
        signals[rid] = raw
        if rid in mappings:
            refs[rid] = mappings[rid]
    fast5_io.write_raw_signals(out_path, signals, refs)
    return len(signals)


def sample_read_ids(archive_path: str, num: int, seed: int = 0) -> List[str]:
    import h5py

    with h5py.File(archive_path, "r") as f:
        ids = list(f.keys())
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(ids), size=min(num, len(ids)), replace=False)
    return [ids[i] for i in sorted(sel)]


def shard_read_ids(read_ids: Sequence[str], num_shards: int
                   ) -> List[List[str]]:
    return [list(read_ids[i::num_shards]) for i in range(num_shards)]


def align_counts(call: str, ref: str) -> Dict[str, int]:
    """Global alignment error breakdown: substitutions / insertions /
    deletions (relative to ref) from a Levenshtein traceback.

    The reference computes these with minimap2 + samtools stats
    (util/align_compute_stats.sh:22-52); a full DP alignment gives the same
    per-category counts for the short storage oligos without the external
    toolchain. Ties prefer diagonal (match/sub), then deletion.
    """
    n, m = len(call), len(ref)
    D = np.zeros((n + 1, m + 1), np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    a = np.frombuffer(call.encode(), np.uint8)
    b = np.frombuffer(ref.encode(), np.uint8)
    for i in range(1, n + 1):
        # vectorized row update: D[i, j] depends on D[i, j-1] (prefix scan)
        sub = D[i - 1, :-1] + (a[i - 1] != b)
        dele = D[i - 1, 1:] + 1
        best = np.minimum(sub, dele)
        run = D[i, 0]
        row = np.empty(m, np.int32)
        for j in range(m):  # insertion chain is inherently sequential
            run = min(best[j], run + 1)
            row[j] = run
        D[i, 1:] = row
    i, j = n, m
    subs = ins = dels = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] + \
                (a[i - 1] != b[j - 1]):
            subs += int(a[i - 1] != b[j - 1])
            i -= 1
            j -= 1
        elif j > 0 and D[i, j] == D[i, j - 1] + 1:
            dels += 1  # ref base missing from the call
            j -= 1
        else:
            ins += 1  # extra called base
            i -= 1
    return {"sub": subs, "ins": ins, "del": dels}


def basecall_accuracy(calls: Dict[str, str], refs: Dict[str, str]
                      ) -> Dict[str, float]:
    """Aggregate basecall error stats vs reference sequences, including the
    per-category sub/ins/del rates of util/align_compute_stats.sh."""
    dists, lens = [], []
    cat = {"sub": 0, "ins": 0, "del": 0}
    unaligned = 0
    for rid, call in calls.items():
        ref = refs.get(rid)
        if not ref:
            unaligned += 1
            continue
        counts = align_counts(call, ref)
        for k in cat:
            cat[k] += counts[k]
        dists.append(counts["sub"] + counts["ins"] + counts["del"])
        lens.append(len(ref))
    total = sum(lens)
    return {
        "reads": len(calls),
        "compared": len(dists),
        "unaligned": unaligned,
        "mean_edit_distance": float(np.mean(dists)) if dists else float("nan"),
        "error_rate": (sum(dists) / total) if total else float("nan"),
        "sub_rate": (cat["sub"] / total) if total else float("nan"),
        "ins_rate": (cat["ins"] / total) if total else float("nan"),
        "del_rate": (cat["del"] / total) if total else float("nan"),
    }
