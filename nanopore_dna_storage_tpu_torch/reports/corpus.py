"""The decode-and-classify loop of the two decode reports (``file_recovery``,
``read_cost``), and what they share besides.

Reads are drawn a chunk at a time, each chunk from its own
``np.random.default_rng((seed, first read of the chunk))``, so a run that
resumes at a chunk boundary draws the reads an uninterrupted run draws.
Each chunk's posteriors are packed once, then the forward reads and the
reverse-complement reads go through their own ``ShardedDecoder``; a read's
result is its first CRC/index-passing candidate, and a read with none is an
erasure. The chunk's wall clock runs from after the reads are simulated to
the end of its payload extraction.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import resource
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..coding.framing import extract_payload
from ..config import ExperimentConfig
from ..io.post import pack_posts
from ..parallel.mesh import ShardedDecoder
from ..pipeline.encode import EncodeResult
from ..pipeline.simulate import simulate_posts

REPO = pathlib.Path(__file__).resolve().parents[2]
# the published file's size in bytes (supplementary §5.1)
FILE_SIZE = 11280
# where a report keeps its resumable state unless told otherwise
STATE_DIR = REPO / "build" / "reports"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for ``cuda`` without CUDA:
    nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    return dev


def device_name(device) -> str:
    """What a record names as its device: the card's name, or ``cpu``."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def memory_note(device) -> str:
    """The card's allocated, reserved and peak memory and the host's peak
    resident set, for progress lines: a leak shows as growth over chunks."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"host peak rss {rss:.2f} GiB"
    return (f"cuda allocated {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
            f"reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f} "
            f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
            f"host peak rss {rss:.2f} GiB")


def add_decode_args(ap: argparse.ArgumentParser, reads: int, state: str,
                    out: str) -> None:
    """The flags both decode reports take, with the scripts' defaults."""
    ap.add_argument("--experiment", type=int, default=7,
                    help="7 = m=11 r=5/6 fec=169 (564/169/733 oligos)")
    ap.add_argument("--reads", type=int, default=reads)
    ap.add_argument("--list-size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1,
                    help="reads per decode step (per orientation); each "
                         "read's selections take ~2.1 GB of the card at "
                         "experiment 7")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode (cuda unless cpu is "
                         "asked for)")
    ap.add_argument("--max-deviation", type=int, default=20)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--sub", type=float, default=0.004)
    ap.add_argument("--del", dest="dels", type=float, default=0.0085)
    ap.add_argument("--ins", type=float, default=0.0005)
    ap.add_argument("--state", default=str(STATE_DIR / state))
    ap.add_argument("--out", default=str(REPO / "docs" / out))


def config_text(exp: ExperimentConfig, list_size: int,
                max_deviation: Optional[int]) -> str:
    return (f"m={exp.conv_mem} r_index={exp.conv_rate} "
            f"L={list_size} max_dev={max_deviation}")


def save_state(path: pathlib.Path, **arrays) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


@dataclasses.dataclass
class Chunk:
    """One chunk of reads, decoded and classified."""

    rcs: np.ndarray  # [n] bool: reverse complement
    ids: np.ndarray  # [n] the oligo each read was drawn from
    index: np.ndarray  # [n] int64: the first passing candidate's, -1 if none
    payload: np.ndarray  # [n, bytes_per_oligo] uint8, zeros where index -1
    wall_s: float

    @property
    def order(self) -> np.ndarray:
        """The reads in decode order: forward ones, then reverse ones."""
        return np.concatenate([np.nonzero(~self.rcs)[0],
                               np.nonzero(self.rcs)[0]])


class CorpusDecoder:
    """The forward and reverse-complement ``ShardedDecoder`` of one
    experiment on one device."""

    def __init__(self, exp: ExperimentConfig, list_size: int,
                 max_deviation: Optional[int], device):
        self.exp = exp
        self.decoders = {rc: ShardedDecoder(exp, list_size, rc,
                                            max_deviation=max_deviation,
                                            device=device)
                         for rc in (False, True)}

    @property
    def steps(self) -> int:
        """Forward block steps both decoders have run."""
        return sum(d.inner.steps for d in self.decoders.values())

    def chunks(self, enc: EncodeResult, *, start: int, reads: int,
               batch: int, seed: int, sub: float, dels: float,
               ins: float) -> Iterator[Chunk]:
        """Reads ``start`` to ``reads`` in chunks of ``batch``."""
        exp = self.exp
        num_oligos = enc.num_oligos_data + enc.num_oligos_rs
        done = start
        while done < reads:
            n = min(batch, reads - done)
            crng = np.random.default_rng((seed, done))
            posts, rcs, ids = simulate_posts(enc.oligos, n, crng,
                                             sub_prob=sub, del_prob=dels,
                                             ins_prob=ins)
            t0 = time.perf_counter()
            packed, nblks = pack_posts(posts)
            index = np.full(n, -1, np.int64)
            payload = np.zeros((n, exp.bytes_per_oligo), np.uint8)
            for rc in (False, True):
                sel = np.nonzero(rcs == rc)[0]
                if not len(sel):
                    continue
                res = self.decoders[rc].decode(packed[sel], nblks[sel],
                                               num_oligos)
                first = np.argmax(res.ok, axis=1)
                for j, r in enumerate(sel):
                    if not res.ok[j].any():
                        continue
                    index[r] = int(res.index[j, first[j]])
                    payload[r] = extract_payload(
                        res.msgs[j, first[j]][None], exp.framing,
                        exp.bytes_per_oligo, pad=exp.pad)[0]
            yield Chunk(rcs, ids, index, payload, time.perf_counter() - t0)
            done += n
