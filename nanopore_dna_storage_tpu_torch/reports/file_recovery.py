"""Paper-scale end-to-end file recovery on the port.

Encodes a file of random bytes (the published 11,280 bytes, supplementary
§5.1) at a published experiment, simulates channel reads, decodes them
through ``ShardedDecoder`` (``corpus.py``), keeps each read's first
CRC/index-passing candidate, votes per index, recovers the file with
Reed-Solomon and compares the bytes: decode_RS_from_decoded_lists.py:7-64's
acceptance flow in one run. A read counts as correct when both its index
and its payload are the oligo's own.

Progress is saved after every chunk to a state ``.npz`` (``done``, ``idx``,
``pay``, ``wall`` and the three counters), so a stopped run resumes where
it stopped; the repository's JAX report script writes the same fields, and
either resumes the other's state. A run whose bytes do not match exits
non-zero.

    python -m nanopore_dna_storage_tpu_torch.reports.file_recovery \\
        --experiment 7 --reads 1542 --batch 16 [--state S] [--out O]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np

from ..config import ExperimentConfig
from ..pipeline.decode import majority_vote, recover_file
from ..pipeline.encode import encode_bytes
from ..pipeline.experiments import experiment
from . import corpus

COUNTERS = ("num_correct", "num_erasure_CRC", "num_error_CRC")


def run(exp: ExperimentConfig, file_size: int, *, experiment_id: int,
        reads: int, list_size: int = 8, batch: int = 1,
        max_deviation: Optional[int] = 20, seed: int = 5,
        sub: float = 0.004, dels: float = 0.0085, ins: float = 0.0005,
        state: Optional[str] = None, device="cuda",
        log: Callable[[str], None] = print) -> Tuple[dict, int]:
    """Recover a ``file_size``-byte file drawn from ``seed`` at ``exp`` from
    ``reads`` channel reads decoded ``batch`` a chunk on ``device``, resuming
    from and saving to ``state`` when given. Returns (the record, the
    forward block steps this run's decoders took)."""
    dev = corpus.resolve_device(device)
    data = np.random.default_rng(seed).integers(0, 256, file_size,
                                                np.uint8).tobytes()
    t_enc0 = time.perf_counter()
    enc = encode_bytes(data, exp)
    t_enc = time.perf_counter() - t_enc0
    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    log(f"encoded: {enc.num_oligos_data}/{enc.num_oligos_rs}/{num_oligos} "
        f"oligos, len {enc.oligo_len}, {t_enc:.1f}s")
    dec = corpus.CorpusDecoder(exp, list_size, max_deviation, dev)

    state_path = pathlib.Path(state) if state else None
    if state_path is not None and state_path.exists():
        with np.load(state_path) as st:
            done = int(st["done"])
            idx_acc = st["idx"].tolist()
            pay_acc = st["pay"].tolist()
            counters = {k: int(st[k]) for k in COUNTERS}
            wall_acc = float(st["wall"])
        log(f"resuming at read {done}")
    else:
        done, idx_acc, pay_acc, wall_acc = 0, [], [], 0.0
        counters = dict.fromkeys(COUNTERS, 0)

    for chunk in dec.chunks(enc, start=done, reads=reads, batch=batch,
                            seed=seed, sub=sub, dels=dels, ins=ins):
        for r in chunk.order:
            if chunk.index[r] < 0:
                counters["num_erasure_CRC"] += 1
                continue
            midx = int(chunk.index[r])
            pay = chunk.payload[r]
            idx_acc.append(midx)
            pay_acc.append(pay)
            if midx == int(chunk.ids[r]) and (
                    pay == enc.payloads[chunk.ids[r]]).all():
                counters["num_correct"] += 1
            else:
                counters["num_error_CRC"] += 1
        wall_acc += chunk.wall_s
        done += len(chunk.ids)
        if state_path is not None:
            corpus.save_state(state_path, done=done,
                              idx=np.asarray(idx_acc, np.int64),
                              pay=np.asarray(pay_acc, np.uint8),
                              wall=wall_acc, **counters)
        if done % (batch * 16) < batch or done >= reads:
            log(f"[{done}/{reads}] correct={counters['num_correct']} "
                f"erasure={counters['num_erasure_CRC']} "
                f"error={counters['num_error_CRC']} "
                f"unique_idx={len(set(idx_acc))} "
                f"({wall_acc / max(done, 1):.2f} s/read; "
                f"{corpus.memory_note(dev)})")

    voted = majority_vote(np.asarray(idx_acc),
                          np.asarray(pay_acc, np.uint8))
    t0 = time.perf_counter()
    ok, recovered = recover_file(voted, exp, file_size)
    t_rs = time.perf_counter() - t0
    record = {
        "experiment": experiment_id,
        "config": corpus.config_text(exp, list_size, max_deviation),
        "device": corpus.device_name(dev),
        "file_size_bytes": file_size,
        "oligos": {"data": enc.num_oligos_data, "rs": enc.num_oligos_rs,
                   "total": num_oligos},
        "reads_used": done,
        **counters,
        "unique_indices_voted": len(voted),
        "missing_indices_erased": num_oligos - len(voted),
        "rs_decode_ok": bool(ok),
        "file_bytes_match": recovered == data,
        "decode_wall_s": round(wall_acc, 1),
        "s_per_read": round(wall_acc / max(done, 1), 2),
        "rs_recover_s": round(t_rs, 1),
        "channel": {"sub": sub, "del": dels, "ins": ins},
    }
    return record, dec.steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Recover the published file from simulated reads "
                    "decoded on the port.")
    corpus.add_decode_args(ap, reads=2200, state="file_recovery_state.npz",
                           out="FILE_RECOVERY_H100.json")
    args = ap.parse_args(argv)
    record, _ = run(
        experiment(args.experiment), corpus.FILE_SIZE,
        experiment_id=args.experiment, reads=args.reads,
        list_size=args.list_size, batch=args.batch,
        max_deviation=args.max_deviation, seed=args.seed, sub=args.sub,
        dels=args.dels, ins=args.ins, state=args.state, device=args.device,
        log=lambda s: print(s, flush=True))
    pathlib.Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record), flush=True)
    if not record["file_bytes_match"]:
        print("file recovery FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
