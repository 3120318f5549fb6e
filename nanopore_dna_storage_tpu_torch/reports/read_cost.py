"""The reading cost on the port: supplementary Table 2's methodology.

Encodes a file of random bytes (the published 11,280 bytes, supplementary
§5.1) at a published experiment and decodes a corpus of channel reads
(``corpus.py``; resumable from a state ``.npz`` of ``done``, ``read_idx``,
where -1 marks a read with no passing candidate, ``read_pay`` and
``wall``, the fields the repository's JAX report script writes). Then it
sweeps read counts in steps of ``step``, ``num_trials`` random draws a
count (decode_RS_from_decoded_lists.py:29-68 run over the sweep), and
reports the least count at which every trial recovers the file and the
reading cost in bases per bit, ``min_reads * oligo_len / (8 * file
size)``. ``--sweep-only`` sweeps the state's corpus without decoding.

    python -m nanopore_dna_storage_tpu_torch.reports.read_cost \\
        --experiment 7 --reads 2500 --step 500 --num-trials 10 --batch 16
"""
from __future__ import annotations

import argparse
import json
import pathlib
import random
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np

from ..config import ExperimentConfig
from ..pipeline.decode import majority_vote, recover_file
from ..pipeline.encode import encode_bytes
from ..pipeline.experiments import experiment
from . import corpus

PUBLISHED_BASES_PER_BIT_EXP7 = 7.01
CAVEAT = ("iid channel-simulator corpus: more decodable than the "
          "real MinION channel at matched basecall error "
          "(docs/SIGNAL_FIDELITY.json, README 'Simulator "
          "fidelity'); the sweep validates the Table-2 "
          "methodology and pipeline, not channel difficulty")


def sweep(read_idx: np.ndarray, read_pay: np.ndarray, exp: ExperimentConfig,
          data: bytes, *, step: int, num_trials: int, trial_seed: int,
          log: Callable[[str], None] = print) -> Tuple[list, Optional[int]]:
    """Table 2's sweep over a corpus: for each count ``step``, ``2 step``,
    ... up to the corpus, ``num_trials`` draws of that many reads from one
    ``random.Random(trial_seed)`` made anew for the count; the reads with
    no passing candidate are dropped, and a trial succeeds when the vote
    and RS recover ``data`` byte for byte. Returns (the sweep's entries,
    the first count at which every trial succeeds, or None)."""
    n_corpus = len(read_idx)
    entries, min_reads = [], None
    for n in range(step, n_corpus + 1, step):
        t0 = time.perf_counter()
        rnd = random.Random(trial_seed)
        succ = 0
        for _ in range(num_trials):
            pick = rnd.sample(range(n_corpus), n)
            sel = [p for p in pick if read_idx[p] >= 0]
            if not sel:
                continue
            voted = majority_vote(read_idx[sel], read_pay[sel])
            ok, rec = recover_file(voted, exp, len(data))
            if ok and rec == data:
                succ += 1
        entries.append({"num_reads": n, "successes": succ,
                        "trials": num_trials})
        log(f"sweep n={n}: {succ}/{num_trials} "
            f"({time.perf_counter() - t0:.1f}s)")
        if succ == num_trials and min_reads is None:
            min_reads = n
    return entries, min_reads


def run(exp: ExperimentConfig, file_size: int, *, experiment_id: int,
        reads: int, list_size: int = 8, batch: int = 1,
        max_deviation: Optional[int] = 20, seed: int = 5,
        sub: float = 0.004, dels: float = 0.0085, ins: float = 0.0005,
        step: int = 500, num_trials: int = 10, trial_seed: int = 99,
        state: Optional[str] = None, sweep_only: bool = False,
        device="cuda", log: Callable[[str], None] = print
        ) -> Tuple[dict, int]:
    """Decode ``reads`` channel reads of a ``file_size``-byte file drawn from
    ``seed`` at ``exp``, ``batch`` a chunk on ``device`` (resuming from and
    saving to ``state`` when given; none under ``sweep_only``), then sweep
    the corpus. Returns (the record, the forward block steps this run's
    decoders took)."""
    dev = corpus.resolve_device(device)
    data = np.random.default_rng(seed).integers(0, 256, file_size,
                                                np.uint8).tobytes()
    enc = encode_bytes(data, exp)
    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    log(f"encoded: {num_oligos} oligos, len {enc.oligo_len}")

    state_path = pathlib.Path(state) if state else None
    if state_path is not None and state_path.exists():
        with np.load(state_path) as st:
            done = int(st["done"])
            read_idx = st["read_idx"].tolist()
            read_pay = st["read_pay"].tolist()
            wall_acc = float(st["wall"])
        log(f"resuming at read {done}")
    else:
        done, read_idx, read_pay, wall_acc = 0, [], [], 0.0

    steps = 0
    if not sweep_only and done < reads:
        dec = corpus.CorpusDecoder(exp, list_size, max_deviation, dev)
        for chunk in dec.chunks(enc, start=done, reads=reads, batch=batch,
                                seed=seed, sub=sub, dels=dels, ins=ins):
            wall_acc += chunk.wall_s
            read_idx.extend(chunk.index.tolist())
            read_pay.extend(chunk.payload.tolist())
            done += len(chunk.ids)
            if state_path is not None:
                corpus.save_state(state_path, done=done,
                                  read_idx=np.asarray(read_idx, np.int64),
                                  read_pay=np.asarray(read_pay, np.uint8),
                                  wall=wall_acc)
            if done % (batch * 32) < batch or done >= reads:
                hits = int((np.asarray(read_idx) >= 0).sum())
                log(f"[{done}/{reads}] crc_pass={hits} "
                    f"({wall_acc / max(done, 1):.2f} s/read; "
                    f"{corpus.memory_note(dev)})")
        steps = dec.steps

    read_idx = np.asarray(read_idx, np.int64)
    read_pay = np.asarray(read_pay, np.uint8).reshape(-1,
                                                      exp.bytes_per_oligo)
    n_corpus = len(read_idx)
    log(f"corpus: {n_corpus} reads, {int((read_idx >= 0).sum())} "
        f"CRC-passing")
    entries, min_reads = sweep(read_idx, read_pay, exp, data, step=step,
                               num_trials=num_trials, trial_seed=trial_seed,
                               log=log)
    bases_per_bit = (min_reads * enc.oligo_len / (8 * file_size)
                     if min_reads else None)
    record = {
        "experiment": experiment_id,
        "config": corpus.config_text(exp, list_size, max_deviation),
        "device": corpus.device_name(dev),
        "file_size_bytes": file_size,
        "oligo_len": enc.oligo_len,
        "num_oligos": num_oligos,
        "corpus_reads": n_corpus,
        "corpus_crc_pass": int((read_idx >= 0).sum()),
        "step": step, "num_trials": num_trials,
        "sweep": entries,
        "min_reads_all_trials": min_reads,
        "reading_cost_bases_per_bit":
            round(bases_per_bit, 2) if bases_per_bit else None,
        "published_bases_per_bit_exp7": PUBLISHED_BASES_PER_BIT_EXP7,
        "decode_wall_s": round(wall_acc, 1),
        "s_per_read": round(wall_acc / max(n_corpus, 1), 2),
        "channel": {"sub": sub, "del": dels, "ins": ins},
        "caveat": CAVEAT,
    }
    return record, steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Table 2's reading cost from reads decoded on the port.")
    corpus.add_decode_args(ap, reads=4000, state="read_cost_state.npz",
                           out="READ_COST_H100.json")
    ap.add_argument("--step", type=int, default=500)
    ap.add_argument("--num-trials", type=int, default=10)
    ap.add_argument("--trial-seed", type=int, default=99)
    ap.add_argument("--sweep-only", action="store_true",
                    help="skip decoding; sweep whatever the state file "
                         "already holds")
    args = ap.parse_args(argv)
    record, _ = run(
        experiment(args.experiment), corpus.FILE_SIZE,
        experiment_id=args.experiment, reads=args.reads,
        list_size=args.list_size, batch=args.batch,
        max_deviation=args.max_deviation, seed=args.seed, sub=args.sub,
        dels=args.dels, ins=args.ins, step=args.step,
        num_trials=args.num_trials, trial_seed=args.trial_seed,
        state=args.state, sweep_only=args.sweep_only, device=args.device,
        log=lambda s: print(s, flush=True))
    pathlib.Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
