"""Signal-fidelity decode accuracy at a published experiment, on the port.

Trains the kmer-6 hermetic-pore basecaller from scratch (winlen 11, 32
filters, hidden 64, layers b/f/b; reads of 60 bases; Adam at 3e-3 with
warm-up and cosine decay), or loads it from ``--params-cache``, then runs
the whole signal loop (message -> conv encode -> squiggle -> basecaller ->
forward-backward -> list-Viterbi -> CRC/index) at the experiment's code,
L=8 and max deviation 20 (supplementary Table 3's regime), and records
Table 3's correct / erasure / error breakdown.

The cache is an ``.npz`` of the network's parameters under the JAX
package's names: a cache that the repository's JAX report script wrote
loads here, and the one written here loads there. Absolute numbers are not
comparable with the published table: the hermetic hash pore model replaces
scrappie's trained levels (``signal/squiggle.py``).

    python -m nanopore_dna_storage_tpu_torch.reports.signal_fidelity \\
        [--reads 48] [--train-steps 4000] [--experiment 7] \\
        [--profile clean|published] [--params-cache P.npz]

The record goes to ``docs/SIGNAL_FIDELITY_H100.json`` only at the full
4,000 training steps or with ``--out``; a shorter run prints it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
from typing import Optional, Tuple

import numpy as np

from ..config import ExperimentConfig
from ..models import flipflop as ff
from ..pipeline.encode import encode_bytes
from ..pipeline.experiments import experiment
from ..pipeline.simulate import SimStats, simulate_and_decode_signal
from ..signal.squiggle import PUBLISHED_PROFILE, ChannelProfile
from . import basecall_error, corpus

# the kmer-6 pore model needs more capacity than simulate-signal's small
# model; constant lr=1e-2 diverges on it, warm-up and cosine at 3e-3
# converge (basecall_error.py)
MODEL_CFG = ff.FlipflopConfig(winlen=11, stride=2, conv_filters=32,
                              hidden=64, layer_dirs=("b", "f", "b"))
TRAIN_SEQ_LEN, LEARNING_RATE, MAX_DEVIATION = 60, 3e-3, 20
FULL_TRAIN_STEPS = 4000
NOTE = ("hermetic pore model with residual scale calibrated so the "
        "from-scratch-trained basecaller reaches the reference's "
        "published real-data basecall error (~8.4-8.8%, "
        "supplementary §7; signal/squiggle.py RESID_SCALE) — "
        "Table-3 decode accuracy is the comparison anchor")


def channel_profile(name: str, override: Optional[str] = None
                    ) -> Optional[ChannelProfile]:
    """None for ``clean``; ``PUBLISHED_PROFILE`` for ``published``, with
    ``override``'s comma-separated ``field=value`` pairs replacing its
    fields (``flank_bases`` an int, the rest floats)."""
    if name == "clean":
        return None
    profile = PUBLISHED_PROFILE
    if override:
        kv = dict(s.split("=") for s in override.split(","))
        profile = dataclasses.replace(
            profile, **{k: (int(v) if k == "flank_bases" else float(v))
                        for k, v in kv.items()})
    return profile


def fidelity_data(exp: ExperimentConfig, seed: int) -> bytes:
    """Enough random bytes for a handful of distinct oligos (file recovery
    is measured elsewhere; this measures per-read decode accuracy)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, exp.bytes_per_oligo * 6, np.uint8).tobytes()


def load_cache(path: str, device) -> ff.FlipflopNet:
    """A parameter cache under the JAX package's names as the net."""
    with np.load(path) as z:
        return ff.params_from_numpy({k: z[k] for k in z.files}, MODEL_CFG,
                                    device=device)


def run(exp: ExperimentConfig, data: bytes, *, experiment_id: int,
        reads: int = 48, train_steps: int = FULL_TRAIN_STEPS,
        list_size: int = 8, kmer: int = 6, batch: int = 2, seed: int = 1,
        profile: str = "clean", override: Optional[str] = None,
        params=None, device="cuda"
        ) -> Tuple[dict, ff.FlipflopNet, SimStats]:
    """``reads`` raw-signal reads of ``data`` encoded at ``exp``, basecalled
    and decoded ``batch`` at a time on ``device`` on the channel
    ``channel_profile(profile, override)``. ``params``: a net or a
    parameter dict; without it a basecaller is first trained for
    ``train_steps`` steps. Returns (the record, the net, the stats)."""
    corpus.resolve_device(device)
    enc = encode_bytes(data, exp)
    t0 = time.perf_counter()
    stats, net = simulate_and_decode_signal(
        enc, exp, num_reads=reads, list_size=list_size, seed=seed,
        max_deviation=MAX_DEVIATION, train_steps=train_steps, kmer=kmer,
        model_cfg=MODEL_CFG, train_seq_len=TRAIN_SEQ_LEN,
        learning_rate=LEARNING_RATE, lr_schedule=True, params=params,
        batch=batch, profile=channel_profile(profile, override),
        device=device)
    dt = time.perf_counter() - t0
    n = stats.num_reads
    correct = stats.list_correct
    record = {
        "config": f"m={exp.conv_mem} r index {exp.conv_rate} "
                  f"L={list_size} max_dev={MAX_DEVIATION} kmer={kmer}",
        "experiment": experiment_id,
        "profile": profile,
        "device": corpus.device_name(device),
        "train_steps": train_steps,
        "num_reads": n,
        "num_correct": correct,
        # no CRC-passing candidate in the list
        "num_erasure_CRC": n - stats.crc_pass,
        # CRC passed but the index or payload is wrong
        "num_error_CRC": stats.crc_pass - correct,
        "pct_correct": round(100.0 * correct / n, 2),
        "top_correct": stats.top_correct,
        "unique_indices": stats.unique_indices,
        "wall_s": round(dt, 1),
        "note": NOTE,
    }
    return record, ff.as_net(net, MODEL_CFG, device), stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Signal-fidelity decode accuracy on the port.")
    ap.add_argument("--reads", type=int, default=48)
    ap.add_argument("--train-steps", type=int, default=FULL_TRAIN_STEPS,
                    help="steps to train, or the steps that made a loaded "
                         "cache")
    ap.add_argument("--list-size", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless cpu is asked for)")
    ap.add_argument("--experiment", type=int, default=7,
                    help="published experiment id (7 = m=11 r=5/6)")
    ap.add_argument("--kmer", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2,
                    help="decode batch; each read's selections take ~2.1 GB "
                         "of the card at experiment 7")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--profile", default="clean",
                    choices=["clean", "published"],
                    help="channel profile: 'clean' = iid hermetic channel; "
                         "'published' = + chimeric/junk reads, error "
                         "bursts, baseline drift, flank mis-trim "
                         "(signal/squiggle.PUBLISHED_PROFILE, calibrated "
                         "against supplementary Table 3)")
    ap.add_argument("--params-cache",
                    default=str(corpus.STATE_DIR / "fidelity_params.npz"),
                    help="trained-basecaller cache (training is "
                         "profile-independent; calibration sweeps reuse it)")
    ap.add_argument("--override", default=None,
                    help="comma-separated ChannelProfile field overrides "
                         "for calibration sweeps, e.g. "
                         "'burst_rate=0.01,drift=0.15'")
    ap.add_argument("--out", default=None,
                    help="output JSON (default "
                         "docs/SIGNAL_FIDELITY_H100.json, written at the "
                         "full 4000 training steps)")
    args = ap.parse_args(argv)
    dev = corpus.resolve_device(args.device)
    exp = experiment(args.experiment)
    cache = pathlib.Path(args.params_cache) if args.params_cache else None
    params = None
    if cache is not None and cache.exists():
        params = load_cache(str(cache), dev)
        print(f"# loaded trained params from {cache}", flush=True)
    if args.profile == "published" and args.override:
        print(f"# profile overrides: {args.override}", flush=True)
    record, net, _ = run(
        exp, fidelity_data(exp, args.seed), experiment_id=args.experiment,
        reads=args.reads, train_steps=args.train_steps,
        list_size=args.list_size, kmer=args.kmer, batch=args.batch,
        seed=args.seed, profile=args.profile, override=args.override,
        params=params, device=dev)
    if cache is not None and not cache.exists():
        cache.parent.mkdir(parents=True, exist_ok=True)
        basecall_error.save_params(net, str(cache))
    if args.out or args.train_steps == FULL_TRAIN_STEPS:
        dest = pathlib.Path(args.out) if args.out else \
            corpus.REPO / "docs" / "SIGNAL_FIDELITY_H100.json"
        dest.write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
