"""The basecall error of a flip-flop basecaller trained from scratch on the
hermetic pore model, on the port: the diagnostic between "the signal loop
is wired" and "the signal loop decodes" (the reference's real-data
basecall error is 8.4%, supplementary §7, and decode accuracy collapses
well before ~15%).

``train_on_synthetic`` trains at the given widths on reads of the pore
model's ``kmer``; held-out reads, drawn from ``seed + 777`` at the decode's
read length, go through the network, the flip-flop Viterbi and the
basecall on the device, and their edit distance to the true bases is
counted on the host. ``--save`` writes the trained parameters as an
``.npz`` under the JAX package's names, which either package's ``load_npz``
reads.

    python -m nanopore_dna_storage_tpu_torch.reports.basecall_error \\
        --steps 4000 --kmer 6 --lr 3e-3 --schedule [--save P.npz]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import flipflop as ff
from ..models import train as trainmod
from ..ops.crf_decode import basecall_from_path, viterbi_flipflop_batch
from ..signal.normalize import medmad_normalize
from ..signal.squiggle import simulate_raw_signal
from . import corpus

# samples a base at the decode's dwell
SAMPLES_PER_BASE = 12


def edit_distance(a, b) -> int:
    """Levenshtein distance of two sequences, unit costs."""
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[lb]


def evaluate(net: ff.FlipflopNet, *, kmer: int, eval_reads: int,
             eval_len: int, seed: int) -> List[int]:
    """The edit distance of each of ``eval_reads`` held-out reads of
    ``eval_len`` bases (drawn from ``seed + 777``, without the deepsim
    dwell, medmad-normalised and cut to ``eval_len * 12`` samples) from its
    basecall through ``net`` on the net's device."""
    cfg = net.cfg
    rng = np.random.default_rng(seed + 777)
    T = eval_len * SAMPLES_PER_BASE
    sig = np.zeros((eval_reads, T), np.float32)
    ns = np.zeros(eval_reads, np.int64)
    seqs = []
    for i in range(eval_reads):
        seq = rng.integers(0, 4, eval_len).astype(np.uint8)
        raw = simulate_raw_signal(seq, rng, deepsim_dwell=False, kmer=kmer)
        raw = medmad_normalize(raw)[:T]
        sig[i, : len(raw)] = raw
        ns[i] = len(raw)
        seqs.append(seq)
    nsamples = torch.from_numpy(ns).to(net.device)
    trans = net(torch.from_numpy(sig).to(net.device), nsamples)
    nblk = -(-nsamples // cfg.stride)
    paths, _ = viterbi_flipflop_batch(trans.reshape(eval_reads, -1, 5, 8),
                                      nblk)
    paths = paths.cpu().numpy()
    b2i = {b: i for i, b in enumerate("ACGT")}
    dists = []
    for i in range(eval_reads):
        call, _ = basecall_from_path(paths[i], int(nblk[i]))
        dists.append(edit_distance([b2i[c] for c in call],
                                   list(map(int, seqs[i]))))
    return dists


def save_params(net: ff.FlipflopNet, path: str) -> None:
    """The net's parameters as an ``.npz`` under the JAX package's names."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in net.named_parameters()})


def run(cfg: ff.FlipflopConfig, *, steps: int, kmer: int = 6,
        batch: int = 8, seq_len: int = 60, lr: float = 1e-2,
        schedule: bool = False, eval_reads: int = 32, eval_len: int = 120,
        seed: int = 1, device="cuda", save: Optional[str] = None
        ) -> Tuple[dict, ff.FlipflopNet]:
    """Train ``cfg`` for ``steps`` steps of ``batch`` reads of ``seq_len``
    bases of the kmer-``kmer`` pore model (Adam at ``lr``, warm-up and
    cosine under ``schedule``) on ``device``, then ``evaluate``. Returns (the
    record, the trained net), and writes the net to ``save`` when given."""
    corpus.resolve_device(device)
    t0 = time.perf_counter()
    state, losses = trainmod.train_on_synthetic(
        cfg, steps=steps, batch=batch, seq_len=seq_len, seed=seed,
        learning_rate=lr, schedule=schedule, kmer=kmer, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    net = state.net.requires_grad_(False)
    dists = evaluate(net, kmer=kmer, eval_reads=eval_reads,
                     eval_len=eval_len, seed=seed)
    record = {"steps": steps, "kmer": kmer, "hidden": cfg.hidden,
              "filters": cfg.conv_filters, "layers": "".join(cfg.layer_dirs),
              "final_loss": round(float(np.mean(losses[-50:])), 4),
              "basecall_err_pct": round(100.0 * sum(dists)
                                        / (eval_reads * eval_len), 2),
              "train_s": round(t_train, 1)}
    if save:
        save_params(net, save)
    return record, net


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Train a basecaller from scratch on the port and "
                    "measure its basecall error.")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--kmer", type=int, default=6)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--filters", type=int, default=32)
    ap.add_argument("--layers", default="bfb")
    ap.add_argument("--winlen", type=int, default=11)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--schedule", action="store_true",
                    help="warmup + cosine decay instead of constant LR")
    ap.add_argument("--eval-reads", type=int, default=32)
    ap.add_argument("--eval-len", type=int, default=120)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless cpu is asked for)")
    ap.add_argument("--save", default="",
                    help="save trained params to this .npz")
    args = ap.parse_args(argv)
    cfg = ff.FlipflopConfig(winlen=args.winlen, stride=2,
                            conv_filters=args.filters, hidden=args.hidden,
                            layer_dirs=tuple(args.layers))
    record, _ = run(cfg, steps=args.steps, kmer=args.kmer, batch=args.batch,
                    seq_len=args.seq_len, lr=args.lr,
                    schedule=args.schedule, eval_reads=args.eval_reads,
                    eval_len=args.eval_len, seed=args.seed,
                    device=args.device, save=args.save or None)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
