"""Command line of the port:

  python -m nanopore_dna_storage_tpu_torch.cli sim-decode -i FILE ...

Counterpart of ``nanopore_dna_storage_tpu/cli.py`` ``sim-decode``
(``_add_exp_args``, ``_experiment``, ``cmd_sim_decode``): the same flags and
the same JSON line, plus ``--device`` (default ``cuda``; no fallback to the
CPU) and ``--batch``, the number of reads decoded together. The reference's
other commands are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _add_exp_args(p: argparse.ArgumentParser):
    p.add_argument("--experiment", type=int, default=None,
                   help="published experiment id 0..12")
    p.add_argument("--bytes-per-oligo", type=int, default=20)
    p.add_argument("--rs-redundancy", type=float, default=0.3)
    p.add_argument("--mem", type=int, default=11)
    p.add_argument("--rate", type=int, default=5)
    p.add_argument("--pad", action="store_true")


def _experiment(args):
    from .config import ExperimentConfig
    from .pipeline import experiment

    if args.experiment is not None:
        return experiment(args.experiment)
    return ExperimentConfig(
        bytes_per_oligo=args.bytes_per_oligo,
        rs_redundancy=args.rs_redundancy,
        conv_mem=args.mem, conv_rate=args.rate, pad=args.pad)


def cmd_sim_decode(args):
    """Encode a file, simulate reads, decode them and recover the file.
    Prints one JSON line; returns (that record, SimStats)."""
    from .pipeline import encode_file
    from .pipeline.simulate import simulate_and_decode

    exp = _experiment(args)
    enc = encode_file(args.infile, exp)
    size = pathlib.Path(args.infile).stat().st_size
    ok, data, stats = simulate_and_decode(
        enc, exp, args.num_reads, size, list_size=args.list_size,
        seed=args.seed, sub_prob=args.sub, del_prob=args.del_p,
        ins_prob=args.ins, batch=args.batch, device=args.device)
    if args.outfile:
        pathlib.Path(args.outfile).write_bytes(data)
    rec = {"recovered": bool(ok),
           "byte_exact": data == pathlib.Path(args.infile).read_bytes(),
           "reads": stats.num_reads,
           "crc_pass": stats.crc_pass,
           "unique_indices": stats.unique_indices}
    print(json.dumps(rec))
    return rec, stats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nanopore_dna_storage_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sim-decode")
    _add_exp_args(p)
    p.add_argument("-i", "--infile", required=True)
    p.add_argument("-o", "--outfile")
    p.add_argument("--num-reads", type=int, default=100)
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--sub", type=float, default=0.004)
    p.add_argument("--del-p", type=float, default=0.0085)
    p.add_argument("--ins", type=float, default=0.0005)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8,
                   help="reads decoded together; at m=11 each holds about "
                        "2.1 GB of selections on the device")
    p.add_argument("--device", default="cuda",
                   help="torch device of the decode (cuda or cpu)")
    p.set_defaults(fn=cmd_sim_decode)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
