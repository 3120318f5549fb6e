"""Command line of the port:

  python -m nanopore_dna_storage_tpu_torch.cli encode -i FILE -o OLIGOS ...
  python -m nanopore_dna_storage_tpu_torch.cli simulate ...
  python -m nanopore_dna_storage_tpu_torch.cli sim-decode -i FILE ...
  python -m nanopore_dna_storage_tpu_torch.cli decode-posts --post-dir D ...
  python -m nanopore_dna_storage_tpu_torch.cli error-rate --lists-dir D ...
  python -m nanopore_dna_storage_tpu_torch.cli rs-recover --lists-dir D ...
  python -m nanopore_dna_storage_tpu_torch.cli read-cost --lists-dir D ...

Counterpart of ``nanopore_dna_storage_tpu/cli.py``'s commands of the same
names (``_add_exp_args``, ``_experiment``, ``cmd_encode``,
``cmd_simulate``, ``cmd_sim_decode``, ``cmd_decode_posts``,
``cmd_error_rate``, ``cmd_rs_recover``, ``cmd_read_cost``): the same flags,
the same output files and the same JSON lines. ``encode`` and the three
list commands run on the host. ``simulate``, ``sim-decode`` and
``decode-posts`` decode on the card: they add ``--device`` (default
``cuda``; no fallback to the CPU), and ``sim-decode`` and ``decode-posts``
add ``--batch``, the number of reads decoded together. ``decode-posts``
reads flappie's ``.post`` files, with ``--with-barcodes`` also the
``.fastq`` and ``.trans`` beside each, and writes the ``list_<i>`` files
and ``info.txt`` of the reference's generate_decoded_lists.py, which the
list commands read. Of the reference's commands only ``simulate-signal``
is not ported: it trains a basecaller first, and waits for the trainer.
The basecaller chain itself is ported as a library
(``pipeline/basecall.py`` ``Basecaller``), as the reference has no
basecall command either.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import random
import sys

import numpy as np


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


def cmd_encode(args):
    """Encode a file to oligos: one line each, the barcoded ones as FASTA
    with ``--fasta``. Prints one JSON line and returns its record."""
    from .pipeline.encode import encode_file, write_fasta

    exp = _experiment(args)
    res = encode_file(args.infile, exp)
    out = pathlib.Path(args.outfile)
    with open(out, "w") as f:
        for o in res.oligos:
            f.write(o + "\n")
    if args.fasta:
        write_fasta(args.fasta, res.oligos_barcoded)
    rec = {"oligo_len": res.oligo_len, "msg_len": res.msg_len,
           "num_oligos_data": res.num_oligos_data,
           "num_oligos_RS": res.num_oligos_rs,
           "writing_rate_bits_per_base": round(res.writing_rate, 4)}
    print(json.dumps(rec))
    return rec


def cmd_simulate(args):
    """Inner-code Monte-Carlo accuracy trial (simulator.py equivalent): one
    ``LVADecoder`` per orientation on ``--device``; reads are drawn from
    one ``rng`` in the reference's order (a batch's messages, then each
    read's orientation, channel and posterior). Prints one JSON line and
    returns its record."""
    from .coding.conv import (conv_encode_bases, make_conv_code,
                              reverse_complement_bases)
    from .config import ConvCodeConfig, DecodeConfig
    from .io.post import pack_posts
    from .ops.lva import LVADecoder
    from .ops.synthetic import synthetic_post
    from .signal.channel import simulate_indelsubs

    rng = np.random.default_rng(args.seed)
    cfg = ConvCodeConfig(mem=args.mem, rate=args.rate, msg_len=args.msg_len)
    code = make_conv_code(cfg)
    decs = {rc: LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=args.mem, rate=args.rate,
                            msg_len=args.msg_len, rc=rc),
        list_size=args.list_size, max_deviation=args.max_deviation),
        device=args.device)
        for rc in (False, True)}
    stats = dict(top=0, lst=0, hamming=[])
    for lo in range(0, args.num_trials, args.batch):
        n = min(args.batch, args.num_trials - lo)
        msgs = rng.integers(0, 2, (n, args.msg_len), dtype=np.uint8)
        bases = conv_encode_bases(code, msgs)
        posts, rcs = [], []
        for b in bases:
            rc = bool(rng.integers(2))
            seq = reverse_complement_bases(b) if rc else b
            noisy = simulate_indelsubs(seq, rng, args.sub, args.del_p,
                                       args.ins)
            posts.append(synthetic_post(noisy, rng))
            rcs.append(rc)
        batch, nblks = pack_posts(posts)
        rcs = np.asarray(rcs)
        for rc in (False, True):
            sel = np.nonzero(rcs == rc)[0]
            if not len(sel):
                continue
            out, _, valid = decs[rc].decode(batch[sel], nblks[sel])
            for j, gi in enumerate(sel):
                want = msgs[gi]
                lst = [m for m, v in zip(out[j], valid[j]) if v]
                if len(lst) and (lst[0] == want).all():
                    stats["top"] += 1
                if any((m == want).all() for m in lst):
                    stats["lst"] += 1
                if len(lst):
                    stats["hamming"].append(int((lst[0] != want).sum()))
    rec = {"num_trials": args.num_trials,
           "top_correct": stats["top"] / args.num_trials,
           "list_correct": stats["lst"] / args.num_trials,
           "mean_hamming": float(np.mean(stats["hamming"]))
           if stats["hamming"] else None}
    print(json.dumps(rec))
    return rec


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


def _first_passing(lst, exp, num_oligos: int):
    """A read's chosen message: the first entry of its list file that passes
    the CRC/index check (``check_and_extract``), as (index, message string,
    payload bytes); None when no entry passes, or the list is empty (a read
    with no valid path, on which the reference's check raises)."""
    from .coding.framing import check_and_extract, extract_payload

    if not lst:
        return None
    msgs = np.asarray([[int(c) for c in m] for m in lst], np.uint8)
    ok, idx = check_and_extract(msgs, exp.framing, num_oligos, pad=exp.pad)
    if not ok.any():
        return None
    first = int(np.argmax(ok))
    return (int(idx[first]), lst[first],
            extract_payload(msgs[first], exp.framing, exp.bytes_per_oligo,
                            pad=exp.pad))


def _num_oligos(exp, size: int) -> int:
    """The oligo count of a ``size``-byte file, from its size padded to whole
    oligos, as the reference computes it (decode_RS_from_decoded_lists.py:
    20-22 via compute_parameters)."""
    padded = math.ceil(size / exp.bytes_per_oligo) * exp.bytes_per_oligo
    return exp.oligo_counts(padded)[2]


def cmd_error_rate(args):
    """Scan decoded list files (compute_error_rate_from_decoded_lists.py);
    an empty list file counts as a CRC erasure. Prints one JSON line and
    returns its record."""
    from .io.lists import decoded_indices, read_list_file

    exp = _experiment(args)
    with open(args.oligos) as f:
        oligo_msgs = [l.rstrip("\n") for l in f]
    counts = dict(num_reads=0, num_correct=0, num_erasure_CRC=0,
                  num_error_CRC=0)
    num_oligos = len(oligo_msgs)
    # index -> {msg: count}, the reference's decoded_index_dict
    # (compute_error_rate_from_decoded_lists.py:22-51): per recovered index,
    # vote over the per-read chosen messages.
    index_dict: dict = {}
    for i in decoded_indices(args.lists_dir):
        lst = read_list_file(args.lists_dir, i, args.list_size)
        counts["num_reads"] += 1
        hit = _first_passing(lst, exp, num_oligos)
        if hit is None:
            counts["num_erasure_CRC"] += 1
            continue
        index, msg, _ = hit
        votes = index_dict.setdefault(index, {})
        votes[msg] = votes.get(msg, 0) + 1
        if msg == oligo_msgs[index]:
            counts["num_correct"] += 1
        else:
            counts["num_error_CRC"] += 1
    # majority stats: per recovered index, does the top-voted message match?
    maj_correct = sum(
        1 for index, votes in index_dict.items()
        if max(votes.items(), key=lambda kv: kv[1])[0] == oligo_msgs[index])
    counts["num_indices_recovered"] = len(index_dict)
    counts["num_indices_majority_correct"] = maj_correct
    print(json.dumps(counts))
    return counts


def cmd_rs_recover(args):
    """Subsampled RS recovery trials (decode_RS_from_decoded_lists.py).
    Prints one JSON line and returns its record."""
    from .io.lists import decoded_indices, read_list_file
    from .pipeline.decode import majority_vote, recover_file

    exp = _experiment(args)
    size = args.data_size
    num_oligos = _num_oligos(exp, size)
    all_ids = decoded_indices(args.lists_dir)
    rnd = random.Random(args.seed)
    successes = 0
    for trial in range(args.num_trials):
        ids = rnd.sample(all_ids, min(args.num_reads, len(all_ids)))
        idxs, pls = [], []
        for i in ids:
            hit = _first_passing(read_list_file(
                args.lists_dir, i, args.list_size), exp, num_oligos)
            if hit is not None:
                idxs.append(hit[0])
                pls.append(hit[2])
        voted = majority_vote(np.asarray(idxs), np.asarray(pls))
        ok, data = recover_file(voted, exp, size)
        want = pathlib.Path(args.infile).read_bytes() if args.infile else None
        if ok and (want is None or data == want):
            successes += 1
    rec = {"trials": args.num_trials, "successes": successes}
    print(json.dumps(rec))
    return rec


def cmd_read_cost(args):
    """Reading-cost sweep (supplementary Table 2 methodology): the minimum
    number of reads, in steps of --step, for which --num-trials/--num-trials
    random subsampling trials all recover the file via RS, reported as
    bases/bit = min_reads * oligo_len / (8 * data_size)
    (decode_RS_from_decoded_lists.py:29-68 over a read-count sweep). Prints
    one JSON line and returns its record."""
    from .io.lists import decoded_indices, read_list_file
    from .pipeline.decode import majority_vote, recover_file

    exp = _experiment(args)
    size = args.data_size
    num_oligos = _num_oligos(exp, size)
    want = pathlib.Path(args.infile).read_bytes() if args.infile else None
    all_ids = decoded_indices(args.lists_dir)

    # pre-classify every read once (CRC+index per list); the sweep then just
    # subsamples the classification results
    classified = {}
    for i in all_ids:
        hit = _first_passing(read_list_file(args.lists_dir, i,
                                            args.list_size), exp, num_oligos)
        if hit is not None:
            classified[i] = (hit[0], hit[2])

    def trials_pass(n_reads: int) -> int:
        rnd = random.Random(args.seed)
        succ = 0
        for _ in range(args.num_trials):
            ids = rnd.sample(all_ids, min(n_reads, len(all_ids)))
            hits = [classified[i] for i in ids if i in classified]
            voted = majority_vote(
                np.asarray([h[0] for h in hits], np.int64),
                np.asarray([h[1] for h in hits], np.uint8).reshape(
                    -1, exp.bytes_per_oligo))
            ok, data = recover_file(voted, exp, size)
            if ok and (want is None or data == want):
                succ += 1
        return succ

    result = None
    sweep = []
    for n in range(args.step, len(all_ids) + args.step, args.step):
        n_eff = min(n, len(all_ids))
        succ = trials_pass(n_eff)
        sweep.append({"num_reads": n_eff, "successes": succ})
        if succ == args.num_trials:
            result = n_eff
            break
        if n_eff == len(all_ids):
            break
    oligo_len = args.oligo_len
    cost = (result * oligo_len / (8.0 * size)) if result and oligo_len \
        else None
    rec = {"min_reads": result, "sweep": sweep,
           "reading_cost_bases_per_bit": round(cost, 3) if cost else None}
    print(json.dumps(rec))
    return rec


def cmd_decode_posts(args):
    """Decode flappie's artifacts (``.post`` [+ ``.fastq`` + ``.trans``])
    to list files (generate_decoded_lists.py for basecalled reads), in
    batches of ``--batch`` reads on ``--device``. Prints one JSON line;
    returns (its record, the forward block steps the decoders ran)."""
    import glob
    import os

    from .io.post import read_post
    from .pipeline.decode import PipelineDecoder
    from .pipeline.real_data import (ReadDecodeRecord,
                                     decode_posts_with_barcodes,
                                     load_flappie_artifacts,
                                     write_decoded_lists)

    exp = _experiment(args)
    post_files = sorted(glob.glob(os.path.join(args.post_dir, "*.post")))
    if not post_files:
        raise SystemExit(f"no .post files in {args.post_dir}")
    dec = PipelineDecoder(exp, args.list_size, args.max_deviation,
                          device=args.device)
    num_oligos = 1 << exp.framing.index_len
    if args.with_barcodes:
        ids, posts, calls, transes = [], [], [], []
        for pf in post_files:
            stem = pf[: -len(".post")]
            post, call, trans = load_flappie_artifacts(
                pf, stem + ".fastq", stem + ".trans")
            ids.append(os.path.basename(stem))
            posts.append(post)
            calls.append(call)
            transes.append(trans)
        records = decode_posts_with_barcodes(
            ids, posts, calls, transes, exp, args.list_size,
            max_deviation=args.max_deviation, decoder=dec, batch=args.batch)
    else:
        # posts already truncated to the payload window; decode fwd + rc and
        # keep the orientation the gated pick chooses
        records = []
        for lo in range(0, len(post_files), args.batch):
            chunk = post_files[lo:lo + args.batch]
            out, use_rc = dec.decode_posts_auto_orientation(
                [read_post(pf) for pf in chunk], num_oligos)
            for i, pf in enumerate(chunk):
                msgs = ["".join(map(str, m))
                        for m, v in zip(out.msgs[i], out.valid[i]) if v]
                records.append(ReadDecodeRecord(
                    os.path.basename(pf)[: -len(".post")], "ok",
                    bool(use_rc[i]), msgs=msgs))
    os.makedirs(args.outdir, exist_ok=True)
    write_decoded_lists(args.outdir, records)
    ok = sum(1 for r in records if r.status == "ok")
    rec = {"reads": len(records), "decoded": ok}
    print(json.dumps(rec))
    return rec, dec.steps


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nanopore_dna_storage_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode")
    _add_exp_args(p)
    p.add_argument("-i", "--infile", required=True)
    p.add_argument("-o", "--outfile", required=True)
    p.add_argument("--fasta")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("simulate")
    p.add_argument("--mem", type=int, default=11)
    p.add_argument("--rate", type=int, default=5)
    p.add_argument("--msg-len", type=int, default=180)
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--num-trials", type=int, default=32)
    p.add_argument("--max-deviation", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--sub", type=float, default=0.004)
    p.add_argument("--del-p", type=float, default=0.0085)
    p.add_argument("--ins", type=float, default=0.0005)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the decode (cuda or cpu)")
    p.set_defaults(fn=cmd_simulate)

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

    p = sub.add_parser("decode-posts")
    _add_exp_args(p)
    p.add_argument("--post-dir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--max-deviation", type=int, default=20)
    p.add_argument("--with-barcodes", action="store_true",
                   help="expect .fastq/.trans next to each .post and locate "
                        "barcodes (generate_decoded_lists.py flow)")
    p.add_argument("--batch", type=int, default=8,
                   help="reads decoded together; at m=11 each holds about "
                        "2.1 GB of selections on the device")
    p.add_argument("--device", default="cuda",
                   help="torch device of the decode (cuda or cpu)")
    p.set_defaults(fn=cmd_decode_posts)

    p = sub.add_parser("error-rate")
    _add_exp_args(p)
    p.add_argument("--lists-dir", required=True)
    p.add_argument("--oligos", required=True,
                   help="file of true message bit strings")
    p.add_argument("--list-size", type=int, default=8)
    p.set_defaults(fn=cmd_error_rate)

    p = sub.add_parser("read-cost")
    _add_exp_args(p)
    p.add_argument("--lists-dir", required=True)
    p.add_argument("--data-size", type=int, required=True)
    p.add_argument("--infile", help="original file for byte comparison")
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--step", type=int, default=500,
                   help="read-count sweep step (supplementary Table 2)")
    p.add_argument("--num-trials", type=int, default=10)
    p.add_argument("--oligo-len", type=int, default=0,
                   help="oligo length incl. any padding, for bases/bit")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_read_cost)

    p = sub.add_parser("rs-recover")
    _add_exp_args(p)
    p.add_argument("--lists-dir", required=True)
    p.add_argument("--data-size", type=int, required=True)
    p.add_argument("--infile", help="original file for byte comparison")
    p.add_argument("--num-reads", type=int, default=5000)
    p.add_argument("--num-trials", type=int, default=10)
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_rs_recover)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
