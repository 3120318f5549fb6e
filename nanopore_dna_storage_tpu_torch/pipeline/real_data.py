"""The real-read decode: posteriors, basecalls and ``.trans`` block
indices -> decoded list files.

Counterpart of ``nanopore_dna_storage_tpu/pipeline/real_data.py``, the
in-memory equivalent of generate_decoded_lists.py after basecalling: for
each read, locate the barcodes in the forward basecall and in the
orientation of its reverse complement, pick the orientation with the lower
total edit distance (generate_decoded_lists.py:68-74), truncate the
transition posterior to the payload window, then list-Viterbi decode the
windows in batches with each read's orientation on the port's
``PipelineDecoder``. The barcode search and the list files are host numpy;
the decode runs on the decoder's device. ``load_flappie_artifacts`` reads
flappie's ``.post`` + fastq + ``.trans`` triple. The basecall itself is
``pipeline/basecall.py``'s ``Basecaller``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..coding.conv import (bases_to_str, make_conv_code,
                           reverse_complement_bases, str_to_bases)
from ..config import ConvCodeConfig, ExperimentConfig
from ..io import lists as lists_io
from ..io.post import read_post
from ..signal.barcode import find_barcode_window, truncate_post
from .decode import PipelineDecoder


@dataclasses.dataclass
class ReadDecodeRecord:
    read_id: str
    status: str  # "ok" | "barcode_failure" | "too_short"
    rc: bool = False
    start_pos: int = -1
    end_pos: int = -1
    msgs: Optional[List[str]] = None


def reverse_complement_str(s: str) -> str:
    return bases_to_str(reverse_complement_bases(str_to_bases(s)))[0]


def locate_payload(basecall: str, trans_arr: np.ndarray,
                   exp: ExperimentConfig) -> Tuple[bool, int, int, float]:
    """Try fwd and RC barcode orientations; return (rc, start, end, dist).

    generate_decoded_lists.py:68-82: both orientations are scored and the one
    with smaller summed edit distance wins, forward on a tie; (-1,-1) means
    failure.
    """
    s_f, e_f, d1f, d2f = find_barcode_window(
        basecall, trans_arr, exp.start_barcode, exp.end_barcode)
    s_r, e_r, d1r, d2r = find_barcode_window(
        basecall, trans_arr, reverse_complement_str(exp.end_barcode),
        reverse_complement_str(exp.start_barcode))
    if min(d1f + d2f, d1r + d2r) == np.inf:
        return False, -1, -1, np.inf
    if d1f + d2f <= d1r + d2r:
        return False, s_f, e_f, d1f + d2f
    return True, s_r, e_r, d1r + d2r


def decode_posts_with_barcodes(
    read_ids: Sequence[str],
    posts: Sequence[np.ndarray],
    basecalls: Sequence[str],
    trans_arrs: Sequence[np.ndarray],
    exp: ExperimentConfig,
    list_size: int,
    max_deviation: int = 20,
    decoder: Optional[PipelineDecoder] = None,
    batch: int = 32,
    *,
    device="cuda",
) -> List[ReadDecodeRecord]:
    """Full per-read flow from (post, basecall, trans) triples. The windows
    are decoded ``batch`` reads at a time by ``decoder``, by default a
    ``PipelineDecoder`` of ``exp`` on ``device`` (``cuda`` unless the
    caller asks for ``cpu``). A read whose barcodes are not found is a
    ``barcode_failure``; one whose window is shorter than the trellis's
    ``nstate_pos + 1`` blocks is ``too_short``; neither is decoded."""
    dec = decoder or PipelineDecoder(exp, list_size, max_deviation,
                                     device=device)
    records: List[ReadDecodeRecord] = []
    pend_posts: List[np.ndarray] = []
    pend_rc: List[bool] = []
    pend_rec: List[ReadDecodeRecord] = []
    num_oligos = 1 << exp.framing.index_len  # classification happens later
    min_blocks = make_conv_code(ConvCodeConfig(
        mem=exp.conv_mem, rate=exp.conv_rate,
        msg_len=exp.msg_len())).nstate_pos + 1

    def flush():
        if not pend_posts:
            return
        out = dec.decode_posts(pend_posts, pend_rc, num_oligos)
        for i, rec in enumerate(pend_rec):
            rec.msgs = ["".join(map(str, m))
                        for m, v in zip(out.msgs[i], out.valid[i]) if v]
        pend_posts.clear()
        pend_rc.clear()
        pend_rec.clear()

    for rid, post, call, trans in zip(read_ids, posts, basecalls, trans_arrs):
        rc, s, e, dist = locate_payload(call, trans, exp)
        if s < 0:
            records.append(ReadDecodeRecord(rid, "barcode_failure"))
            continue
        window = truncate_post(post, s, e)
        if window.shape[0] < min_blocks:
            records.append(ReadDecodeRecord(rid, "too_short", rc, s, e))
            continue
        rec = ReadDecodeRecord(rid, "ok", rc, s, e)
        records.append(rec)
        pend_posts.append(window)
        pend_rc.append(rc)
        pend_rec.append(rec)
        if len(pend_posts) >= batch:
            flush()
    flush()
    return records


def write_decoded_lists(outdir: str, records: Sequence[ReadDecodeRecord]
                        ) -> None:
    """Reference-format outputs: list_<i> per decoded read, numbered by the
    record's position (failures included), + info.txt."""
    info = []
    for i, rec in enumerate(records):
        if rec.status == "ok" and rec.msgs is not None:
            lists_io.write_list_file(outdir, i, rec.msgs)
        info.append(f"{rec.read_id}\t{rec.status}\trc={int(rec.rc)}\t"
                    f"pos={rec.start_pos}:{rec.end_pos}")
    lists_io.write_info(outdir, info)


def load_flappie_artifacts(post_file: str, fastq_file: str, trans_file: str
                           ) -> Tuple[np.ndarray, str, np.ndarray]:
    """Interop: read a flappie-produced (post, fastq, trans) triple."""
    post = read_post(post_file)
    with open(fastq_file) as f:
        f.readline()
        basecall = f.readline().rstrip("\n")
    trans = np.loadtxt(trans_file, dtype=np.int64, ndmin=1)
    return post, basecall, trans
