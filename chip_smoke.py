#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

0. setup: needs a CUDA device; builds every kernel library from
   ``nanopore_dna_storage_tpu_torch/csrc``, one nvcc per source, all at
   once (each timed, with its ptxas registers, stack and spills); fails if
   the K-way ACS kernel's L = 8, 12 or 64 build (the three buckets) uses
   local memory (a stack frame or spills) and if the logsumexp kernel's
   L = 8 build (its candidates in registers) does;
1. the ACS kernel (the K-way merge) against its plain PyTorch version on
   the card, at the headline decode config (experiment 7: m=11, r=5/6,
   msg_len 180, L=8, max deviation 20) on one synthetic read: buffers and
   selections bit-equal on blocks spread over the read (position 0 and an
   inactive block included), the buffers' rows sorted in slot (the K-way
   merge's precondition), then the whole read decoded both ways; then the
   same at the main path's shapes: phase 3's first batch of reads through
   ``PipelineDecoder.decode_posts``, split by orientation into launches
   of several reads of different lengths, every block checked; and the
   kernel's L <= 16 bucket at L = 12 on a few blocks of the first read;
2. every golden vector of ``tests/golden/decode``, ``tests/golden/sync``
   (sync markers) and ``tests/golden/decode14`` (m=14, C = 16384) through
   the kernel, bit-identical to the reference binary's lists, each timed;
3. the main path: ``sim-decode`` at experiment 7 on a 100-byte file, which
   must recover the file byte for byte, with one kernel launch per forward
   block step;
4. the merge-family probes (``probes/merge_roofline.py``,
   ``probes/treepop.py``): the launch floor (an empty kernel in a CUDA
   graph); merge and stream bit-equal to their plain versions at [64, 8,
   512] with 256 copies and 8 rounds, every copy's slot equal; each
   tree-pop variant at every lane count built and at its default bit-equal
   on normal, tie, all -inf and +0.0 / -0.0 scores, at nc 1, 33, 60 and 63
   and at [64, 8, 32768], the guarded tree with the guard holding and
   failing at CT 128, 512 and 32768; fails if the merge kernel or any
   tree-pop kernel uses local memory; each kernel and plain version timed
   (the tree pop from CUDA graphs, and at [64, 8, 32768] by CUDA events
   against its bytes bound, at every lane count); then the probes' entry
   points; the roofline line sets their rates beside the ACS kernel's
   (phase 1, one read) in the operations it needs;
5. the expansion-family probes (``probes/expand.py``,
   ``probes/mxu_expand.py``): every lane-map form (gather, shfl,
   butterfly), the transpose and every one-hot product mode (tf32, bf16,
   u8x4) bit-equal to its plain version at the scripts' shapes, all copies
   equal, u8x4 bit-exact on P5's hashes and P7's payloads, the tf32
   mismatches counted; the shuffle form also at every k up to 32 and at
   columns that end in a partial warp, the transpose at shapes of every
   tile height on both its 16-byte and 4-byte paths; both libraries free of
   stack frames and spills, and the one-hot library's SASS all ``HGMMA``
   (wgmma), no ``HMMA``; each kernel, plain version and library call timed
   (P2's maps beside theirs; every lane-map form at 4096 copies of [8,
   2048] and the transpose at 32,768 of [16, 128], 268 MB each, beside
   their bound and one copy kernel of the library writing the same copies;
   the bf16 product beside a bf16 ``bmm`` with f32 output); the expansion's
   elements written per second at 256 and 4096 copies by the gather, the
   shuffle, the one-hot product and the library's TF32 matmul; then both
   entry points, with their launch counts set to 0 before;
6. the lowering probes (``probes/lowering.py``): every P1 kernel (repeat
   through ``lane_map``, dynrow, int16, fori in both placements, reshape,
   alias) bit-equal to its plain version and to the numpy result at the
   script's shapes, fori also at the ACS kernel's merge shape (NQ = 64,
   R = 8), on tie scores with -inf columns and over 256 copies, at one
   thread (regs: one group of lanes) per item and at 128 threads per SM,
   regs at every lane count built and its default, and fails if a regs
   kernel uses local memory; fori regs timed at every lane count; alias
   returning its own buffer with every row outside a random
   window unchanged; dynrow and alias at indices and windows outside
   [0, P), reading and writing nothing outside the buffer; each kernel,
   plain version and library call timed; P7's plain version and library
   call at its shape; then the entry point, with its launch counts set to
   0 before, which also gives the fori rates (both placements at both NQ,
   and ``local`` at ``regs``'s residency); the reshape copy bit-equal at
   a few odd sizes, and at [8, 8, 1,048,576] timed beside ``clone`` and its
   bound; the launch floor at one thread and at the grids of dynrow,
   int16, reshape and alias (``grid_launch_floor_ms``);
7. logsumexp path combining through its kernel
   (``acs_block_lse``, ``csrc/lva_lse.cu``) at the headline config: the
   kernel bit-equal to its plain version on one read at B=1 (blocks over
   the read, position 0 and an inactive block, then the whole read's lists,
   scores and validity), at L = 3 and 5 (the L <= 8 bucket, its slots past
   L the constant -inf) and 12 on a few blocks, the L <= 16 bucket at L =
   12 timed at B=1 and B=4 against its bound, and on every 16th block
   of phase 3's first batch at B=4, one block timed there; then phase 3's
   32 reads through ``PipelineDecoder(..., path_combine="logsumexp")``,
   which must recover the file byte for byte with one lse launch per block
   step and no K-way launch; (7e) the same path at experiment 0 (m=8 r=1/2,
   C=256) at L = 64 and 16 (``LSE_PATH_CELLS``), the lse kernel's two lane
   buckets: the kernel bit-equal to its plain version on blocks of one
   forward read and of four, one of them also with the reads inactive,
   the middle block timed against its bound; then 24 reads through
   ``PipelineDecoder(experiment(0), L, 20, path_combine="logsumexp")``,
   every 16th block step of the first batch bit-equal, which must recover
   the 100-byte file byte for byte with one lse launch per block step and
   no K-way launch;
8. the basecaller chain at the published widths (``models/flipflop.py``
   ``FlipflopNet`` on seeded ``init_params``, ``ops/fwdbwd.py``,
   ``ops/crf_decode.py``): 32 reads of experiment 7 from
   ``simulate_posts_signal``; the same signals stage by stage on the card
   and through the CPU, transitions and posteriors within ``CHAIN_TOL``,
   Viterbi paths equal on the card's posteriors and on tie-heavy integer
   ones; the posteriors through ``PipelineDecoder.decode_posts`` at L = 8
   with one K1 launch per block step; ``Basecaller.basecall`` on the raw
   signals writing a FASTQ with qualities in 33..126; each stage timed,
   then profiled for its device operations;
9. the scale-out decode (``parallel/``) at the headline config on
   ``PARALLEL_READS`` reads of phase 3's file written as ``.post`` files:
   ``ShardedDecoder.decode`` at world 1 on the first batch's forward reads
   equal to ``LVADecoder.decode`` and the host CRC/index check, and again
   over a one-rank nccl group in this process, its count reduced and its
   shards gathered on the card, equal to the world-1 result; its on-card
   classification timed against the host's; the gated decode job through
   ``python -m nanopore_dna_storage_tpu_torch.parallel.multihost`` as one
   nccl rank and as two gloo ranks sharing ``cuda:0``, each rank launching
   K1 once per block step; their list files identical and equal to
   ``PipelineDecoder.decode_posts_auto_orientation(gated=True)`` in
   process, the ``info_*`` shards naming every read once, the CRC counts
   equal; ``cli rs-recover`` on the lists recovering the file byte for
   byte, and ``cli error-rate`` on them;
10. the real-read path at the headline config (``signal/barcode.py``,
   ``pipeline/real_data.py``, ``cli decode-posts``): ``REAL_READS``
   barcoded reads of
   phase 3's file, every second one reverse complement, with phase 3's
   channel errors, through ``synthetic_post``; their basecalls and
   ``.trans`` block indices from ``viterbi_flipflop_batch`` on the card,
   written as ``.post``, ``.fastq`` and ``.trans`` files; ``cli
   decode-posts --with-barcodes`` (its ``main`` in this process, so that
   its launches count) accounting for every read in ``info.txt`` with one
   K1 launch per block step, its lists equal to
   ``PipelineDecoder.decode_posts`` in process on the windows that
   ``locate_payload`` gives, ``cli rs-recover`` on them recovering the
   file byte for byte, the barcode search and the decode timed apart; the
   windows as truncated ``.post`` files through ``python -m
   nanopore_dna_storage_tpu_torch.cli decode-posts``, its lists and
   orientations equal to ``decode_posts_auto_orientation`` in process; 8
   barcoded raw-signal reads through ``Basecaller.basecall(keep_posterior=
   True)`` on seeded random weights and ``decode_posts_with_barcodes``,
   every read accounted for, one K1 launch per block step; the three
   vocabulary goldens through ``decode_post_vocab`` on the card equal to
   the reference's ``.out``, and a larger case (16 ten-mers, msg_len 20)
   equal to the CPU's, timed; the native host library (``native/``) built
   or not, and its three functions equal to numpy;
11. the training path (``models/train.py``): (a) at the published widths
   on the production recipe, the card's CRF loss and every parameter's
   gradient against the CPU's on the same weights and batch, under a
   caller's TF32 setting that the trainer overrides, then
   ``TRAIN_STEPS`` train steps timed, one more profiled for its device
   operations, every loss finite; (b)
   ``simulate_and_decode_signal(params=None)`` at the JAX package's
   signal-fidelity test settings, trained and decoded on the card, held
   to that test's floor, one K1 launch per block step; (c) its trained
   basecaller on experiment-7 reads, one K1 launch per block step; (d)
   ``cli simulate-signal`` in this process, printing the JAX command's
   keys;
12. the report layer (``reports/``) at experiment 7, each report through
   the ``run`` its ``python -m`` entry point calls: (a) ``file_recovery``
   on a 600-byte file (30 data and 9 RS oligos) from 160 reads decoded 16
   a chunk, which must recover the file byte for byte; (b) ``read_cost``
   on the same reads, swept every 40 reads with 3 trials a count, its
   last count succeeding in every trial and its ``min_reads`` set; (c)
   ``basecall_error`` at the fidelity report's widths and recipe (kmer 6,
   Adam at 3e-3 with warm-up and cosine) for 20 steps, 8 held-out reads
   of 120 bases, its weights saved as the JAX package's names, its edit
   distances on the card against the CPU's on the same net; (d)
   ``signal_fidelity`` on that cache with no training, 8 reads. (a), (b)
   and (d) launch K1 once per forward block step;
13. the paper's other list sizes (``LIST_SIZE_CELLS``): experiment 0 (m=8
   r=1/2, msg_len 100, C = 256, L = 64: K1's L <= 64 bucket) and
   experiment 8 (m=14 r=5/6, msg_len 181, C = 16384, L = 4), at max
   deviation 20: for each, K1 bit-equal to its plain version on one read
   and on a batch of forward reads of different lengths (blocks at
   position 0, spread over the reads and at the end, one of them also
   with every read inactive, the first block that mixes active and
   inactive reads; every buffer row sorted), the middle block timed at
   B=1 and at the batch's B against its bound; the batch decoded with
   the kernel alone, its forward and its traceback timed apart; then
   ``sim-decode`` on phase 3's file, which must recover it byte for byte
   with one K1 launch per forward block step, its s/read and peak memory;
14. the decode benchmark (``bench.py``, the counterpart of the root
   ``bench.py``) in this process on each of ``BENCH_RUNS`` (the smoke
   config, m11 on one batch of 16 reads and m14best, experiment 2: m=14
   r=1/2 msg_len 100 L=4, on one of 4) with ``--verify``: its one JSON
   line with a rate above 0 and ``lists_match`` true, that is the config's
   goldens identical to the reference binary's lists and, on the timed
   loop's first whole batch decoded again, every k-th block step and the
   first that mixes active and inactive reads bit-equal to the plain
   version, every row sorted, every read's lists those the timed loop
   gave; one K1 launch per forward block step of its warm-up and timed
   loop.
15. the traceback kernel (``csrc/lva_traceback.cu``) against the plain
   loop (``lva_decode.traceback_ref``) on the card at the benchmark cells'
   shapes, ``TRACEBACK_CELLS`` (experiment 7: B=24 L=8 m=11; experiment 0:
   B=16 L=64 m=8): one batch of forward reads decoded with the traceback
   replaced by both on the same forward outputs, words and ``okend``
   bit-equal, one launch counted; both timed by CUDA events, beside the
   kernel's bound (the bytes it needs, and the longest chain's steps times
   a device-memory round trip, measured first by a pointer chase over
   1 GiB; beside it the floor at the round trip of a chase the L2 holds)
   and its registers; fails if the kernel uses local memory.

Every entry of the kernels line has its bound: the larger of the bytes
the function must move over the memory rate and its operations over the
card's peak for their type (``bound``); the P1 and P8 entries have the
launch floor beside it (``launch_floor_ms``).

Before the last lines come ``{"lva_acs": {...}}`` (the ACS kernel's
times at B=1 and B=4, each bucket's registers, local bytes and resident
threads per SM, its bound and its share of it), ``{"lva_acs_lse": {...}}`` (the
same for the logsumexp kernel, its bound's three terms and the lse path's
s/read), ``{"roofline": {...}}``,
``{"lowering": {...}}`` (the launch floor, the fori rates, kernel info
and times by lane count, and P7's times), ``{"basecall": {...}}`` (phase
8's errors against the CPU, each stage's seconds, device operations,
device time, idle share and peak memory, the decode's),
``{"parallel": {...}}`` (phase 9: each leg's wall seconds and s/read,
each rank's K1 launches against its block steps, process start, group
start and job seconds and peak memory, the classification's times and
device operations), ``{"real_data": {...}}`` (phase 10: the ok share,
the basecall's, the barcode search's, the decode's and each command's
seconds, K1 launches against block steps, the raw-signal leg, the vocab
times, whether the native library was built), ``{"train": {...}}``
(phase 11: the card's loss and gradient errors against the CPU's, s/step,
device operations, device time, idle share and peak memory of a train
step, the losses, and each of 11b-11d's seconds, stats and K1 launches),
``{"reports": {...}}`` (phase 12: each part's seconds, s/read, K1
launches against block steps, peak memory and record),
``{"list_sizes": {...}}`` (phase 13: each cell's kernel info, K1's times,
bounds and shares at both B, the forward and traceback seconds, and
``sim-decode``'s seconds, s/read, launches and peak memory),
``{"bench": {...}}`` (phase 14: each run's JSON line, seconds and K1
launches), ``{"traceback": {...}}`` (phase 15: each cell's kernel and
plain times, steps, bound and kernel info), the card's
name and power limit, and ``{"kernels": [...]}`` (K1's entry adds phase
9's launches as ``parallel_launches``, phase 10's as
``real_data_launches``, phase 11's as ``train_launches``, phase 12's as
``reports_launches``, phase 13's as ``list_sizes_launches`` and phase
14's timed runs' as ``bench_launches``, and each
bucket's build as ``resources``); the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or away from the
package, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

try:
    from nanopore_dna_storage_tpu_torch import bench, cli
    from nanopore_dna_storage_tpu_torch.coding.framing import (
        check_and_extract, frame_oligos)
    from nanopore_dna_storage_tpu_torch.config import (ConvCodeConfig,
                                                       DecodeConfig,
                                                       ExperimentConfig)
    from nanopore_dna_storage_tpu_torch.io.post import (pack_posts, read_post,
                                                        write_post)
    from nanopore_dna_storage_tpu_torch.models.flipflop import (
        FlipflopConfig, FlipflopNet, f32_matmul, init_params)
    from nanopore_dna_storage_tpu_torch.models import train as trainmod
    from nanopore_dna_storage_tpu_torch import native
    from nanopore_dna_storage_tpu_torch.coding.conv import (make_conv_code,
                                                            str_to_bases)
    from nanopore_dna_storage_tpu_torch.coding.crc import crc8_batch
    from nanopore_dna_storage_tpu_torch.ops.crf_decode import (
        basecall_from_path, viterbi_flipflop_batch)
    from nanopore_dna_storage_tpu_torch.ops.fwdbwd import \
        batched_transition_posteriors
    from nanopore_dna_storage_tpu_torch.ops import _build, lva_acs, lva_decode
    from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
    from nanopore_dna_storage_tpu_torch.ops.lva_consts import sel_format
    from nanopore_dna_storage_tpu_torch.ops.synthetic import synthetic_post
    from nanopore_dna_storage_tpu_torch.ops.vocab import decode_post_vocab
    from nanopore_dna_storage_tpu_torch.parallel import launch, multihost
    from nanopore_dna_storage_tpu_torch.parallel.mesh import ShardedDecoder
    from nanopore_dna_storage_tpu_torch.pipeline import (encode_bytes,
                                                         experiment)
    from nanopore_dna_storage_tpu_torch.pipeline.decode import (
        PipelineDecoder, majority_vote, recover_file)
    from nanopore_dna_storage_tpu_torch.pipeline.basecall import (
        Basecaller, write_fastq)
    from nanopore_dna_storage_tpu_torch.pipeline.real_data import (
        decode_posts_with_barcodes, locate_payload)
    from nanopore_dna_storage_tpu_torch.profile_decode import Probe
    from nanopore_dna_storage_tpu_torch.pipeline.simulate import (
        signal_batch, simulate_and_decode_signal, simulate_posts,
        simulate_posts_signal, simulate_raw_reads)
    from nanopore_dna_storage_tpu_torch.probes import (expand, lowering,
                                                       merge_roofline,
                                                       mxu_expand, treepop)
    from nanopore_dna_storage_tpu_torch.reports import (basecall_error,
                                                        file_recovery,
                                                        read_cost,
                                                        signal_fidelity)
    from nanopore_dna_storage_tpu_torch.signal.barcode import \
        levenshtein_windows
    from nanopore_dna_storage_tpu_torch.signal.channel import \
        simulate_indelsubs
    from nanopore_dna_storage_tpu_torch.utils import profiling
except ImportError as e:
    sys.exit(f"chip_smoke: FAIL: the port package is not beside this "
             f"script: {e}")

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
# the reference binary's golden lists: plain, with sync markers, and m=14
GOLDEN_SETS = ("decode", "sync", "decode14")
SEED = 0
LSE = "logsumexp"
# phase 7c checks every 16th block against the plain version, which at
# full width takes ~0.1-0.3 s a block step
LSE_CHECK_EVERY = 16
# phase 7b: the lse kernel's L <= 8 bucket below its full list size, and
# its L <= 16 lane bucket with dead slots; that bucket timed at L =
# LSE_LANES_L on one read and on LSE_LANES_B reads
LSE_LIST_SIZES = (3, 5, 12)
LSE_LANES_L, LSE_LANES_B = 12, 4
# phase 7e: the lse path at experiment 0 (m=8 r=1/2, C=256), each cell (list
# size, the B timed beside B=1, the decode's batch and reads): L = 64, the
# paper's m=8 list size (the L <= 64 lane bucket), and L = 16, Table 2's
# best m=8 reading cost (the L <= 16 bucket at its full size); each read
# keeps its selections for the whole decode (~3.9 GB at L = 64). The reads
# are phase 13's: 24 sample 11 of the file's 13 oligos
LSE_PATH_CELLS = ((64, 4, 4, 24), (16, 4, 4, 24))
# phase 8: reads of experiment 7 through the basecaller chain at the
# published widths, decoded in batches as phase 3 decodes (each read's
# selections take ~2.7 GB at ~520 blocks)
CHAIN_READS = 32
CHAIN_BATCH = 8
# phase 15: the traceback at the benchmark cells' shapes (experiment, list
# size, reads a batch), the kernel timed over TRACEBACK_REPS launches; a
# chain's step is one dependent device-memory load, timed for the latency
# floor by ROUND_TRIP_HOPS hops of a chase over ROUND_TRIP_BYTES, some 20
# times the L2's 50 MB, and beside it over ROUND_TRIP_L2_BYTES, which the
# L2 holds and each SM's 256 KB L1 does not
TRACEBACK_CELLS = ((7, 8, 24), (0, 64, 16))
TRACEBACK_REPS = 20
ROUND_TRIP_BYTES = 1 << 30
ROUND_TRIP_L2_BYTES = 8 << 20
ROUND_TRIP_HOPS = 100_000
# phase 8b: the card's transitions and posteriors against the CPU's,
# absolute and relative: the same float32 chain, its products summed in
# another order by cuBLAS and by the CPU's BLAS, through five recurrent
# layers of ~520 steps (the CPU against the JAX package: 2.4e-6)
CHAIN_TOL = 1e-4
# phase 9: reads of phase 3's file as .post files, decoded by the
# scale-out job PARALLEL_BATCH a step (each read's selections take ~2.1 GB
# on the card); 24 sample each of the file's 6 oligos
PARALLEL_READS = 24
PARALLEL_BATCH = 8
# phase 10: barcoded reads of experiment 7 (half of them reverse
# complement) through decode-posts, REAL_BATCH reads a decode (each read's
# selections take ~2.1 GB on the card); 8 raw-signal reads through the
# basecaller; the larger vocabulary case: 16 ten-mers, a message of 20.
# 32 reads sample each of the file's 6 oligos at least twice
REAL_READS = 32
REAL_BATCH = 16
RAW_READS = 8
VOCAB_WORDS, VOCAB_WORD_LEN, VOCAB_MSG_LEN = 16, 10, 20
# phase 11a: the trainer at the published widths on the production recipe
# (tests/test_signal_fidelity_production.py:45-47): kmer 6, 8 reads of 60
# bases a step (720 samples, 360 blocks), Adam at 3e-3 with warm-up and
# cosine; TRAIN_STEPS steps on the card, one of them profiled
TRAIN_STEPS = 12
TRAIN_BATCH, TRAIN_SEQ_LEN, TRAIN_LR, TRAIN_KMER = 8, 60, 3e-3, 6
# 11a: the card's loss and gradients against the CPU's on the same weights
# and batch, under the caller's "high" (TF32) setting, which the trainer
# must override: the loss relative, each parameter's gradient within
# TRAIN_GRAD_TOL of its largest component (the same float32 chain summed
# in another order by cuBLAS and the CPU's BLAS, forward and backward
# through five recurrent layers of 360 steps; TF32 would miss it by ~1e-3)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# phase 11b: tests/test_signal_fidelity.py:21-35 on the card, and its floor
FIDELITY_EXP = dict(bytes_per_oligo=4, rs_redundancy=0.5, conv_mem=6,
                    conv_rate=1)
FIDELITY_READS, FIDELITY_STEPS = 24, 300
# phase 11c: experiment-7 reads through 11b's trained basecaller, decoded
# 8 reads a batch (each read's selections take ~2.1 GB on the card)
TRAINED_READS, TRAINED_BATCH = 16, 8
# phase 11d: the simulate-signal command, at 11b's code and a short training
SIGNAL_CLI_ARGS = ["--bytes-per-oligo", "4", "--rs-redundancy", "0.5",
                   "--mem", "6", "--rate", "1", "--num-reads", "8",
                   "--train-steps", "10"]
SIGNAL_CLI_KEYS = ["num_reads", "crc_pass", "list_correct", "top_correct",
                   "unique_indices"]
# phase 12: the report layer at experiment 7 on a 600-byte file (30 data
# and 9 RS oligos), REPORT_READS reads decoded REPORT_BATCH a chunk (each
# read's selections take ~2.1 GB on the card); the sweep every REPORT_STEP
# reads, REPORT_TRIALS trials a count; the basecaller at the fidelity
# report's widths and recipe for PROBE_STEPS steps, PROBE_EVAL_READS
# held-out reads of PROBE_EVAL_LEN bases; FIDELITY_REPORT_READS reads of
# experiment 7 through it
REPORT_FILE_SIZE = 600
REPORT_READS, REPORT_BATCH = 160, 16
REPORT_STEP, REPORT_TRIALS = 40, 3
PROBE_STEPS, PROBE_EVAL_READS, PROBE_EVAL_LEN = 20, 8, 120
FIDELITY_REPORT_READS = 8
# 12c: the card's held-out edit distances against the CPU's on the same
# trained net, in bases over all reads: the same float32 network summed in
# another order may move a Viterbi path where two scores nearly tie
PROBE_EDIT_TOL = 0.01
# every kernel library and its sources in csrc/
LIBS = {"lva_acs": ["lva_acs.cu"], "lva_lse": ["lva_lse.cu"],
        "lva_traceback": ["lva_traceback.cu"],
        "probes": ["probes.cu"], "expand": ["expand.cu"],
        "mxu_expand": ["mxu_expand.cu"], "lowering": ["lowering.cu"]}
CSRC = "nanopore_dna_storage_tpu_torch/csrc"
PROBE_SOURCE = f"{CSRC}/probes.cu"
# H100 SXM peaks from NVIDIA's data sheet (dense, 700 W): device
# memory (``merge_roofline``'s), and the tensor cores in operations
# (2 per MAC) per second by operand type; u8x4 runs on the int8 rate
HBM_BYTES_PER_S = merge_roofline.HBM_BYTES_PER_S
TC_OPS_PER_S = {"tf32": 495e12, "bf16": 989e12, "u8x4": 1979e12}
# phase 5: the shuffle form checked at every k it takes and at columns
# that end in a partial warp (96, 2080); the transpose at shapes of each
# tile height and both paths ((shape, x aligned to 16 bytes))
SHFL_KS = (1, 2, 4, 8, 16, 32)
SHFL_COUTS = (1024, 2048, 96, 2080)
TRANSPOSE_SHAPES = (((16, 128), True), ((128, 16), True), ((17, 45), True),
                    ((33, 100), True), ((1, 1), True), ((8, 64), True),
                    ((4, 4), True), ((6, 30), True), ((13, 50), True),
                    ((16, 128), False))
# phase 13: the paper's other list sizes, each cell (experiment, list size,
# the B timed beside B=1, sim-decode's batch and reads): experiment 0 (m=8
# r=1/2, msg_len 100, C = 256) at L = 64, K1's L <= 64 bucket, and
# experiment 8 (m=14 r=5/6, msg_len 181, C = 16384) at L = 4, the L <= 8
# bucket at the largest C. Each read keeps its selections for the whole
# decode: ~3.9 GB at the first, ~9 GB at the second, which sizes the
# batches. The reads are the fewest that cover enough of the file's
# oligos for RS to recover it (experiment 0: 10 data and 3 RS oligos, of
# which 16 reads sample 8, 24 sample 11; experiment 8: 5 and 1, 16 reads
# sample 5).
LIST_SIZE_CELLS = ((0, 64, 4, 4, 24), (8, 4, 2, 2, 16))
# phase 14: the decode benchmark's command lines, each run with --verify,
# as many reads as one batch so that no slot is padding; gate (b) decodes
# that batch again with the plain version on every k-th block step (m=14
# ~0.1 s a block a read)
BENCH_RUNS = (["--smoke"],
              ["--config", "m11", "--batch", "16", "--reads", "16"],
              ["--config", "m14best", "--batch", "4", "--reads", "4"])
# phase 4: the tree pop's CT past launch latency: [64, 8, 32768], 128 MiB
# of inputs
TREEPOP_LARGE = 32768
# phase 5: copies of the lane map's [8, 2048] and the transpose's [16, 128]
# timed past launch latency (calls timed, after 2 warm-ups): both write
# 268 MB
LANE_COPIES = 4096
TRANSPOSE_COPIES = 32768
COPIES_REPS = 20
# the script kernel each one-hot mode stands in for (f32 DEFAULT, bf16,
# HIGHEST)
REPLACES_MXU = {"tf32": "scripts/tpu_mxu_probe2.py:33",
                "bf16": "scripts/tpu_mxu_probe2.py:33",
                "u8x4": "scripts/tpu_mxu_expand_probe.py:53"}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def same_bufs(got, want) -> float:
    """Fails unless scores, hashes and -inf positions are bit-equal (the
    message gives the largest score difference in units in the last place);
    returns the max |score difference| over finite scores."""
    fin = torch.isfinite(want[0])
    if not torch.equal(torch.isfinite(got[0]), fin):
        fail("kernel and its plain version disagree on which scores are "
             "-inf")
    err = float((got[0][fin] - want[0][fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    for x, y in zip(got, want):
        if not torch.equal(x, y):
            ulps = int((got[0][fin].view(torch.int32).long()
                        - want[0][fin].view(torch.int32).long()).abs().max()) \
                if bool(fin.any()) else 0
            fail(f"kernel buffers differ from the plain version (score error "
                 f"{err}, {ulps} ulp)")
    return err


def acs_steps(lse: bool):
    """(kernel, plain version) of the ACS step: the K-way merge under max
    combining, whose buffer rows stay sorted in slot, or the flat merge
    under logsumexp combining (``lse``), whose rows do not."""
    if lse:
        return lva_acs.acs_block_lse, lva_acs.acs_block_lse_ref
    return lva_acs.acs_block, lva_acs.acs_block_ref


def check_sorted(bufs, what: str) -> None:
    """Fails unless every (read, position, CRF state, conv state) row of the
    buffer triple ``bufs`` has scores that do not increase with the slot:
    the K-way merge's precondition."""
    sc = bufs[0]
    if not bool((sc[:, :, :, 1:] <= sc[:, :, :, :-1]).all()):
        fail(f"{what}: a buffer row's scores increase with the slot")


def phase_kernel(dec, post, tag="phase 1"):
    """Phase 1 (and 7a under logsumexp combining): the ACS kernel of
    decoder ``dec`` against its plain version on one read; under max
    combining the rows are also held sorted. Returns the kernel's and the
    plain version's ms at the timed block, the max |score error| and the
    timed block's window start (padded row)."""
    spec, tabs, dev = dec.spec, dec.tabs, dec.device
    kern, ref = acs_steps(spec.combine_lse)
    sorted_rows = not spec.combine_lse
    T = post.shape[0]
    L, C, W = spec.list_size, spec.code.nstate_conv, spec.window
    log(f"{tag}: m={spec.code.mem} L={L}: C={C} W={W} "
        f"P={spec.npos_pad} T={T} rc={spec.code.config.rc} "
        f"{'logsumexp' if spec.combine_lse else 'max'} combining")
    starts = dec.schedule(np.array([T]), T)[0]
    postf = torch.from_numpy(post.reshape(1, T, 40)).to(dev)
    stay = postf[:, :, tabs["stay_idx"]]
    move = postf[:, :, tabs["move_idx"]]
    prev, stale = lva_decode.init_buffers(spec, dec.consts.init_state, 1,
                                          dev)
    sel = torch.empty((1, W, 8 * L, C), dtype=sel_format(L)[0], device=dev)
    check = sorted({0, 1, 2, T // 8, T // 4, 3 * T // 8, T // 2,
                    5 * T // 8, 3 * T // 4, T - 2, T - 1})
    timed_block = T // 2
    ms = plain_ms = None
    written, err = 0, 0.0
    for t in range(T):
        args = (stay[:, t].contiguous(), move[:, t].contiguous(),
                torch.tensor([starts[t] + 1], dtype=torch.int32,
                             device=dev),
                torch.ones(1, dtype=torch.bool, device=dev))
        if t in check:
            if sorted_rows:
                check_sorted(prev, f"block {t} prev")
            st_ref = [x.clone() for x in stale]
            sel_ref = torch.empty_like(sel)
            ref(tabs, prev, st_ref, *args, sel_ref)
        if t == timed_block:
            # both steps only read prev and rewrite the same stale cells,
            # so repeating them leaves the state as one call would
            scratch = [x.clone() for x in stale]
            ms = cuda_ms(lambda: kern(tabs, prev, scratch, *args, sel),
                         reps=20, warmup=3)
            plain_ms = cuda_ms(lambda: ref(tabs, prev, scratch, *args, sel),
                               reps=3)
        kern(tabs, prev, stale, *args, sel)
        if t in check:
            if sorted_rows:
                check_sorted(stale, f"block {t} output")
            err = max(err, same_bufs(stale, st_ref))
            if not torch.equal(sel, sel_ref):
                fail(f"kernel selections differ at block {t}")
            written += int((sel >= 0).sum())
        if t == 0 and not (sel[0, 0] >= 0).any():
            fail("block 0 wrote nothing at position 0")
        prev, stale = stale, prev
    # an inactive block leaves the stale buffer alone and selects nothing
    args = (stay[:, -1].contiguous(), move[:, -1].contiguous(),
            torch.tensor([starts[-1] + 1], dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.bool, device=dev))
    before = [x.clone() for x in stale]
    st_ref = [x.clone() for x in stale]
    sel_ref = torch.empty_like(sel)
    ref(tabs, prev, st_ref, *args, sel_ref)
    kern(tabs, prev, stale, *args, sel)
    same_bufs(stale, st_ref)
    same_bufs(stale, before)
    if not (torch.equal(sel, sel_ref) and bool((sel == -1).all())):
        fail("inactive block selected something")
    torch.cuda.synchronize()
    log(f"{tag}: {len(check)} active blocks + 1 inactive bit-equal"
        f"{', rows sorted' if sorted_rows else ''} ({written} selections "
        f"written); block {timed_block}: kernel {ms:.4f} ms/block, plain "
        f"{plain_ms:.4f} ms/block")

    out = {}
    for name, acs in (("kernel", kern), ("plain version", ref)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = dec.decode(post[None], acs=acs)
        torch.cuda.synchronize()
        log(f"{tag}: whole read via the {name}: "
            f"{time.perf_counter() - t0:.3f} s/read")
    (mk, sk, vk), (mr, sr, vr) = out["kernel"], out["plain version"]
    if not (np.array_equal(mk, mr) and np.array_equal(sk, sr)
            and np.array_equal(vk, vr)):
        fail("kernel and plain version decode different lists")
    if not vk[0, 0]:
        fail("headline read decoded to an empty list")
    log(f"{tag}: lists identical; {int(vk.sum())} valid entries, "
        f"top score {sk[0, 0]:.4f}")
    return ms, plain_ms, err, int(starts[timed_block]) + 1


class CheckedACS:
    """An ACS step that runs the plain version on a copy of the stale
    buffers, then the kernel on the buffers themselves, and fails unless
    the two agree bit for bit (and, under max combining, the rows of both
    buffers are sorted), at every block whose index ``check`` accepts and
    at the first block that mixes active and inactive reads (the kernel
    alone at the others); at block ``timed`` it also times both and counts
    what the step must do: the bytes (``acs_needed_bytes``) under max
    combining; under logsumexp combining the operations and exp/log calls
    as the grouping merge needs them and as the flat merge runs them
    (``acs_lse_grouped_needed``, ``acs_lse_needed``), the two
    ``lse_bound`` takes. ``lse`` picks the kernel."""

    def __init__(self, timed: int, check=lambda t: True, lse=False,
                 inactive: int = -1):
        self.timed, self.check, self.lse = timed, check, lse
        self.inactive = inactive
        self.kern, self.ref = acs_steps(lse)
        self.blocks = self.checked = self.mixed = 0
        self.err = 0.0
        self.ms = self.plain_ms = self.timed_B = self.needed = None
        self.timed_args = None  # (start1, active) of the timed block

    def __call__(self, tabs, prev, stale, *args):
        *rest, sel = args
        active = rest[-1]
        mixed = 0 < int(active.sum()) < active.numel()
        if not (self.check(self.blocks) or self.blocks == self.timed
                or (mixed and self.mixed == 0)):
            self.kern(tabs, prev, stale, *args)
            self.blocks += 1
            return sel
        if not self.lse:
            check_sorted(prev, f"batch block {self.blocks} prev")
        if self.blocks == self.inactive:
            self.check_inactive(tabs, prev, stale, rest, sel)
        st_ref = [x.clone() for x in stale]
        sel_ref = torch.empty_like(sel)
        self.ref(tabs, prev, st_ref, *rest, sel_ref)
        if self.blocks == self.timed:
            self.timed_B = sel.shape[0]
            self.timed_args = (rest[2].tolist(), rest[3].tolist())
            self.needed = (
                tuple(count(tabs, prev, st_ref, sel_ref, *rest) for count in
                      (merge_roofline.acs_lse_grouped_needed,
                       merge_roofline.acs_lse_needed)) if self.lse else
                merge_roofline.acs_needed_bytes(tabs, prev[0], st_ref[0],
                                                sel_ref, *rest))
            # both steps only read prev and rewrite the same stale cells,
            # so repeating them leaves the state as one call would
            scratch = [x.clone() for x in stale]
            self.ms = cuda_ms(lambda: self.kern(tabs, prev, scratch, *args),
                              reps=20, warmup=3)
            self.plain_ms = cuda_ms(lambda: self.ref(tabs, prev, scratch,
                                                     *args), reps=3)
        self.kern(tabs, prev, stale, *args)
        if not self.lse:
            check_sorted(stale, f"batch block {self.blocks} output")
        self.err = max(self.err, same_bufs(stale, st_ref))
        if not torch.equal(sel, sel_ref):
            fail(f"kernel selections differ at batch block {self.blocks}")
        self.mixed += mixed
        self.blocks += 1
        self.checked += 1
        return sel

    def check_inactive(self, tabs, prev, stale, rest, sel) -> None:
        """This block's step with every read inactive, on copies: both
        steps leave the stale buffers as they were and select nothing."""
        *args, _ = rest
        args.append(torch.zeros_like(rest[-1]))
        outs = []
        for step in (self.kern, self.ref):
            st = [x.clone() for x in stale]
            out = torch.empty_like(sel)
            step(tabs, prev, st, *args, out)
            same_bufs(st, stale)
            outs.append(out)
        if not (torch.equal(*outs) and bool((outs[0] == -1).all())):
            fail(f"inactive block {self.blocks} selected something")


def phase_bucket(headline, post, L=12, tag="phase 1"):
    """Phase 1 (and 7b), last part: the kernel at list size ``L`` on one
    read, blocks at position 0, spread over the read and at its end held
    bit-equal to the plain version. At L = 12 that is the L <= 16 bucket
    (int8 selections; emitted pairs or candidates in local memory), which
    no golden reaches; under logsumexp combining also L = 3 and 5, the
    L <= 8 bucket with its slots past L the constant -inf."""
    dec = LVADecoder(dataclasses.replace(headline, list_size=L),
                     device="cuda")
    T = post.shape[0]
    blocks = {0, 1, T // 4, T // 2, 3 * T // 4, T - 1}
    check = CheckedACS(timed=-1, check=blocks.__contains__,
                       lse=dec.spec.combine_lse)
    _, _, valid = dec.decode(post[None], acs=check)
    if check.checked != len(blocks) or not valid[0, 0]:
        fail(f"L = {L}: {check.checked} of {len(blocks)} blocks checked, "
             f"top entry valid: {bool(valid[0, 0])}")
    log(f"{tag}: L = {L}: blocks {sorted(blocks)} of {T} bit-equal"
        f"{'' if check.lse else ', rows sorted'}; {int(valid.sum())} valid "
        f"entries")


def phase_batch(enc, exp, device, path_combine="max", every=1,
                tag="phase 1b"):
    """Phase 1b (and 7c): the kernel against its plain version at the main
    path's shapes. The reads are phase 3's first batch (same seed and
    channel) through ``PipelineDecoder.decode_posts``, which splits them by
    orientation, so each launch holds several reads of different lengths,
    each with its own beam start, some of them past their end. Every
    ``every``-th block of both decodes is checked, and the first that
    mixes active and inactive reads. Returns (B, kernel ms, plain ms) of
    the timed block, its (start1, active), what its step must do
    (``CheckedACS.needed``), and the max |score error|."""
    posts, rcs, _ = simulate_posts(enc.oligos, 8,
                                   np.random.default_rng(SEED))
    for flag in (False, True):
        log(f"{tag}: rc={flag}: nblk "
            f"{[len(p) for p, r in zip(posts, rcs) if r == flag]}")
    check = CheckedACS(timed=min(map(len, posts)) // 2,
                       check=lambda t: t % every == 0,
                       lse=path_combine == LSE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = PipelineDecoder(exp, 8, 20, path_combine=path_combine,
                          device="cuda").decode_posts(
        posts, rcs, enc.num_oligos_data + enc.num_oligos_rs, acs=check)
    log(f"{tag}: {check.checked} of {check.blocks} blocks bit-equal"
        f"{'' if check.lse else ', rows sorted'}, {check.mixed} of them "
        f"with active and inactive reads ({time.perf_counter() - t0:.1f} s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB); {int((out.index >= 0).sum())} of {len(posts)} reads pass "
        f"CRC; block {check.timed} at B={check.timed_B}: kernel "
        f"{check.ms:.4f} ms/block, plain {check.plain_ms:.4f} ms/block")
    if check.mixed == 0:
        fail("no checked block mixed active and inactive reads")
    return (check.timed_B, check.ms, check.plain_ms), check.timed_args, \
        check.needed, check.err


def acs_bound(dec, start1, active, nbytes: int) -> dict:
    """The bound of one ACS block step whose reads have window starts
    ``start1`` and flags ``active``: the ``nbytes`` it must move on its
    inputs (``acs_needed_bytes``) over the memory rate, against its
    operations over the FP32 lane peak, counted over the valid states and
    real merge rows of each active read as the K-way merge needs them
    (``acs_needed_ops``). Beside it, for reference, two counts that do not
    depend on the data: every slot of the W + 1 previous rows read and the
    W rows written (``bytes_every_slot``), and the operations of a flat
    scan over every candidate (``acs_executed_ops``)."""
    spec, tabs = dec.spec, dec.tabs
    L, C, W = spec.list_size, spec.code.nstate_conv, spec.window
    rows = (1 + (tabs["qmap"][:, 1:] >= 0).sum(1)).tolist()
    windows = [tabs["valid"][s:s + W] != 0
               for s, a in zip(start1, active) if a]
    needed = sum(merge_roofline.acs_needed_ops(spec, rows, v)
                 for v in windows)
    flat = sum(merge_roofline.acs_executed_ops(spec, rows, v)
               for v in windows)
    cells = 8 * L * C
    every = sum(active) * (2 * W + 1) * cells * 12 + len(start1) * W * cells
    peak, _ = merge_roofline.lane_peak()
    bound_ms, bound_by = bound(nbytes, needed, peak)
    return {"bytes": nbytes, "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "needed_ops": needed, "needed_ops_ms": 1e3 * needed / peak,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_every_slot": every,
            "bytes_every_slot_ms": 1e3 * every / HBM_BYTES_PER_S,
            "flat_ops": flat, "flat_ops_ms": 1e3 * flat / peak}


def acs_resources(lse: bool = False, L: int = 8) -> dict:
    """The list-size ``L`` build of the ACS kernel (the lse kernel with
    ``lse``) on the card: registers, local bytes (stack frame and spills)
    and resident threads per SM. Fails if it uses local memory."""
    info = (lva_acs.lse_kernel_info if lse else lva_acs.kernel_info)(L)
    if info["local_bytes"]:
        fail(f"the {'lse ' if lse else ''}ACS kernel at L = {L} uses local "
             f"memory: {info}")
    return info


def phase_goldens(device):
    """Phase 2: the reference binary's golden lists of every set in
    ``GOLDEN_SETS`` through the K-way kernel, with sync markers where a case
    has them, each list bit-identical. Returns the number of cases."""
    n = 0
    for name in GOLDEN_SETS:
        root = GOLDEN / name
        torch.cuda.reset_peak_memory_stats()
        for case in json.loads((root / "manifest.json").read_text()):
            cfg = DecodeConfig(
                code=ConvCodeConfig(
                    mem=case["mem"], rate=case["rate"],
                    msg_len=case["msg_len"], rc=case["rc"],
                    sync_marker=case.get("sync_marker", ""),
                    sync_period=case.get("sync_period", 0)),
                list_size=case["list_size"],
                max_deviation=case["max_deviation"])
            post = np.fromfile(root / f"{case['name']}.post",
                               dtype="<f4").reshape(-1, 5, 8)
            t0 = time.perf_counter()
            msgs, _, valid = LVADecoder(cfg, device="cuda").decode(
                post[None])
            got = ["".join(map(str, m))
                   for m, v in zip(msgs[0], valid[0]) if v]
            want = (root / f"{case['name']}.lists").read_text().split()
            log(f"phase 2: {name}/{case['name']}: T={post.shape[0]} "
                f"{'identical' if got == want else 'DIFFERENT'} "
                f"({time.perf_counter() - t0:.3f} s)")
            if got != want:
                fail(f"golden {name}/{case['name']} differs from the "
                     f"reference lists")
            n += 1
        log(f"phase 2: {name}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return n


def phase_sim_decode(data: bytes, args, tag="phase 3"):
    """Phase 3 (and 13): the port's ``sim-decode`` CLI in-process on
    ``data``, its CUDA ``LVADecoder.decode_device`` calls counted; fails
    unless the traceback kernel launched once for each. Returns (its JSON
    record, SimStats, K1 launches, seconds, traceback launches)."""
    real = LVADecoder.decode_device
    decodes = []

    def counted(dec, *a, **k):
        decodes.append(dec.device.type)
        return real(dec, *a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        f = pathlib.Path(tmp) / "data.bin"
        f.write_bytes(data)
        argv = ["sim-decode", "-i", str(f), *args]
        log(f"{tag}: cli " + " ".join(args))
        torch.cuda.synchronize()
        k1_base = profiling.counter("acs.launches")
        tb_base = profiling.counter("traceback.launches")
        LVADecoder.decode_device = counted
        t0 = time.perf_counter()
        try:
            rec, stats = cli.main(argv)
            torch.cuda.synchronize()
        finally:
            LVADecoder.decode_device = real
        wall = time.perf_counter() - t0
        launches = profiling.counter("acs.launches") - k1_base
        tb_launches = profiling.counter("traceback.launches") - tb_base
    cuda_decodes = decodes.count("cuda")
    log(f"{tag}: {wall:.3f} s for {stats.num_reads} reads = "
        f"{wall / stats.num_reads:.4f} s/read; {launches} kernel launches "
        f"for {stats.steps} forward block steps; {tb_launches} traceback "
        f"launches for {cuda_decodes} CUDA decodes")
    if not (rec["recovered"] and rec["byte_exact"]):
        fail(f"{tag}: sim-decode did not recover the file: {rec}")
    if cuda_decodes == 0 or tb_launches != cuda_decodes:
        fail(f"{tag}: {tb_launches} traceback launches for {cuda_decodes} "
             f"CUDA decodes")
    return rec, stats, launches, wall, tb_launches


def build_kernels() -> None:
    """Phase 0: every library of ``LIBS``, one nvcc per source, started
    together; logs each build's time and its ptxas resource lines."""
    def one(name):
        t0 = time.perf_counter()
        return _build.build(name, LIBS[name]), time.perf_counter() - t0

    with ThreadPoolExecutor(len(LIBS)) as ex:
        built = list(ex.map(one, LIBS))
    for path, sec in built:
        log(f"phase 0: built {path.name} in {sec:.2f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    _build.load_lva_acs()
    _build.load_lva_lse()
    _build.load_lva_traceback()
    _build.load_probes()
    _build.load_expand()
    _build.load_mxu_expand()
    _build.load_lowering()


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``ops`` operations at a peak of ``ops_per_s``."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def same_bits(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Fails unless ``got`` and ``want`` are bit-equal; returns the max
    |difference| over finite values (0.0 when they are)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {got.dtype}{tuple(got.shape)} against "
             f"{want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.float32:
        fin = torch.isfinite(want) & torch.isfinite(got)
        err = float((got[fin] - want[fin]).abs().max()) \
            if bool(fin.any()) else 0.0
        got, want = got.view(torch.int32), want.view(torch.int32)
    else:
        err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"{name}: kernel and plain version differ (max |error| {err})")
    return err


def probe_inputs(rng, shape, scores="normal", hashes="random"):
    """Scores f32 and two int32 hash arrays of ``shape`` on the card."""
    if scores == "normal":
        x = rng.normal(size=shape).astype(np.float32)
    else:  # integer scores in {0, 1, 2}, some columns all -inf: ties
        x = rng.integers(0, 3, shape).astype(np.float32)
        x[:, 0, :4] = -np.inf
    if hashes == "random":
        h = [rng.integers(0, 1 << 30, shape, dtype=np.int64).astype(np.int32)
             for _ in range(2)]
    else:  # a permutation, so every payload is unique
        h = [rng.permutation(x.size).astype(np.int32).reshape(shape)] * 2
    return [torch.from_numpy(a).cuda() for a in (x, *h)]


def probe_cases(rng, nc, f, ct):
    """Phase 4's extra inputs for merge and stream, as (name, x, h1, h2,
    copies): the few hashes (six classes: whole classes knocked out, all
    -inf columns), integer tie scores with all -inf columns, nc of 1 and
    33, a column count (111) that no block or vector width divides, tensors
    4 bytes past an 8-byte boundary (the stream's generic kernel), and 1
    and 3 copies."""
    x, h1, h2 = probe_inputs(rng, (nc, f, ct))
    xt, t1, t2 = probe_inputs(rng, (nc, f, ct), scores="ties")
    few = [torch.from_numpy(rng.integers(0, k, (nc, f, ct)).astype(np.int32))
           .cuda() for k in (3, 2)]
    xo, o1, o2 = probe_inputs(rng, (nc, 3, 37))
    shifted = []
    for t in (x, h1, h2):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        shifted.append(buf[1:].view(t.shape))
        shifted[-1].copy_(t)
    return [("few hashes", x, *few, 256), ("tie scores", xt, t1, t2, 256),
            ("tie scores, few hashes", xt, *few, 3),
            ("nc=1", x[:1].contiguous(), h1[:1].contiguous(),
             h2[:1].contiguous(), 3),
            ("nc=33", x[:33].contiguous(), h1[:33].contiguous(),
             h2[:33].contiguous(), 256),
            ("111 columns", xo, o1, o2, 3), ("unaligned", *shifted, 3),
            ("1 copy", x, h1, h2, 1)]


def check_probe(name, kern, ref, x, h1, h2, rounds, copies):
    """Fails unless every copy of ``kern`` equals ``ref`` on one copy, bit
    for bit; returns the max |error|."""
    got = kern(x, h1, h2, rounds, copies)
    want = ref(x, h1, h2, rounds)
    return same_bits(name, got, want.expand_as(got))


def phase_probes(dec, acs_ms: float, acs_start1: int, floor_us: float):
    """Phase 4: the merge-family probes. Each kernel against its plain
    version on the card, bit for bit, and both timed; merge and stream also
    on ``probe_cases`` at 8 rounds and at 3 (the stream's generic kernel),
    with their registers, local bytes and threads per SM (fails if the
    merge kernel uses local memory); then the probes' entry points as a
    user runs them, with the launch counts set to 0 just before and read
    just after, which also measure the issue rate of each instruction kind
    and each kernel's pipe floor from its SASS. The tree pop is checked and
    timed by ``phase_treepop``. ``acs_ms`` is phase 1's ACS block step at
    B=1 through decoder ``dec``, its window starting at padded row
    ``acs_start1``: K1's rate in the probes' unit, in the ops the K-way
    merge needs; ``floor_us`` is the launch floor (``launch_floor_us``).
    Returns the kernels' JSON entries, the roofline and the probes' line."""
    mr = merge_roofline
    nc, f, ct = mr.NC, mr.F, mr.CT
    G, R = 256, 8
    rng = np.random.default_rng(SEED)
    x, h1, h2 = probe_inputs(rng, (nc, f, ct))
    cases = probe_cases(rng, nc, f, ct)
    found = {}
    for kind in ("merge", "stream"):
        kern = getattr(mr, kind)
        ref = getattr(mr, f"{kind}_ref")

        def plain(a, b, c):
            return ref(*(t.expand(G, *t.shape) for t in (a, b, c)), R)

        err = 0.0
        for b, c, what in ((h1, h1, "h1 = h2"), (h1, h2, "h1 != h2")):
            got = kern(x, b, c, R, G)
            err = max(err, same_bits(f"{kind} ({what})", got, plain(x, b, c)))
            same_bits(f"{kind} copies ({what})", got, got[:1].expand_as(got))
        for name, *args, copies in cases:
            for rounds in (R, 3):
                err = max(err, check_probe(f"{kind} {name} r={rounds}", kern,
                                           ref, *args, rounds, copies))
        ms = cuda_ms(lambda: kern(x, h1, h2, R, G), reps=20, warmup=2)
        plain_ms = cuda_ms(lambda: plain(x, h1, h2), reps=3)
        log(f"phase 4: {kind} [{nc},{f},{ct}] x {G} copies, {R} rounds: "
            f"bit-equal, all copies equal, and on {len(cases)} more inputs "
            f"at {R} and 3 rounds; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        found[kind] = (err, ms, plain_ms)

    info = {"merge": mr.merge_info(), "stream": mr.stream_info(),
            "stream_rounds_loop": mr.stream_info(unrolled=False)}
    log(f"phase 4: kernel info: {json.dumps(info)}")
    if info["merge"]["local_bytes"]:
        fail(f"the merge kernel uses local memory: {info['merge']}")

    tree, tree_info = phase_treepop(rng, f)
    info["treepop"] = tree_info
    found["treepop"] = (tree["err"], tree["ms"], tree["plain_ms"])

    torch.cuda.synchronize()
    for k in merge_roofline.LAUNCHES:
        merge_roofline.LAUNCHES[k] = 0
    treepop.LAUNCHES = 0
    roof = merge_roofline.main(["--rounds", str(R), "--grid", str(G)])
    ok = treepop.main([*treepop.VARIANTS, "--when", "128", "--when", "512"])
    torch.cuda.synchronize()
    launches = {**merge_roofline.LAUNCHES, "treepop": treepop.LAUNCHES}
    log(f"phase 4: probe entry points launched {launches}")
    if not ok:
        fail("a tree-pop variant disagrees with numpy's first argmax")
    if not all(launches.values()):
        fail(f"a probe kernel was not launched by its entry point: "
             f"{launches}")
    rates = roof["issue_rates"]
    floor_ms = {k: 1e3 * roof[k]["pipe_floor"]["floor_s"]
                for k in ("merge", "stream")}
    for k in ("merge", "stream"):
        fl = roof[k]["pipe_floor"]
        log(f"phase 4: {k} pipe floor {floor_ms[k]:.4f} ms by {fl['by']} "
            f"({json.dumps(fl['terms_s'])}); the kernel's {found[k][1]:.4f} "
            f"ms reaches {100 * floor_ms[k] / found[k][1]:.1f}% of it")
    probes_line = {
        "issue_rates_per_sm_clk": {k: r["per_sm_clk"]
                                   for k, r in rates.items()},
        "issue_bodies": {k: r["body"] for k, r in rates.items()},
        "info": info,
        **{f"{k}_pipe_floor": roof[k]["pipe_floor"]
           for k in ("merge", "stream")},
        **{f"{k}_share_of_pipe_floor": floor_ms[k] / found[k][1]
           for k in ("merge", "stream")}}

    peak, formula = merge_roofline.lane_peak()
    spec, tabs = dec.spec, dec.tabs
    # K1's work three ways: bench.py's count with flop rows padded to 8,
    # what a flat scan executes over valid states and real merge rows, and
    # what the K-way merge needs; only the last is a rate of this kernel
    valid = tabs["valid"][acs_start1:acs_start1 + spec.window] != 0
    rows = (1 + (tabs["qmap"][:, 1:] >= 0).sum(1)).tolist()
    needed = merge_roofline.acs_needed_ops(spec, rows, valid)
    need_rate = needed / (acs_ms / 1e3)
    rate = {k: roof[k]["ops_per_s_T"] * 1e12 for k in ("merge", "stream")}
    roofline = {
        "lane_peak_ops_per_s": peak,
        "lane_peak_formula": formula,
        "merge_ops_per_s": rate["merge"],
        "merge_share_of_lane_peak": rate["merge"] / peak,
        "stream_ops_per_s": rate["stream"],
        "stream_share_of_lane_peak": rate["stream"] / peak,
        "acs_ms_per_block_step": acs_ms,
        "acs_valid_share_of_window": float(valid.float().mean()),
        "acs_merge_rows_per_crf_state": rows,
        "acs_work_ops_per_block_step": merge_roofline.acs_work_ops(spec, 1),
        "acs_flat_ops_per_block_step": merge_roofline.acs_executed_ops(
            spec, rows, valid),
        "acs_needed_ops_per_block_step": needed,
        "acs_needed_ops_per_s": need_rate,
        "acs_needed_share_of_lane_peak": need_rate / peak,
    }
    replaces = {"merge": "scripts/tpu_vpu_roofline.py:48",
                "stream": "scripts/tpu_vpu_roofline.py:68",
                "treepop": "scripts/tpu_treepop_probe.py:19"}
    # merge and stream: 12 element-ops per element and round over the G
    # copies, reading scores and two hashes once and writing G slots;
    # tree-pop: 63 pair steps (a compare, two selects) per column, reading
    # [NC, F, CT] scores and payloads and writing one of each per column
    cols = f * ct
    work = {k: (G * R * merge_roofline.MERGE_SWEEPS * nc * cols,
                3 * 4 * nc * cols + 4 * G * cols)
            for k in ("merge", "stream")}
    work["treepop"] = treepop_work((nc, f, treepop.CT))
    entries = []
    for k, (err, ms, plain_ms) in found.items():
        ops, nbytes = work[k]
        bound_ms, bound_by = bound(nbytes, ops, peak)
        entries.append({
            "name": f"probe_{k}", "route": "cuda", "source": PROBE_SOURCE,
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no one PyTorch call computes a merge with dual-hash knockout,
            # the stream's op chain or a max with the winner's payload
            "library_ms": None,
            **({"pipe_floor_ms": floor_ms[k]} if k in floor_ms else
               {"launch_floor_ms": floor_us / 1e3,
                **{k2: v for k2, v in tree.items()
                   if k2 not in ("err", "ms", "plain_ms")}})})
    return entries, roofline, probes_line


def treepop_work(shape):
    """(ops, bytes) of one tree pop over [NC, F, CT]: 63 pair steps (a
    compare, two selects) per column; scores and payloads read once, one of
    each written per column."""
    cols = shape[1] * shape[2]
    return (shape[0] - 1) * 3 * cols, 8 * shape[0] * cols + 8 * cols


def treepop_inputs(rng, shape, kind):
    """Scores f32 of ``kind`` and unique int32 payloads (a permutation) of
    ``shape`` on the card: ``normal``; ``ties``, integers in {0, 1, 2} with
    some columns all -inf; ``neg_inf``, every column all -inf but one
    candidate in every other column; ``zeros``, +0.0 against -0.0 at the
    top, -1 and -inf below."""
    if kind == "normal":
        x = rng.normal(size=shape).astype(np.float32)
    elif kind == "ties":
        x = rng.integers(0, 3, shape).astype(np.float32)
        x[:, 0, :4] = -np.inf
    elif kind == "neg_inf":
        x = np.full(shape, -np.inf, np.float32)
        x[rng.integers(0, shape[0], shape[1:]), np.arange(shape[1])[:, None],
          np.arange(shape[2])] = 1.0
        x[:, :, ::2] = -np.inf
    else:
        x = rng.choice(np.array([0.0, -0.0, -1.0, -np.inf], np.float32),
                       shape, p=[0.1, 0.1, 0.5, 0.3])
    h = rng.permutation(x.size).astype(np.int32).reshape(shape)
    return torch.from_numpy(x).cuda(), torch.from_numpy(h).cuda()


def check_treepop(name, a, h, variant, lanes, guarded=False) -> float:
    """Fails unless the tree pop at ``lanes`` equals ``treepop_ref`` bit for
    bit. The argmax variant's plain value is a max, which leaves the sign of
    a zero maximum to the implementation: its value is held to the first
    maximum's bits and to the plain value as a number (+0.0 == -0.0)."""
    got = treepop.treepop(a, h, variant, guarded, lanes)
    want = treepop.treepop_ref(a, h, variant, guarded)
    same_bits(f"{name} payload", got[1], want[1])
    if variant != "argmax" or guarded or not bool((want[0] == 0).any()):
        return same_bits(name, got[0], want[0])
    if not torch.equal(got[0], want[0]):
        fail(f"{name}: value differs from the plain version's")
    first = a.gather(0, a.argmax(0, keepdim=True))[0]
    return same_bits(f"{name} against the first maximum", got[0], first)


def phase_treepop(rng, f: int):
    """Phase 4, the tree pop: every variant at every lane count built and
    at the default (``auto_lanes``) bit-equal to ``treepop_ref`` at [64, F,
    CT] on normal, tie, all -inf and +0.0 / -0.0 scores with unique
    payloads, at nc 1, 33, 60 and 63 on ties, and at ``TREEPOP_LARGE``; the
    guarded form with the guard holding and failing at CT 128, 512 and
    ``TREEPOP_LARGE``; every kernel's registers, local bytes and threads
    per SM (fails on local memory). Then reshape_pair at the probe's shape
    per call from CUDA graphs, and at ``TREEPOP_LARGE`` by CUDA events, at
    every lane count and the default. Returns the kernels-line fields and
    the kernel info."""
    nc, ct = treepop.NC, treepop.CT
    lanes_all = (0, *treepop.LANES)
    err = 0.0
    for kind in ("normal", "ties", "neg_inf", "zeros"):
        a, h = treepop_inputs(rng, (nc, f, ct), kind)
        for variant in treepop.VARIANTS:
            for g in lanes_all:
                err = max(err, check_treepop(
                    f"treepop {variant} {kind} at {g} lanes", a, h, variant,
                    g))
    a, h = treepop_inputs(rng, (nc, f, ct), "ties")
    for n in (1, 33, 60, 63):
        for variant in treepop.VARIANTS:
            for g in lanes_all:
                check_treepop(f"treepop {variant} nc={n} at {g} lanes",
                              a[:n].contiguous(), h[:n].contiguous(),
                              variant, g)
    large = (nc, f, TREEPOP_LARGE)
    for c in (128, 512, TREEPOP_LARGE):
        a, h = treepop_inputs(rng, (nc, f, c), "normal")
        for holds in (True, False):
            if not holds:
                a[0, 0, 0] = 2e9
            for g in lanes_all:
                err = max(err, check_treepop(
                    f"treepop when ct={c} {'holds' if holds else 'fails'} at "
                    f"{g} lanes", a, h, "reshape_pair", g, guarded=True))
    a, h = treepop_inputs(rng, large, "ties")
    for variant in treepop.VARIANTS:
        check_treepop(f"treepop {variant} at {list(large)}", a, h, variant,
                      0)
    info = {v: {g: treepop.treepop_info(v, g) for g in treepop.LANES}
            for v in treepop.VARIANTS}
    log(f"phase 4: treepop kernel info: {json.dumps(info)}")
    bad = {(v, g): i for v, by in info.items() for g, i in by.items()
           if i["local_bytes"]}
    if bad:
        fail(f"a tree-pop kernel uses local memory: {bad}")
    log(f"phase 4: treepop {len(treepop.VARIANTS)} variants at lanes "
        f"{lanes_all} bit-equal on normal, tie, all -inf and +0.0 / -0.0 "
        f"scores, at nc 1, 33, 60, 63 and at {list(large)}; guarded at ct "
        f"128, 512 and {TREEPOP_LARGE}, the guard holding and failing")

    small = (nc, f, ct)
    a, h = treepop_inputs(rng, small, "normal")
    times = {g: graph_ms(lambda: treepop.treepop(a, h, "reshape_pair",
                                                 lanes=g))
             for g in lanes_all}
    plain_ms = graph_ms(lambda: treepop.treepop_ref(a, h, "reshape_pair"))
    a, h = treepop_inputs(rng, large, "normal")
    err_large = max(check_treepop(f"treepop reshape_pair at {list(large)} "
                                  f"at {g} lanes", a, h, "reshape_pair", g)
                    for g in lanes_all)
    large_times = {g: cuda_ms(lambda: treepop.treepop(
        a, h, "reshape_pair", lanes=g), reps=COPIES_REPS, warmup=2)
        for g in lanes_all}
    ops, nbytes = treepop_work(large)
    large_bound = bound(nbytes, ops, merge_roofline.lane_peak()[0])[0]
    auto = (treepop.auto_lanes(f * ct), treepop.auto_lanes(f * TREEPOP_LARGE))
    log(f"phase 4: treepop reshape_pair at {list(small)} (CUDA graphs), ms "
        f"by lanes (0: the default, {auto[0]}): {json.dumps(times)}, plain "
        f"{plain_ms:.6f} ms; at {list(large)} (events, {COPIES_REPS} calls "
        f"after 2), ms by lanes (0: {auto[1]}): {json.dumps(large_times)}, "
        f"bound {large_bound:.5f} ms by bytes ({nbytes} B)")
    del a, h
    torch.cuda.empty_cache()
    return {"err": err, "ms": times[0], "plain_ms": plain_ms,
            "lanes": auto[0], "ms_by_lanes": times,
            "large_shape": list(large), "large_bytes": nbytes,
            "large_max_abs_err": err_large, "large_lanes": auto[1],
            "large_ms": large_times[0],
            "large_ms_by_lanes": large_times,
            "large_bound_ms": large_bound,
            "large_share_of_bound": large_bound / large_times[0]}, info


def graph_ms(fn) -> float:
    """Device ms of one ``fn()``, replayed from a CUDA graph (launch-bound
    shapes: the host's launch cost drops out)."""
    return expand.graph_us(fn) / 1e3


def lane_map_library(case, xt):
    """One PyTorch call computing ``case``'s map on ``xt``, and the bytes
    the function must move (its sources read once, its output written
    once): the element map ``repeat_interleave`` of the first C / k
    columns, the tile map ``Tensor.repeat`` of them, the pair map
    ``repeat_interleave`` of the even columns, the row map
    ``repeat_interleave`` of the rows, the transpose ``t().contiguous()``."""
    R, C = xt.shape
    n = C // case.k
    calls = {
        "transpose": (lambda: xt.t().contiguous(), R * C),
        "element": (lambda: torch.repeat_interleave(
            xt[:, :n], case.k, dim=1, output_size=C), R * n),
        "tile": (lambda: xt[:, :n].repeat(1, case.k), R * n),
        "pair": (lambda: torch.repeat_interleave(xt[:, ::2], 2, dim=1),
                 R * C // 2),
        "row": (lambda: torch.repeat_interleave(xt, 2, dim=0), R * C)}
    call, sources = calls[case.map_]
    return call, 4 * (sources + call().numel())


def copies_library(case, xt, G: int):
    """One PyTorch call writing G copies of ``case``'s result on ``xt`` (the
    element map or the transpose; one copy kernel of a broadcast view), and
    the bytes the function must move: its sources read once, the G copies
    written once."""
    R, C = xt.shape
    if case.map_ == "transpose":
        return (lambda: xt.t()[None].expand(G, C, R).contiguous(),
                4 * (R * C + G * R * C))
    n = C // case.k
    return (lambda: xt[:, :n, None].expand(R, n, case.k)[None].expand(
        G, R, n, case.k).reshape(G, R, C)), 4 * (R * n + G * R * C)


def time_lane_map(case_name: str, form: str):
    """(kernel, plain, library) ms of one script case at its shape, all
    three from CUDA graphs, its (bound_ms, bound_by) (the function reads
    its source columns once and writes its output once), and the script's
    kernel it replaces."""
    case = next(c for c in expand.CASES if c.name == case_name)
    _, xt = case.inputs("cuda")
    kernel, plain = case.bind(xt, form)
    library, nbytes = lane_map_library(case, xt)
    same_bits(f"{case_name} library call", library(), plain())
    return (*(graph_ms(f) for f in (kernel, plain, library)),
            *bound(nbytes, 0, 1.0), case.replaces)


def onehot_library(xt, et, mode: str, G: int):
    """One PyTorch call computing ``mode``'s product over G copies, and
    whether it writes f32: the TF32 matmul; for bf16 a ``bmm`` of the bf16
    operands with f32 output (``out_dtype``), or, where this torch refuses
    that, the bf16 matmul with bf16 output, half the bytes; for u8x4 the
    full-f32 matmul, exact on a one-hot E."""
    if mode == "tf32":
        def call():
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return torch.matmul(xt.expand(G, *xt.shape), et)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return call, True
    if mode == "bf16":
        xb, eb = xt.bfloat16().expand(G, *xt.shape), et.bfloat16()
        try:
            torch.bmm(xb[:1], eb[None], out_dtype=torch.float32)
        except (TypeError, RuntimeError) as e:
            log(f"phase 5: torch.bmm refuses out_dtype=float32 for bf16 "
                f"({type(e).__name__}: {e}); the bf16 library call writes "
                f"bf16, half the bytes")
            return (lambda: torch.matmul(xb, eb)), False
        eg = eb.expand(G, *eb.shape)
        return (lambda: torch.bmm(xb, eg, out_dtype=torch.float32)), True
    xf, ef = xt.view(torch.float32), et.float()
    return (lambda: torch.matmul(xf.expand(G, *xf.shape), ef)), True


def library_resources(name: str) -> dict:
    """ptxas's stack frame, spill and register lines of library ``name``'s
    kernels (from its build log) and, from its SASS (``cuobjdump``), the
    count of Hopper warpgroup MMA (``HGMMA``) and older warp MMA
    (``HMMA``) instructions. Fails if a kernel uses a stack frame or
    spills."""
    path = _build.build(name, LIBS[name])
    text = path.with_suffix(".log").read_text()
    frames = [tuple(map(int, m)) for m in re.findall(
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
        r"spill loads", text)]
    if any(any(f) for f in frames):
        fail(f"a kernel of {name} uses a stack frame or spills: {frames}")
    sass = subprocess.run(
        [str(pathlib.Path(_build.nvcc()).with_name("cuobjdump")), "-sass",
         str(path)], capture_output=True, text=True, timeout=120,
        check=True).stdout
    return {"registers": [int(r) for r in
                          re.findall(r"Used (\d+) registers", text)],
            "HGMMA": len(re.findall(r"\bHGMMA", sass)),
            "HMMA": len(re.findall(r"\bHMMA", sass))}


def expansion_rates() -> None:
    """Phase 5: the expansion y[j] = x[j >> 2] in elements written per
    second at 256 and 4096 copies, by every route on the card: the gather
    and the shuffle at P3's [8, 2048] k=4, the one-hot product in tf32 and
    u8x4 and the library's TF32 matmul at P5's [256,128]@[128,512]."""
    case = next(c for c in expand.CASES if c.name == "p3.jnp_repeat.k4")
    _, xt = case.inputs("cuda")
    _, x5, E5 = mxu_expand.p5_inputs()
    ops = {f: (case.bind(xt, f)[0], xt.numel()) for f in ("gather", "shfl")}
    for mode in ("tf32", "u8x4"):
        xm, em = mxu_expand.mode_inputs(x5, E5, mode, "cuda")
        ops[f"onehot_{mode}"] = (
            lambda G, xm=xm, em=em, mode=mode: mxu_expand.onehot_mma(
                xm, em, mode, G), 256 * 512)
        if mode == "tf32":
            ops["library_tf32_matmul"] = (
                lambda G, xm=xm, em=em: onehot_library(xm, em, "tf32",
                                                       G)[0](),
                256 * 512)
    for G in (256, 4096):
        rates = {name: G * n / (cuda_ms(lambda: fn(G), reps=5, warmup=1)
                                / 1e3) / 1e9
                 for name, (fn, n) in ops.items()}
        log(f"phase 5: expansion at {G} copies, G elements/s written: "
            f"{json.dumps(rates)}")
        torch.cuda.empty_cache()


def phase_expand():
    """Phase 5: the expansion-family probes. Every lane-map form, the
    transpose and every one-hot product mode against its plain version on
    the card, bit for bit, at the scripts' shapes, with all copies equal;
    the tf32 mismatches counted; each kernel, plain version and library
    call timed; then both entry points, with the launch counts set to 0
    before and read after. Returns the kernels' JSON entries."""
    err = {f: 0.0 for f in (*expand.FORMS, "transpose")}
    for case in expand.CASES:
        _, xt = case.inputs("cuda")
        for form in case.forms:
            kernel, plain = case.bind(xt, form)
            got = kernel(4)
            err[form] = max(err[form], same_bits(
                f"{case.name} [{form}]", got, plain().expand_as(got)))
    log(f"phase 5: {len(expand.CASES)} lane-map and transpose cases, every "
        f"form bit-equal to its plain version, 4 copies each, all equal")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for k in SHFL_KS:
        for cout in SHFL_COUTS:
            x = torch.randn((8, cout), generator=gen, device="cuda")
            got = expand.lane_map(x, "element", k, "shfl", 4)
            err["shfl"] = max(err["shfl"], same_bits(
                f"shfl k={k} [8,{cout}]", got, expand.lane_map_ref(
                    x, "element", k, "shfl").expand_as(got)))
    for (R, C), aligned in TRANSPOSE_SHAPES:
        # an unaligned x starts one float into its storage
        x = torch.randn(R * C + 1, generator=gen, device="cuda")[
            int(not aligned):][:R * C].view(R, C)
        got = expand.transpose(x, 4)
        err["transpose"] = max(err["transpose"], same_bits(
            f"transpose [{R},{C}] aligned={aligned}", got,
            expand.transpose_ref(x).expand_as(got)))
    log(f"phase 5: shfl at k in {SHFL_KS} and {SHFL_COUTS} columns (partial "
        f"warps at 96 and 2080), the transpose at {TRANSPOSE_SHAPES} "
        f"((shape, x aligned to 16 bytes)), bit-equal to their plain "
        f"versions, 4 copies each, all equal")
    for name in ("expand", "mxu_expand"):
        res = library_resources(name)
        log(f"phase 5: {name}: {json.dumps(res)}")
        if name == "mxu_expand" and not (res["HGMMA"] and not res["HMMA"]):
            fail(f"mxu_expand's SASS is not wgmma alone: {res}")

    mx = mxu_expand
    h, x5, E5 = mx.p5_inputs()
    x7, E7 = mx.p7_inputs()
    checks = [*(("P5 halves", x5, E5, m, 256) for m in ("u8x4", "tf32")),
              ("P5 hashes", h, E5, "u8x4", 256),
              *((f"P6 {label.strip()}", *mx.p6_inputs(r, k, n), m, 256)
                for r, k, n, m, label in mx.P6_POINTS),
              *(("P7 payloads", x7, E7, m, 512) for m in ("u8x4", "tf32"))]
    for label, x, E, mode, G in checks:
        xt, et = mx.mode_inputs(x, E, mode, "cuda")
        got = mx.onehot_mma(xt, et, mode, G)
        want = mx.onehot_mma_ref(xt, et, mode)
        err[mode] = max(err.get(mode, 0.0), same_bits(
            f"onehot {mode} {label}", got, want.expand_as(got)))
        K, N = E.shape
        wrong = mx._wrong(got[:1], x[:, (np.arange(N) * K) // N])
        log(f"phase 5: onehot {mode} {label} [{x.shape[0]},{K}]@[{K},{N}] "
            f"x{G}: bit-equal to its plain version, all copies equal; "
            f"{wrong} of {x.shape[0] * N} elements differ from the exact "
            f"selection")
        if mode == "u8x4" and wrong:
            fail(f"u8x4 is not bit-exact on {label}")
        del got, want
    torch.cuda.empty_cache()

    timed = {}
    for form, name in (("gather", "p3.jnp_repeat.k4"),
                       ("shfl", "p3.jnp_repeat.k4"),
                       ("butterfly", "p4.butterfly.k4"),
                       ("transpose", "p2.transpose")):
        timed[form] = time_lane_map(name, form)
        ms, plain_ms, lib_ms, bms = timed[form][:4]
        log(f"phase 5: {form} at {name}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, library {lib_ms:.6f} ms, bound {bms:.6f} "
            f"ms (CUDA graphs of {expand.GRAPH_CALLS} calls)")
    # P2's maps at [8,1024] k=2 through the gather, beside their library
    # calls
    for name in ("p2.jnprepeat", "p2.pltpurepeat_semantics", "p2.roll",
                 "p2.subl_upsample"):
        ms, plain_ms, lib_ms, bms, _, _ = time_lane_map(name, "gather")
        log(f"phase 5: gather at {name}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, library {lib_ms:.6f} ms, bound {bms:.6f} "
            f"ms (CUDA graphs of {expand.GRAPH_CALLS} calls)")
    # many copies: each kernel's device rate past launch latency, beside
    # one library call writing the same copies and the bound
    many = {}
    lane = next(c for c in expand.CASES if c.name == "p3.jnp_repeat.k4")
    bfly = next(c for c in expand.CASES if c.name == "p4.butterfly.k4")
    _, xl = lane.inputs("cuda")
    library, nbytes = copies_library(lane, xl, LANE_COPIES)
    lib_ms = cuda_ms(library, reps=COPIES_REPS, warmup=2)
    for form in expand.FORMS:
        kernel, _ = (bfly if form == "butterfly" else lane).bind(xl, form)
        same_bits(f"{form} x {LANE_COPIES}: the library call", library(),
                  kernel(LANE_COPIES))
        ms = cuda_ms(lambda: kernel(LANE_COPIES), reps=COPIES_REPS, warmup=2)
        many[form] = (LANE_COPIES, ms, lib_ms, bound(nbytes, 0, 1.0)[0])
        log(f"phase 5: {form} [8,2048] k=4 x {LANE_COPIES} copies: "
            f"{ms:.4f} ms, {LANE_COPIES * xl.numel() / (ms / 1e3) / 1e9:.3f} "
            f"G elements/s written ({nbytes / (ms / 1e3) / 1e9:.1f} GB/s); "
            f"bound {many[form][3]:.4f} ms by bytes ({nbytes} B); the "
            f"library's copy {lib_ms:.4f} ms")
    torch.cuda.empty_cache()
    case = next(c for c in expand.CASES if c.name == "p2.transpose")
    _, xt = case.inputs("cuda")
    kernel, _ = case.bind(xt, "transpose")
    library, nbytes = copies_library(case, xt, TRANSPOSE_COPIES)
    same_bits(f"transpose x {TRANSPOSE_COPIES}: the library call",
              library(), kernel(TRANSPOSE_COPIES))
    ms = cuda_ms(lambda: kernel(TRANSPOSE_COPIES), reps=COPIES_REPS,
                 warmup=2)
    lib_ms = cuda_ms(library, reps=COPIES_REPS, warmup=2)
    many["transpose"] = (TRANSPOSE_COPIES, ms, lib_ms,
                         bound(nbytes, 0, 1.0)[0])
    log(f"phase 5: transpose [16,128] x {TRANSPOSE_COPIES} copies: {ms:.4f} "
        f"ms ({nbytes / (ms / 1e3) / 1e9:.1f} GB/s); bound "
        f"{many['transpose'][3]:.4f} ms by bytes ({nbytes} B); the "
        f"library's t()[None].expand(G, C, R).contiguous() {lib_ms:.4f} ms")
    del library, kernel
    torch.cuda.empty_cache()

    G = 256
    for mode, (x, E) in (("tf32", (x5, E5)), ("bf16", mx.p6_inputs(256, 128,
                                                                   512)),
                         ("u8x4", (x5, E5))):
        xt, et = mx.mode_inputs(x, E, mode, "cuda")
        (M, K), N = xt.shape, et.shape[1]
        ms = cuda_ms(lambda: mx.onehot_mma(xt, et, mode, G), reps=10,
                     warmup=2)
        plain_ms = cuda_ms(lambda: mx.onehot_mma_ref(
            xt.expand(G, M, K), et, mode), reps=3)
        library, f32_out = onehot_library(xt, et, mode, G)
        lib_ms = cuda_ms(library, reps=10, warmup=2)
        nbytes = 4 * xt.numel() + et.numel() * et.element_size() \
            + 4 * G * M * N
        ops = 2 * G * M * K * N * (4 if mode == "u8x4" else 1)
        timed[mode] = (ms, plain_ms, lib_ms,
                       *bound(nbytes, ops, TC_OPS_PER_S[mode]),
                       REPLACES_MXU[mode])
        log(f"phase 5: onehot {mode} [{M},{K}]@[{K},{N}] x{G}: kernel "
            f"{ms:.4f} ms ({G * M * K * N / (ms / 1e3) / 1e12:.3f} T MAC/s), "
            f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
            f"({'f32' if f32_out else 'bf16, half the bytes'} out), bound "
            f"{timed[mode][3]:.4f} ms by {timed[mode][4]}")
        torch.cuda.empty_cache()

    expansion_rates()

    torch.cuda.synchronize()
    for counts in (expand.LAUNCHES, mx.LAUNCHES):
        for k in counts:
            counts[k] = 0
    ok = expand.main([])
    ok = mx.main([]) and ok
    torch.cuda.synchronize()
    launches = {**expand.LAUNCHES, **mx.LAUNCHES}
    log(f"phase 5: probe entry points launched {launches}")
    if not ok:
        fail("an expansion probe disagrees with the result its script "
             "checks against")
    if not all(launches.values()):
        fail(f"an expansion kernel was not launched by its entry point: "
             f"{launches}")

    entries = []
    for k, (ms, plain_ms, lib_ms, bound_ms, bound_by, replaces) in \
            timed.items():
        mxu = k in mx.MODES
        entries.append({
            "name": f"mxu_onehot_{k}" if mxu else
            "expand_transpose" if k == "transpose" else
            f"expand_lane_map_{k}",
            "route": "cuda",
            "source": f"{CSRC}/{'mxu_expand' if mxu else 'expand'}.cu",
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": err[k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
        if k in many:  # the same kernel writing many copies
            entries[-1].update(zip(
                ("copies", "copies_ms", "copies_library_ms",
                 "copies_bound_ms"), many[k]))
    return entries


def lowering_key(case, form: str) -> str:
    """The kernels-line key of ``case``'s ``form``: repeat by lane-map form,
    fori by placement (both shapes), the rest by probe."""
    probe = case.name.split(".")[0]
    return probe if form == probe else f"{probe}_{form}"


def lowering_work(case, ts):
    """(ops, bytes) of one call of ``case`` at its shape: each input read
    once and each output written once; fori's operations are what the
    function needs, ``lowering.fori_ops`` per column and round, then the
    pointers' sum."""
    probe = case.name.split(".")[0]
    if probe == "repeat":
        x = ts[0]
        return 0, 4 * (x.numel() // lowering.REPEAT_K + x.numel())
    if probe == "dynrow":
        return 0, 8 * ts[1].shape[1] + 4
    if probe == "int16":
        return 0, 6 * ts[0].numel()
    if probe == "fori":
        (nq, C), rounds = ts[0].shape, dict(lowering.FORI_POINTS)[
            ts[0].shape[0]]
        return C * (rounds * lowering.fori_ops(nq) + nq + 1), \
            8 * nq * C + 4 * C
    if probe == "reshape":
        return 0, 8 * ts[0].numel()
    # alias: the window's rows of stale and x read, of stale written
    row = ts[2][0].numel()
    return 0, 3 * 4 * lowering.ALIAS_WINDOW * row + 4


def lowering_library(case, ts):
    """One PyTorch call computing ``case``'s function, or None where it
    takes several (int16: a product, an add and a cast; fori: a loop of
    reductions; alias: an add, an add and a masked write)."""
    probe = case.name.split(".")[0]
    if probe == "repeat":
        x = ts[0]
        n = x.shape[1] // lowering.REPEAT_K
        return lambda: torch.repeat_interleave(
            x[:, :n], lowering.REPEAT_K, dim=1, output_size=x.shape[1])
    if probe == "dynrow":
        return lambda: torch.index_select(ts[1], 0, ts[0])
    if probe == "reshape":
        x = ts[0]
        return lambda: x.view(-1, x.shape[-1]).clone()
    return None


def check_fori(name, ts, placement) -> None:
    """Fails unless fori in ``placement`` on inputs ``ts`` (x, h) equals
    ``fori_ref`` bit for bit, also on integer tie scores with -inf columns,
    at one copy and over ``FORI_COPIES`` copies at one thread (regs: its
    lanes) per item and at 128 threads per SM; regs at every lane count
    built and at its default."""
    lo = lowering
    x, h = ts
    rounds = dict(lo.FORI_POINTS)[x.shape[0]]
    ties = torch.randint(0, 3, x.shape, generator=torch.Generator(
        "cuda").manual_seed(SEED), device="cuda").float()
    ties[:, :8] = -np.inf
    ties[5:, 8:16] = -np.inf
    lanes = (0, *lo.LANES) if placement == "regs" else (0,)
    for scores, what in ((x, "scores"), (ties, "ties")):
        want = lo.fori_ref(scores, h, rounds)
        for g in lanes:
            for copies, per_sm in ((1, 0), (lo.FORI_COPIES, 0),
                                   (lo.FORI_COPIES, 128)):
                got = lo.fori(scores, h, rounds, placement, copies, per_sm,
                              g)
                same_bits(f"{name} [{placement}] {what} at {g} lanes x "
                          f"{copies} copies at {per_sm or 'all'} "
                          f"threads/SM", got, want.expand_as(got))


def fori_lane_times() -> dict:
    """fori regs at every lane count built and the default: ms per call at
    both ``FORI_POINTS`` from CUDA graphs, and over ``FORI_COPIES`` copies
    by CUDA events (``COPIES_REPS`` calls after 2)."""
    lo = lowering
    rng = np.random.default_rng(SEED)
    out = {}
    for nq, rounds in lo.FORI_POINTS:
        x = torch.from_numpy(rng.standard_normal((nq, 1024)).astype(
            np.float32)).cuda()
        h = torch.full((nq, 1024), 3, dtype=torch.int32, device="cuda")
        for g in (0, *lo.LANES):
            out[f"{nq}x{rounds}_lanes{g}_ms"] = graph_ms(
                lambda: lo.fori(x, h, rounds, "regs", lanes=g))
            out[f"{nq}x{rounds}_copies_lanes{g}_ms"] = cuda_ms(
                lambda: lo.fori(x, h, rounds, "regs", lo.FORI_COPIES,
                                lanes=g), reps=COPIES_REPS, warmup=2)
    out["default_lanes"] = {"1024": lo.auto_lanes(1024),
                            str(1024 * lo.FORI_COPIES):
                            lo.auto_lanes(1024 * lo.FORI_COPIES)}
    log(f"phase 6: fori regs by lanes (0: the default): {json.dumps(out)}")
    return out


def phase_lowering(peak: float, floor_us: float):
    """Phase 6: the lowering probes. Every P1 kernel against its plain
    version and the numpy result on the card, bit for bit, at the script's
    shapes, fori also at the ACS kernel's merge shape and over 256 copies,
    in both placements, one thread per item and at 128 threads per SM;
    alias's aliasing, its rows outside a random window and the edges of
    alias and dynrow; each kernel, plain version and library call timed;
    P7's plain version and library call at its shape; then the entry point,
    with the launch counts set to 0 before and read after, and its fori
    rates. ``peak`` is the FP32 lane peak, ``floor_us`` the launch floor.
    Returns the kernels' JSON entries and the rates and times for the
    ``lowering`` line."""
    lo = lowering
    G = lo.FORI_COPIES
    err = {}
    for case in lo.CASES:
        arrays, ts = case.inputs("cuda")
        want = torch.from_numpy(np.ascontiguousarray(case.want(*arrays)))
        for form in case.forms:
            kernel, plain = case.bind(ts, form)
            got = kernel()
            key = lowering_key(case, form)
            err[key] = max(err.get(key, 0.0), same_bits(
                f"{case.name} [{form}]", got, plain()))
            same_bits(f"{case.name} [{form}] against numpy", got.cpu(), want)
            if form in lo.PLACEMENTS:
                check_fori(case.name, ts, form)
    fori_info = {f"{nq}": {"local": lo.fori_info("local", nq),
                           **{f"regs_{g}": lo.fori_info("regs", nq, g)
                              for g in lo.LANES}}
                 for nq, _ in lo.FORI_POINTS}
    log(f"phase 6: fori kernel info: {json.dumps(fori_info)}")
    bad = {(nq, k): i for nq, by in fori_info.items() for k, i in by.items()
           if k != "local" and i["local_bytes"]}
    if bad:
        fail(f"a fori regs kernel uses local memory: {bad}")
    log(f"phase 6: {len(lo.CASES)} lowering cases, every kernel bit-equal "
        f"to its plain version and to numpy; fori over {G} copies too, at "
        f"one thread per item and at 128 threads/SM, regs at lanes "
        f"{(0, *lo.LANES)} on the script's scores and on ties with -inf "
        f"columns")

    rng = np.random.default_rng(SEED)
    P, C, W = 16, 256, lo.ALIAS_WINDOW
    x = torch.from_numpy(rng.standard_normal((P, 8, C)).astype(
        np.float32)).cuda()
    for start in (3, P - W, P - 2, -2, 100, -100):
        # stale lies between two NaN rows that nothing may touch
        guard = torch.full((P + 2, 8, C), float("nan"), device="cuda")
        guard[1:P + 1] = torch.from_numpy(rng.standard_normal(
            (P, 8, C)).astype(np.float32)).cuda()
        before = guard.clone()
        stale = guard[1:P + 1]
        s = torch.tensor([start], dtype=torch.int32, device="cuda")
        got = lo.alias(stale, x, s, W)
        if got.data_ptr() != stale.data_ptr():
            fail("alias did not update its own buffer")
        same_bits(f"alias at s={start}", got,
                  lo.alias_ref(before[1:P + 1].clone(), x, s, W))
        outside = [p for p in range(P) if not 0 <= p - start < W]
        same_bits(f"alias rows outside the window at s={start}",
                  got[outside], before[1:P + 1][outside])
        same_bits(f"alias guard rows at s={start}", guard[[0, P + 1]],
                  before[[0, P + 1]])
    rows, cols = 136, 1024
    guard = torch.full((rows + 2, cols), float("nan"), device="cuda")
    guard[1:rows + 1] = torch.from_numpy(rng.standard_normal(
        (rows, cols)).astype(np.float32)).cuda()
    xr = guard[1:rows + 1]
    for index in (0, rows - 1, rows, 1000, 2**31 - 1, -1, -2**31):
        i = torch.tensor([index], dtype=torch.int32, device="cuda")
        same_bits(f"dynrow at {index}", lo.dynrow(xr, i),
                  xr[min(max(index, 0), rows - 1)][None])
    log("phase 6: alias updates its own buffer, keeps every row outside a "
        "random window, skips window rows outside [0, P); dynrow clamps its "
        "index; neither touches the NaN rows around its buffer")
    large = phase_reshape_large(rng)
    lanes_ms = fori_lane_times()

    timed = {}
    for case in lo.CASES:
        if case.name == "fori.k1":
            continue
        _, ts = case.inputs("cuda")
        ops, nbytes = lowering_work(case, ts)
        library = lowering_library(case, ts)
        for form in case.forms:
            kernel, plain = case.bind(ts, form)
            lib_ms = None
            if library is not None:
                same_bits(f"{case.name} library call", library(), plain())
                lib_ms = graph_ms(library)
            key = lowering_key(case, form)
            timed[key] = (graph_ms(kernel), graph_ms(plain), lib_ms,
                          *bound(nbytes, ops, peak), case.replaces)
            ms, plain_ms, _, bms, by, _ = timed[key]
            log(f"phase 6: {key} at {[list(t.shape) for t in ts]}: kernel "
                f"{ms:.6f} ms, plain {plain_ms:.6f} ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'}, bound "
                f"{bms:.3e} ms by {by} (CUDA graphs of "
                f"{expand.GRAPH_CALLS} calls)")

    # the launch floor at one thread and at each one-thread-an-element
    # kernel's own grid, taken side by side
    grid_floor_us = {"one_thread": lo.launch_floor_us()}
    for case in lo.CASES:
        if case.name in lo.GRID_CASES:
            grid_floor_us[case.name] = lo.launch_floor_us(
                blocks=lo.grid_blocks(case), threads=lo.BLOCK)
    grids = {c.name: lo.grid_blocks(c) for c in lo.CASES
             if c.name in lo.GRID_CASES}
    log(f"phase 6: launch floor (an empty kernel, CUDA graphs of "
        f"{expand.GRAPH_CALLS}) at one thread and at each kernel's grid "
        f"(blocks of {lo.BLOCK}: {grids}), us: {json.dumps(grid_floor_us)}")

    mx = mxu_expand
    x7, E7 = mx.p7_inputs()
    p7 = {}
    for mode in ("u8x4", "tf32"):
        G7 = 512
        xt, et = mx.mode_inputs(x7, E7, mode, "cuda")
        (M, K), N = xt.shape, et.shape[1]
        p7[mode] = {
            "ms": cuda_ms(lambda: mx.onehot_mma(xt, et, mode, G7), reps=10,
                          warmup=2),
            # the float64 product warmed up, then the mean of 10 calls
            "plain_ms": cuda_ms(lambda: mx.onehot_mma_ref(
                xt.expand(G7, M, K), et, mode), reps=10, warmup=3),
            "library_ms": cuda_ms(onehot_library(xt, et, mode, G7)[0],
                                  reps=10, warmup=2)}
        log(f"phase 6: P7 onehot {mode} [{M},{K}]@[{K},{N}] x{G7}: kernel "
            f"{p7[mode]['ms']:.4f} ms, plain {p7[mode]['plain_ms']:.4f} ms, "
            f"library {p7[mode]['library_ms']:.4f} ms")
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    for counts in (lo.LAUNCHES, expand.LAUNCHES):
        for k in counts:
            counts[k] = 0
    ok, rates = lo.main([])
    torch.cuda.synchronize()
    launches = {**lo.LAUNCHES,
                **{f"repeat_{f}": expand.LAUNCHES[f] for f in
                   lo.CASES[0].forms}}
    log(f"phase 6: the entry point launched {launches}")
    if not ok:
        fail("a lowering probe disagrees with the result its script checks "
             "against, or a fori rate run with its plain version")
    if not all(launches.values()):
        fail(f"a lowering kernel was not launched by its entry point: "
             f"{launches}")

    entries = [{
        "name": f"lowering_{k}", "route": "cuda",
        "source": f"{CSRC}/expand.cu" if k.startswith("repeat")
        else f"{CSRC}/lowering.cu",
        "replaces": replaces, "launches": launches[k],
        "max_abs_err": err[k], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        # int16, fori and alias take several PyTorch calls each
        "library_ms": lib_ms, "launch_floor_ms": floor_us / 1e3,
        **({"grid_launch_floor_ms": grid_floor_us[k] / 1e3}
           if k in grid_floor_us else {}),
        **(large if k == "reshape" else {})}
        for k, (ms, plain_ms, lib_ms, bound_ms, bound_by, replaces)
        in timed.items()]
    return entries, {"launch_floor_us": floor_us,
                     "grid_launch_floor_us": grid_floor_us,
                     "fori_rates": rates,
                     "fori_info": fori_info, "fori_regs_by_lanes": lanes_ms,
                     "p7": p7, "reshape_large": large}


def phase_reshape_large(rng) -> dict:
    """Phase 6, the reshape copy past launch latency: bit-equal to its plain
    version at a few vector counts that leave a block part-filled, and at
    ``lowering.RESHAPE_LARGE``, where it is timed beside ``clone`` (CUDA
    events, ``COPIES_REPS`` calls after 2 warm-ups) and its bound. Returns
    the ``large_*`` keys of the reshape's kernels-line entry."""
    lo = lowering
    sizes = (1, 129, 16384 + 5)
    for n4 in sizes:
        x = torch.from_numpy(rng.standard_normal(4 * n4).astype(
            np.float32)).cuda().view(1, 1, -1)
        same_bits(f"reshape copy of {n4} vectors", lo.reshape(x),
                  lo.reshape_ref(x))
    x = torch.randn(lo.RESHAPE_LARGE, device="cuda")
    err = same_bits(f"reshape copy at {list(lo.RESHAPE_LARGE)}",
                    lo.reshape(x), lo.reshape_ref(x))
    nbytes = 8 * x.numel()
    out = {"large_shape": list(lo.RESHAPE_LARGE), "large_bytes": nbytes,
           "large_max_abs_err": err,
           "large_ms": cuda_ms(lambda: lo.reshape(x), reps=COPIES_REPS,
                               warmup=2),
           "large_library_ms": cuda_ms(
               lambda: x.view(-1, x.shape[-1]).clone(), reps=COPIES_REPS,
               warmup=2),
           "large_bound_ms": bound(nbytes, 0, 1.0)[0]}
    log(f"phase 6: reshape copy bit-equal at {sizes} vectors; at "
        f"{list(lo.RESHAPE_LARGE)} ({nbytes} bytes moved): kernel "
        f"{out['large_ms']:.5f} ms ({nbytes / out['large_ms'] / 1e9:.3f} "
        f"TB/s), clone {out['large_library_ms']:.5f} ms, bound "
        f"{out['large_bound_ms']:.5f} ms")
    del x
    torch.cuda.empty_cache()
    return out


def phase_lse_lanes(cfg, enc, post) -> dict:
    """Phase 7b, last part: the lse kernel's L <= 16 lane bucket at list
    size ``LSE_LANES_L`` at the headline config (m=11), where its time is
    comparable with the flat form's that it replaced: the middle block
    timed at B=1 on ``post`` and at B=``LSE_LANES_B`` on reads of phase 3's
    first batch in ``post``'s orientation, held bit-equal to the plain
    version there (L = 12 leaves dead slots in the bucket) and counted
    against its bound (``merge_roofline.lse_bound``). Returns the times,
    bounds and the bucket's build."""
    dec = LVADecoder(dataclasses.replace(cfg, list_size=LSE_LANES_L),
                     device="cuda")
    posts, rcs, _ = simulate_posts(enc.oligos, 8,
                                   np.random.default_rng(SEED))
    same = [p for p, r in zip(posts, rcs) if r == cfg.code.rc][:LSE_LANES_B]
    if len(same) < LSE_LANES_B:
        fail(f"phase 7b: {len(same)} reads in one orientation for "
             f"B={LSE_LANES_B}")
    out = {"L": LSE_LANES_L, "info": lva_acs.lse_kernel_info(LSE_LANES_L)}
    for reads in ([post], same):
        batch, nblks = pack_posts(reads)
        T = int(nblks.min())
        check = CheckedACS(timed=T // 2, check=lambda t: False, lse=True)
        dec.decode(batch, nblks, acs=check)
        start1, active = check.timed_args
        bnd = merge_roofline.lse_bound(dec.spec, start1, active,
                                      *check.needed)
        B = len(reads)
        log(f"phase 7b: L = {LSE_LANES_L} B={B}: block {T // 2} bit-equal, "
            f"kernel {check.ms:.4f} ms, plain {check.plain_ms:.4f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_term']}, "
            f"{100 * bnd['bound_ms'] / check.ms:.1f}% of it; flat merge's "
            f"{bnd['bound_flat_ms']:.4f} ms by {bnd['bound_flat_term']}")
        out[f"B{B}"] = {"ms": check.ms, "plain_ms": check.plain_ms,
                        "bound": bnd,
                        "share_of_bound": bnd["bound_ms"] / check.ms,
                        "max_abs_err": check.err}
    log(f"phase 7b: the L <= 16 bucket's build: {json.dumps(out['info'])}")
    return out


def phase_lse(enc, exp, data: bytes, headline, post, gpu: str):
    """Phase 7: logsumexp path combining through its kernel
    (``acs_block_lse``) at the headline config. (a) The kernel against its
    plain version on one read at B=1, as phase 1 does for the K-way kernel
    but without the sorted-rows check (lse rows are unsorted by design);
    (b) the L <= 8 bucket at L = 3 and 5 and the L <= 16 bucket at L = 12
    (``LSE_LIST_SIZES``), that bucket timed (``phase_lse_lanes``); (c)
    phase 3's first batch at the main path's shapes (B=4 by orientation),
    every ``LSE_CHECK_EVERY``-th block checked, one block timed and its
    bound counted; (d) the lse path end to
    end: phase 3's 32 reads in batches of 8 through ``PipelineDecoder(...,
    path_combine="logsumexp")``, ``majority_vote`` and ``recover_file``,
    with the launch counts set to 0 just before. Returns the kernels-line
    entry and the ``lva_acs_lse`` line."""
    cfg = dataclasses.replace(headline, path_combine=LSE)
    dec = LVADecoder(cfg, device="cuda")
    ms_b1, plain_b1, err, _ = phase_kernel(dec, post, tag="phase 7a")
    for L in LSE_LIST_SIZES:
        phase_bucket(cfg, post, L, tag="phase 7b")
    lanes = phase_lse_lanes(cfg, enc, post)
    (B, ms, plain_ms), (start1, active), needed, err_b = phase_batch(
        enc, exp, "cuda", LSE, every=LSE_CHECK_EVERY, tag="phase 7c")
    bnd = merge_roofline.lse_bound(dec.spec, start1, active, *needed)
    log(f"lva_acs_lse bound at B={B}: {bnd['bytes']} bytes (every slot) "
        f"{bnd['bytes_ms']:.4f} ms, {bnd['ops']} ops {bnd['ops_ms']:.4f} ms, "
        f"{bnd['exp_calls']} exp + {bnd['log_calls']} log calls "
        f"{bnd['sfu_ms']:.4f} ms: {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_term']}; the kernel reaches "
        f"{100 * bnd['bound_ms'] / ms:.1f}% of it; the flat merge's "
        f"{bnd['flat_ops']} ops give {bnd['bound_flat_ms']:.4f} ms by "
        f"{bnd['bound_flat_term']}")

    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    n_reads, batch = 32, 8
    rng = np.random.default_rng(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_base = profiling.counter("acs.launches")
    lse_base = profiling.counter("acs.lse_launches")
    t0 = time.perf_counter()
    pdec = PipelineDecoder(exp, 8, 20, path_combine=LSE, device="cuda")
    index, payload = [], []
    for _ in range(n_reads // batch):
        posts, rcs, _ = simulate_posts(enc.oligos, batch, rng)
        out = pdec.decode_posts(posts, rcs, num_oligos)
        index.append(out.index)
        payload.append(out.payload)
    ok, got = recover_file(majority_vote(np.concatenate(index),
                                         np.concatenate(payload)),
                           exp, len(data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = profiling.counter("acs.lse_launches") - lse_base
    kway = profiling.counter("acs.launches") - k1_base
    crc = int((np.concatenate(index) >= 0).sum())
    log(f"phase 7d: logsumexp path: {wall:.3f} s for {n_reads} reads = "
        f"{wall / n_reads:.4f} s/read; {crc} pass CRC; {launches} lse kernel "
        f"launches and {kway} K-way launches for {pdec.steps} block steps; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (ok and got == data):
        fail("the logsumexp path did not recover the file byte for byte")
    if launches == 0 or launches != pdec.steps or kway:
        fail(f"{launches} lse and {kway} K-way launches for {pdec.steps} "
             f"block steps")
    entry = {
        "name": "lva_acs_lse", "route": "cuda",
        "source": f"{CSRC}/lva_lse.cu",
        "replaces": "nanopore_dna_storage_tpu/ops/lva_pallas.py:929 "
                    "(logsumexp branch :614-646)",
        "launches": launches, "max_abs_err": max(err, err_b), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
        "bound_by": bnd["bound_by"],
        # no one PyTorch call computes a list-Viterbi block step
        "library_ms": None}
    line = {"gpu": gpu, "B": B, "ms_B1": ms_b1, "plain_ms_B1": plain_b1,
            f"ms_B{B}": ms, f"plain_ms_B{B}": plain_ms,
            "L8": lva_acs.lse_kernel_info(8), f"bound_B{B}": bnd,
            "share_of_bound": bnd["bound_ms"] / ms,
            "s_per_read": wall / n_reads, "launches": launches,
            "steps": pdec.steps, "crc_pass": crc,
            # the L <= 16 bucket at m=11 (no path runs it at m=11)
            f"L{LSE_LANES_L}": lanes}
    return entry, line


def lse_path_cell(data: bytes, L: int, B: int, batch: int,
                  reads: int) -> dict:
    """One cell of phase 7e, experiment 0 at list size ``L`` under
    logsumexp combining: (a) the lse kernel against its plain version on
    one simulated forward read and on ``B`` of them, blocks at position 0,
    spread over the reads and at their end bit-equal, one of them also with
    the reads made inactive, the middle block timed and counted against its
    bound (``lse_bound``); (b) the lse path end to end: ``reads`` reads
    simulated ``batch`` at a time through ``PipelineDecoder(experiment(0),
    L, 20, path_combine="logsumexp")``, every ``LSE_CHECK_EVERY``-th block
    step of the first batch held bit-equal to the plain version on the
    card (as phase 7c holds the first batch; the plain step takes ~0.5 s a
    block at L = 64), then ``majority_vote`` and ``recover_file``, which
    must give the file byte for byte, with the launch counts set to 0 just
    before: one lse launch per forward block step and no K-way launch; the
    path's s/read from the batches after the checked one. Returns the
    cell's record."""
    tag = f"phase 7e (experiment 0, L={L})"
    exp = experiment(0)
    enc = encode_bytes(data, exp)
    posts, rcs, _ = simulate_posts(enc.oligos, 4 * B,
                                   np.random.default_rng(SEED))
    fwd = [p for p, rc in zip(posts, rcs) if not rc][:B]
    if len(fwd) < B:
        fail(f"{tag}: {len(fwd)} forward reads for B={B}")
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                            msg_len=exp.msg_len()),
        list_size=L, max_deviation=20, path_combine=LSE), device="cuda")
    info = lva_acs.lse_kernel_info(L)
    log(f"{tag}: C={dec.spec.code.nstate_conv} W={dec.spec.window}; nblk "
        f"{[len(p) for p in fwd]}; lse_kernel_info({L}) {json.dumps(info)}")
    rec = {"list_size": L, "lse_kernel_info": info}
    err = 0.0
    for n in sorted({1, B}):
        batch_posts, nblks = pack_posts(fwd[:n])
        T = int(nblks.min())
        blocks = {0, 1, T // 4, T // 2, 3 * T // 4, int(nblks.max()) - 1}
        check = CheckedACS(timed=T // 2, check=blocks.__contains__, lse=True,
                           inactive=T // 4)
        _, _, valid = dec.decode(batch_posts, nblks, acs=check)
        if check.checked < len(blocks) or not valid[:, 0].all():
            fail(f"{tag}: B={n}: {check.checked} blocks checked, top "
                 f"entries valid {valid[:, 0]}")
        start1, active = check.timed_args
        bnd = merge_roofline.lse_bound(dec.spec, start1, active,
                                      *check.needed)
        err = max(err, check.err)
        log(f"{tag}: B={n}: {check.checked} of {check.blocks} blocks "
            f"bit-equal, block {T // 4} also inactive; block {T // 2}: "
            f"kernel {check.ms:.4f} ms, plain {check.plain_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms by {bnd['bound_term']}, "
            f"{100 * bnd['bound_ms'] / check.ms:.1f}% of it; flat merge's "
            f"{bnd['bound_flat_ms']:.4f} ms by {bnd['bound_flat_term']}")
        rec[f"B{n}"] = {"ms": check.ms, "plain_ms": check.plain_ms,
                        "bound": bnd,
                        "share_of_bound": bnd["bound_ms"] / check.ms,
                        "blocks_checked": check.checked,
                        "max_abs_err": check.err}

    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    rng = np.random.default_rng(SEED)
    check = CheckedACS(timed=-1, check=lambda t: t % LSE_CHECK_EVERY == 0,
                       lse=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_base = profiling.counter("acs.launches")
    lse_base = profiling.counter("acs.lse_launches")
    t0 = time.perf_counter()
    pdec = PipelineDecoder(exp, L, 20, path_combine=LSE, device="cuda")
    index, payload, batch_s = [], [], []
    for i in range(reads // batch):
        t1 = time.perf_counter()
        posts, rcs, _ = simulate_posts(enc.oligos, batch, rng)
        out = pdec.decode_posts(posts, rcs, num_oligos,
                                **({"acs": check} if i == 0 else {}))
        index.append(out.index)
        payload.append(out.payload)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t1)
    ok, got = recover_file(majority_vote(np.concatenate(index),
                                         np.concatenate(payload)),
                           exp, len(data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = profiling.counter("acs.lse_launches") - lse_base
    kway = profiling.counter("acs.launches") - k1_base
    crc = int((np.concatenate(index) >= 0).sum())
    peak = torch.cuda.max_memory_allocated() / 2**30
    err = max(err, check.err)
    # the first batch also runs the plain step on its checked blocks
    per_read = sum(batch_s[1:]) / (reads - batch)
    log(f"{tag}: the lse path: {wall:.3f} s for {reads} reads in batches of "
        f"{batch}, {batch_s[0]:.3f} s of it the first batch (the plain step "
        f"on {check.checked} of its {check.blocks} block steps, "
        f"{check.mixed} with active and inactive reads); {per_read:.4f} "
        f"s/read over the other batches; {crc} pass CRC; {launches} lse launches and "
        f"{kway} K-way launches for {pdec.steps} block steps; peak device "
        f"memory {peak:.2f} GiB")
    if check.checked == 0 or check.mixed == 0:
        fail(f"{tag}: {check.checked} block steps checked, {check.mixed} "
             f"of them mixed")
    if not (ok and got == data):
        fail(f"{tag}: the logsumexp path did not recover the file byte for "
             f"byte")
    if launches == 0 or launches != pdec.steps or kway:
        fail(f"{tag}: {launches} lse and {kway} K-way launches for "
             f"{pdec.steps} block steps")
    rec["path"] = {"reads": reads, "batch": batch, "s": wall,
                   "batch_s": batch_s, "s_per_read": per_read, "lse_launches": launches,
                   "k1_launches": kway, "block_steps": pdec.steps,
                   "blocks_checked": check.checked, "crc_pass": crc,
                   "peak_gib": peak}
    rec["max_abs_err"] = err
    return rec


def phase_lse_path(data: bytes, gpu: str) -> dict:
    """Phase 7e: the lse path at experiment 0's list sizes,
    ``LSE_PATH_CELLS`` through ``lse_path_cell`` on the 100-byte file.
    Returns the ``lse_path`` line."""
    torch.cuda.empty_cache()
    line = {"gpu": gpu}
    for L, B, batch, reads in LSE_PATH_CELLS:
        line[f"exp0_L{L}"] = lse_path_cell(data, L, B, batch, reads)
    return line


def lse_buckets(entry: dict, line: dict, path_line: dict,
                resources: dict) -> dict:
    """The kernels-line entry of the lse kernel with its three buckets:
    ``launches`` summed over phase 7d's path (the L <= 8 bucket) and phase
    7e's two (L = 16 and 64), and under ``buckets`` each bucket's launches,
    build and its times, plain times and bound at B=4 (phase 7c at m=11 L=8,
    phase 7e at experiment 0), and beside the bound the flat merge's
    (``bound_flat_ms``)."""
    buckets = {"L<=8": {"launches": entry["launches"], "ms": entry["ms"],
                        "plain_ms": entry["plain_ms"],
                        "bound_ms": entry["bound_ms"],
                        "bound_flat_ms": line[
                            f"bound_B{line['B']}"]["bound_flat_ms"],
                        "resources": resources["L8"]}}
    for L, B, _, _ in LSE_PATH_CELLS:
        cell = path_line[f"exp0_L{L}"]
        timed = cell[f"B{B}"]
        buckets["L<=16" if L <= 16 else "L<=64"] = {
            "launches": cell["path"]["lse_launches"], "ms": timed["ms"],
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound"]["bound_ms"],
            "bound_flat_ms": timed["bound"]["bound_flat_ms"],
            "resources": resources["L12" if L <= 16 else "L64"]}
        entry["max_abs_err"] = max(entry["max_abs_err"], cell["max_abs_err"])
    buckets["L<=16"]["m11_L12_ms"] = {
        f"B{B}": line[f"L{LSE_LANES_L}"][f"B{B}"]["ms"]
        for B in (1, LSE_LANES_B)}
    return {**entry,
            "launches": sum(b["launches"] for b in buckets.values()),
            "buckets": buckets}


def device_ops(prof):
    """(operations the device ran, their device time in ms) in one
    ``torch.profiler`` window: kernels, copies and fills."""
    n, us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += e.count
            us += getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
    return n, us / 1e3


def chain_stages(net, sig, ns):
    """The basecaller chain on the padded batch ``sig`` [B, T] with ``ns``
    [B] samples a read, as (name, fn) pairs, each fn taking the previous
    stage's result: the stages of ``FlipflopNet.forward`` (the conv, each
    GRU layer, the head with its partition), then the forward-backward
    posteriors and the Viterbi paths over each read's own blocks."""
    nblk = -(-ns // net.cfg.stride)
    return [("conv", lambda _: net.features(sig)),
            *[(f"gru{i}_{d}", lambda x, i=i: net.layer(i, x))
              for i, d in enumerate(net.cfg.layer_dirs)],
            ("head_partition", lambda x: net.head(x, ns)),
            ("fwdbwd", lambda tr: batched_transition_posteriors(tr, nblk)),
            ("viterbi", lambda post: viterbi_flipflop_batch(post, nblk))]


def run_chain(stages, profile=False) -> dict:
    """The stages in order on the card: {name: (result, seconds, peak
    device bytes, device ops, device ms)}, each stage between two
    synchronisations; the device counts only under ``profile`` (else
    None)."""
    out, x = {}, None
    for name, fn in stages:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ctx = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) \
            if profile else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx as prof:
            x = fn(x)
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out[name] = (x, sec, torch.cuda.max_memory_allocated(),
                     *(device_ops(prof) if profile else (None, None)))
    return out


def held(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Fails unless ``got`` (the card's) and ``want`` (the CPU's) agree to
    ``CHAIN_TOL``, -inf where the other is; returns the max |difference|
    over finite values."""
    got = got.cpu()
    if got.shape != want.shape or not torch.equal(torch.isneginf(got),
                                                  torch.isneginf(want)):
        fail(f"{name}: the card's and the CPU's differ in shape or -inf")
    if not bool(torch.isfinite(got[~torch.isneginf(got)]).all()):
        fail(f"{name}: NaN or +inf on the card")
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    if not torch.allclose(got[fin], want[fin], rtol=CHAIN_TOL,
                          atol=CHAIN_TOL):
        fail(f"{name}: the card's differ from the CPU's by {err}")
    return err


def phase_basecall(enc, exp, gpu: str):
    """Phase 8: the basecaller chain at the published widths (conv winlen
    19, stride 2, 256 filters, five 256-unit GRU layers b / f / b / f / b)
    on ``init_params`` weights from ``torch.Generator`` seed ``SEED``.
    (a) ``simulate_posts_signal`` makes ``CHAIN_READS`` reads of
    experiment 7 from ``np.random.default_rng(SEED)`` on the card; (b) the
    same reads' signals (``simulate_raw_reads``, ``signal_batch``) through
    the chain stage by stage on the card, its transitions and posteriors
    held against the port's CPU run on the same signals and weights
    (``CHAIN_TOL``), its Viterbi paths equal to the CPU's on the card's
    posteriors, and on tie-heavy integer posteriors, and (a)'s posteriors
    equal to (b)'s; (c) (a)'s posteriors decoded by
    ``PipelineDecoder.decode_posts`` at L = 8, max deviation 20, in
    batches of ``CHAIN_BATCH``, with one K1 launch per block step (the
    counts set to 0 just before); (d) ``Basecaller.basecall`` on the raw
    signals writes a FASTQ whose qualities lie in 33..126; (e) each stage
    timed again, then under ``torch.profiler`` for its device operations
    and device time, and the decode of the first batch profiled. Returns
    the K1 launches of (c) and the ``basecall`` line."""
    cfg = FlipflopConfig()
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    net = FlipflopNet(cfg, params, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    posts, rcs, ids = simulate_posts_signal(
        enc.oligos, CHAIN_READS, np.random.default_rng(SEED), net)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    nblks = [len(p) for p in posts]
    for p in posts:
        lse = torch.logsumexp(torch.from_numpy(p).reshape(len(p), 40), 1)
        if not (np.isfinite(p).all() and p.shape[1:] == (5, 8)
                and float(lse.abs().max()) < CHAIN_TOL):
            fail("a posterior block is not finite, [5, 8] and normalised")
    log(f"phase 8a: simulate_posts_signal: {CHAIN_READS} reads of "
        f"experiment 7 in {sim_s:.3f} s, {min(nblks)}-{max(nblks)} blocks")

    raws, rcs_b, ids_b = simulate_raw_reads(
        enc.oligos, CHAIN_READS, np.random.default_rng(SEED))
    if not (np.array_equal(rcs_b, rcs) and np.array_equal(ids_b, ids)):
        fail("simulate_raw_reads drew other reads than simulate_posts_signal")
    sig, ns = signal_batch(raws)
    sig_h, ns_h = torch.from_numpy(sig), torch.from_numpy(ns)
    stages = chain_stages(net, sig_h.cuda(), ns_h.cuda())
    first = run_chain(stages)
    trans, post = first["head_partition"][0], first["fwdbwd"][0]
    paths, scores = first["viterbi"][0]
    t0 = time.perf_counter()
    cpu_net = FlipflopNet(cfg, params, device="cpu")
    nblk_h = -(-ns_h // cfg.stride)
    trans_h = cpu_net(sig_h, ns_h)
    post_h = batched_transition_posteriors(trans_h, nblk_h)
    cpu_s = time.perf_counter() - t0
    err = {"transitions": held("transitions", trans, trans_h)}
    valid = torch.arange(post.shape[1])[None] < nblk_h[:, None]
    err["posteriors"] = held("posteriors", post[valid.cuda()],
                             post_h[valid])
    err["simulate_posts_signal"] = max(
        held(f"read {i} of simulate_posts_signal", post[i, :n],
             torch.from_numpy(p)) for i, (p, n) in enumerate(
            zip(posts, nblks)))
    paths_h, scores_h = viterbi_flipflop_batch(post.cpu(), nblk_h)
    if not torch.equal(paths_h, paths.cpu()):
        fail("the card's Viterbi paths differ from the CPU's on the card's "
             "posteriors")
    err["viterbi_scores"] = float((scores.cpu() - scores_h).abs().max())
    ties = torch.from_numpy(np.random.default_rng(SEED).integers(
        -2, 1, (4, 64, 5, 8)).astype(np.float32))
    nties = torch.tensor([64, 64, 40, 3])
    tp, ts = viterbi_flipflop_batch(ties.cuda(), nties.cuda())
    tp_h, ts_h = viterbi_flipflop_batch(ties, nties)
    if not (torch.equal(tp.cpu(), tp_h) and torch.equal(ts.cpu(), ts_h)):
        fail("the card breaks Viterbi ties otherwise than the CPU")
    log(f"phase 8b: the chain at B={CHAIN_READS}, T={sig.shape[1]} samples, "
        f"{trans.shape[1]} blocks: the card's transitions and posteriors "
        f"within {CHAIN_TOL} of the CPU's ({cpu_s:.2f} s there), max "
        f"|error| {json.dumps(err)}; Viterbi paths equal on the card's "
        f"posteriors and on ties")

    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    pdec = PipelineDecoder(exp, 8, 20, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_base = profiling.counter("acs.launches")
    t0 = time.perf_counter()
    crc = 0
    for lo in range(0, CHAIN_READS, CHAIN_BATCH):
        out = pdec.decode_posts(posts[lo:lo + CHAIN_BATCH],
                                rcs[lo:lo + CHAIN_BATCH], num_oligos)
        crc += int((out.index >= 0).sum())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = profiling.counter("acs.launches") - k1_base
    decode_peak = torch.cuda.max_memory_allocated()
    log(f"phase 8c: decode_posts of the {CHAIN_READS} reads in batches of "
        f"{CHAIN_BATCH}: {decode_s:.3f} s, {launches} K1 launches for "
        f"{pdec.steps} block steps, {crc} pass CRC (random weights), peak "
        f"device memory {decode_peak / 2**30:.2f} GiB")
    if launches == 0 or launches != pdec.steps:
        fail(f"{launches} K1 launches for {pdec.steps} block steps")

    t0 = time.perf_counter()
    calls = Basecaller(net, device="cuda").basecall(
        [f"read{i}" for i in range(CHAIN_READS)], raws)
    basecall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        fq = pathlib.Path(tmp) / "calls.fastq"
        write_fastq(str(fq), calls)
        lines = fq.read_text().splitlines()
    if len(lines) != 4 * CHAIN_READS:
        fail(f"the FASTQ has {len(lines)} lines for {CHAIN_READS} reads")
    for seq, qual in zip(lines[1::4], lines[3::4]):
        if len(seq) != len(qual) or not set(seq) <= set("ACGT") or not all(
                33 <= ord(c) <= 126 for c in qual):
            fail(f"a FASTQ record is malformed: {seq!r} {qual!r}")
    bases = sum(len(c.sequence) for c in calls)
    if bases == 0:
        fail("the basecaller called no base")
    log(f"phase 8d: Basecaller.basecall on the raw signals: {basecall_s:.3f} "
        f"s, {bases} bases, a FASTQ of {CHAIN_READS} records, qualities in "
        f"33..126")

    timed = run_chain(stages)
    prof = run_chain(stages, profile=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        PipelineDecoder(exp, 8, 20, device="cuda").decode_posts(
            posts[:CHAIN_BATCH], rcs[:CHAIN_BATCH], num_oligos)
        torch.cuda.synchronize()
    stage_line = {}
    for name, (_, sec, peak, _, _) in timed.items():
        ops, dev_ms = prof[name][3:]
        stage_line[name] = {
            "s": sec, "device_ops": ops, "device_ms": dev_ms,
            "idle_share": 1 - dev_ms / 1e3 / sec if ops else None,
            "peak_gib": peak / 2**30}
        log(f"phase 8e: {name}: {sec:.4f} s, {ops} device ops, device "
            f"{dev_ms:.3f} ms, peak {peak / 2**30:.3f} GiB")
    dec_ops, dec_ms = device_ops(p)
    chain_s = sum(v["s"] for v in stage_line.values())
    chain_ops = sum(v["device_ops"] for v in stage_line.values())
    chain_ms = sum(v["device_ms"] for v in stage_line.values())
    log(f"phase 8e: the chain {chain_s:.3f} s, {chain_ops} device ops, "
        f"device {chain_ms:.2f} ms (idle share "
        f"{1 - chain_ms / 1e3 / chain_s:.4f}); decode {decode_s:.3f} s for "
        f"{CHAIN_READS} reads, its first batch {dec_ops} device ops, device "
        f"{dec_ms:.2f} ms")
    line = {"gpu": gpu, "reads": CHAIN_READS, "T": sig.shape[1],
            "blocks": trans.shape[1], "tolerance": CHAIN_TOL,
            "max_abs_err": err, "simulate_posts_signal_s": sim_s,
            "cpu_chain_s": cpu_s, "stages": stage_line,
            "chain_s": chain_s, "chain_device_ops": chain_ops,
            "chain_device_ms": chain_ms,
            "decode": {"s": decode_s, "batch": CHAIN_BATCH,
                       "k1_launches": launches, "steps": pdec.steps,
                       "crc_pass": crc, "peak_gib": decode_peak / 2**30,
                       "first_batch_device_ops": dec_ops,
                       "first_batch_device_ms": dec_ms},
            "basecall_s": basecall_s, "bases": bases}
    return launches, line


def sharded_nccl(batch, nblks, exp, num_oligos: int, want):
    """Phase 9a over a one-rank nccl group in this process:
    ``ShardedDecoder.decode`` reduces its CRC count and gathers its shards
    with nccl collectives on the card, and must equal the world-1 result
    ``want``, with one K1 launch per block step. The group is gone on
    return. Returns (K1 launches, block steps, seconds)."""
    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0,
                         backend="nccl", device="cuda:0", timeout=120)
    try:
        sd = ShardedDecoder(exp, 8, rc=False, max_deviation=20,
                            device="cuda:0")
        torch.cuda.synchronize()
        k1_base = profiling.counter("acs.launches")
        t0 = time.perf_counter()
        got = sd.decode(batch, nblks, num_oligos)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n, steps = profiling.counter("acs.launches") - k1_base, sd.inner.steps
    finally:
        torch.distributed.destroy_process_group()
    if n == 0 or n != steps:
        fail(f"phase 9a: nccl group: {n} K1 launches for {steps} block "
             f"steps")
    if not (all(np.array_equal(getattr(got, a), getattr(want, a))
                for a in ("msgs", "scores", "ok", "index"))
            and got.crc_pass_total == want.crc_pass_total):
        fail("phase 9a: ShardedDecoder over a 1-rank nccl group differs "
             "from world 1")
    return n, steps, seconds


def run_job(post_dir, outdir, ranks: int, backend: str) -> dict:
    """Phase 9b/9c: the decode job over ``ranks`` processes on ``cuda:0``
    through ``parallel.launch`` (``python -m ...parallel.multihost`` a
    rank) with the group's ``backend``, gated, at the headline config;
    fails unless every rank exits 0 and prints its result record. Returns
    the leg's wall seconds and the records (each with its process start:
    spawn to ``main``)."""
    args = ["--post-dir", str(post_dir), "--outdir", str(outdir),
            "--experiment", "7", "--list-size", "8", "--max-deviation",
            "20", "--local-batch", str(PARALLEL_BATCH), "--device", "cuda:0",
            "--dist-backend", backend, "--timeout", "300"]
    t_spawn = time.time()
    t0 = time.perf_counter()
    done = launch.run_local(ranks, args, timeout=600)
    wall = time.perf_counter() - t0
    recs = []
    for rank, (code, out) in enumerate(done):
        lines = [ln for ln in out.splitlines() if ln.startswith('{"rank"')]
        if code != 0 or len(lines) != 1:
            fail(f"phase 9: {backend} rank {rank} of {ranks} exited {code}:"
                 f"\n{out[-3000:]}")
        rec = json.loads(lines[0])
        rec["start_s"] = rec.pop("t_main") - t_spawn
        recs.append(rec)
    return {"wall_s": wall, "ranks": recs}


def check_job(leg: str, job: dict, n_reads: int) -> None:
    """Every rank launched K1 once per block step and reports the same
    global CRC count, the sum of the ranks' own; the ranks' reads add up."""
    recs = job["ranks"]
    for r in recs:
        if r["k1_launches"] == 0 or r["k1_launches"] != r["steps"]:
            fail(f"phase 9: {leg} rank {r['rank']}: {r['k1_launches']} K1 "
                 f"launches for {r['steps']} block steps")
    crc = {r["crc_pass"] for r in recs}
    if len(crc) != 1 or crc != {sum(r["local_crc_pass"] for r in recs)} or \
            sum(r["reads"] for r in recs) != n_reads:
        fail(f"phase 9: {leg}: the ranks' counts disagree: {recs}")
    job["crc_pass"] = crc.pop()
    job["s_per_read"] = job["wall_s"] / n_reads


def list_files(outdir) -> dict:
    return {p.name: p.read_text() for p in pathlib.Path(outdir).glob(
        "list_*")}


def phase_parallel(enc, exp, data: bytes, gpu: str):
    """Phase 9: the scale-out decode (``parallel/``) at the headline
    config on ``PARALLEL_READS`` reads of phase 3's file, written as
    ``.post`` files. (a)
    ``ShardedDecoder.decode`` in this process at world 1 on phase 3's
    first batch's forward reads, equal to ``LVADecoder.decode`` and the
    host ``check_and_extract`` under the Pallas path's masking; the same
    call over a one-rank nccl group (its ``all_reduce`` and
    ``all_gather`` on the card) equal to that; the classification timed
    on the card and on the host; (b) the gated job
    as one nccl rank and (c) as two gloo ranks, both on ``cuda:0``; (d)
    their list files identical, file by file, and equal to the lists of
    ``PipelineDecoder.decode_posts_auto_orientation(gated=True)`` in this
    process, the ``info_*`` shards naming every read once, the CRC counts
    equal; (e) ``cli rs-recover`` on (b)'s lists recovering the file byte
    for byte, and ``cli error-rate`` on them. The K1 counts are set to 0
    before (a) and (d) here and in every rank before its job, and each
    must equal its block steps. Returns the K1 launches and the
    ``parallel`` line."""
    total = enc.num_oligos_data + enc.num_oligos_rs
    rng = np.random.default_rng(SEED)
    posts = [p for _ in range(PARALLEL_READS // 8)
             for p in simulate_posts(enc.oligos, 8, rng)[0]]
    launches = 0

    # (a) world 1 in this process, on the first batch's forward reads
    first, rcs, _ = simulate_posts(enc.oligos, 8, np.random.default_rng(SEED))
    fwd = [p for p, r in zip(first, rcs) if not r]
    batch, nblks = pack_posts(fwd)
    sd = ShardedDecoder(exp, 8, rc=False, max_deviation=20, device="cuda")
    torch.cuda.synchronize()
    k1_base = profiling.counter("acs.launches")
    t0 = time.perf_counter()
    res = sd.decode(batch, nblks, total)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    a_launches = profiling.counter("acs.launches") - k1_base
    a_steps = sd.inner.steps
    if a_launches == 0 or a_launches != a_steps:
        fail(f"phase 9a: {a_launches} K1 launches for {a_steps} block steps")
    launches += a_launches
    msgs, sc, valid = sd.inner.decode(batch, nblks)
    ok_h, index_h = check_and_extract(msgs, exp.framing, total, pad=exp.pad)
    ok_h &= valid
    if not (np.array_equal(res.msgs, msgs) and np.array_equal(res.ok, ok_h)
            and np.array_equal(res.index, index_h)
            and np.array_equal(res.scores, np.where(valid, sc, -np.inf))
            and res.crc_pass_total == int(ok_h.any(axis=1).sum())):
        fail("phase 9a: ShardedDecoder differs from LVADecoder.decode and "
             "the host check_and_extract")
    nccl_launches, nccl_steps, nccl_s = sharded_nccl(batch, nblks, exp,
                                                     total, res)
    launches += nccl_launches
    sc_d, words_d, okend_d = sd.inner.decode_device(batch, nblks)
    classify = lambda: sd.classify(words_d, sc_d, okend_d, total)  # noqa
    classify_ms = cuda_ms(classify, reps=20, warmup=2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        classify()
        torch.cuda.synchronize()
    classify_ops, classify_dev_ms = device_ops(prof)
    t0 = time.perf_counter()
    for _ in range(20):
        check_and_extract(msgs, exp.framing, total, pad=exp.pad)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"phase 9a: ShardedDecoder at world 1, B={len(fwd)}: {sharded_s:.3f}"
        f" s, {a_launches} K1 launches for {a_steps} block steps, "
        f"{res.crc_pass_total} pass CRC; msgs, scores, ok and index equal "
        f"to LVADecoder.decode and the host check; over a 1-rank nccl group "
        f"{nccl_s:.3f} s, {nccl_launches} K1 launches for {nccl_steps} "
        f"block steps, equal to world 1; classify on the card "
        f"{classify_ms:.4f} ms ({classify_ops} device ops, "
        f"{classify_dev_ms:.4f} ms of device time), the host check "
        f"{host_ms:.4f} ms")

    # the ranks are processes of their own on this card: hand them the
    # memory this process's allocator keeps cached from earlier phases
    del sd, sc_d, words_d, okend_d
    torch.cuda.empty_cache()
    parent_gib = torch.cuda.memory_reserved() / 2**30
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    log(f"phase 9: this process keeps {parent_gib:.2f} GiB reserved on the "
        f"card while the ranks run; {free_gib:.2f} GiB free")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        post_dir = tmp / "posts"
        post_dir.mkdir()
        for i, p in enumerate(posts):
            write_post(str(post_dir / f"read_{i}.post"), p)
        jobs = {}
        for leg, ranks, backend in (("nccl_1", 1, "nccl"),
                                    ("gloo_2", 2, "gloo")):
            jobs[leg] = run_job(post_dir, tmp / leg, ranks, backend)
            check_job(leg, jobs[leg], len(posts))
            launches += sum(r["k1_launches"] for r in jobs[leg]["ranks"])
            log(f"phase 9{'b' if ranks == 1 else 'c'}: {leg}: "
                f"{jobs[leg]['wall_s']:.3f} s for {len(posts)} reads = "
                f"{jobs[leg]['s_per_read']:.4f} s/read, "
                f"{jobs[leg]['crc_pass']} pass CRC; ranks "
                f"{json.dumps(jobs[leg]['ranks'])}")

        # (d) the two jobs' lists, and the in-process gated pick's
        lists = {leg: list_files(tmp / leg) for leg in jobs}
        if lists["nccl_1"] != lists["gloo_2"] or \
                len(lists["nccl_1"]) != len(posts):
            fail("phase 9d: the 1-rank nccl and 2-rank gloo jobs wrote "
                 "different list files")
        infos = {}
        for leg, ranks in (("nccl_1", 1), ("gloo_2", 2)):
            lines = [ln for pid in range(ranks) for ln in (
                tmp / leg / f"info_{pid}.txt").read_text().splitlines()]
            infos[leg] = dict(ln.split(" ") for ln in lines)
            if sorted(infos[leg]) != sorted(
                    f"read_{i}" for i in range(len(posts))) or \
                    len(lines) != len(posts):
                fail(f"phase 9d: {leg}'s info shards do not name every "
                     f"read once")
        if infos["nccl_1"] != infos["gloo_2"] or \
                jobs["nccl_1"]["crc_pass"] != jobs["gloo_2"]["crc_pass"]:
            fail("phase 9d: the jobs' orientations or CRC counts differ")
        pdec = PipelineDecoder(exp, 8, 20, device="cuda")
        torch.cuda.synchronize()
        k1_base = profiling.counter("acs.launches")
        t0 = time.perf_counter()
        crc, want = 0, {}
        for lo in range(0, len(posts), PARALLEL_BATCH):
            out, rc_used = pdec.decode_posts_auto_orientation(
                posts[lo:lo + PARALLEL_BATCH], 1 << exp.framing.index_len,
                gated=True)
            crc += int((out.index >= 0).sum())
            for j in range(len(rc_used)):
                i = lo + j
                want[f"list_{i}"] = "".join(
                    "".join(map(str, m)) + "\n"
                    for m, v in zip(out.msgs[j], out.valid[j]) if v)
                if infos["nccl_1"][f"read_{i}"] != f"rc={bool(rc_used[j])}":
                    fail(f"phase 9d: read_{i}'s orientation differs from "
                         f"the in-process gated pick")
        torch.cuda.synchronize()
        inproc_s = time.perf_counter() - t0
        d_launches = profiling.counter("acs.launches") - k1_base
        if d_launches == 0 or d_launches != pdec.steps:
            fail(f"phase 9d: {d_launches} K1 launches for {pdec.steps} "
                 f"block steps")
        launches += d_launches
        if lists["nccl_1"] != want or crc != jobs["nccl_1"]["crc_pass"]:
            fail("phase 9d: the jobs' lists differ from the in-process "
                 "decode_posts_auto_orientation(gated=True)")
        log(f"phase 9d: the {len(posts)} list files of both jobs identical "
            f"and equal to decode_posts_auto_orientation(gated=True) in "
            f"this process ({inproc_s:.3f} s, {d_launches} K1 launches for "
            f"{pdec.steps} block steps); {crc} pass CRC in each")

        # (e) the list commands on (b)'s lists
        infile = tmp / "data.bin"
        infile.write_bytes(data)
        oligos = tmp / "oligos.txt"
        oligos.write_text("".join(
            "".join(map(str, m)) + "\n"
            for m in frame_oligos(enc.payloads, exp.framing, pad=exp.pad)))
        lists_dir = str(tmp / "nccl_1")
        rs = cli.main(["rs-recover", "--experiment", "7", "--lists-dir",
                       lists_dir, "--data-size", str(len(data)),
                       "--num-reads", str(len(posts)), "--num-trials", "1",
                       "--infile", str(infile)])
        if rs["successes"] != 1:
            fail(f"phase 9e: rs-recover did not recover the file: {rs}")
        err = cli.main(["error-rate", "--experiment", "7", "--lists-dir",
                        lists_dir, "--oligos", str(oligos)])
        if err["num_reads"] != len(posts):
            fail(f"phase 9e: error-rate read {err['num_reads']} lists")
        log(f"phase 9e: rs-recover {json.dumps(rs)}, error-rate "
            f"{json.dumps(err)}")

    line = {"gpu": gpu, "reads": len(posts), "local_batch": PARALLEL_BATCH,
            "parent_reserved_gib": parent_gib, "free_gib": free_gib,
            "sharded_world1": {
                "B": len(fwd), "s": sharded_s, "k1_launches": a_launches,
                "steps": a_steps, "crc_pass": res.crc_pass_total,
                "nccl_group_s": nccl_s, "nccl_group_k1_launches":
                nccl_launches, "nccl_group_steps": nccl_steps,
                "classify_ms": classify_ms,
                "classify_device_ops": classify_ops,
                "classify_device_ms": classify_dev_ms,
                "host_check_ms": host_ms},
            **jobs,
            "in_process_gated": {"s": inproc_s, "s_per_read":
                                 inproc_s / len(posts),
                                 "k1_launches": d_launches,
                                 "steps": pdec.steps, "crc_pass": crc},
            "rs_recover": rs, "error_rate": err}
    return launches, line


def list_text(msgs, valid) -> str:
    """A list file's text: one decoded bit string a line, valid entries."""
    return "".join("".join(map(str, m)) + "\n" for m, v in zip(msgs, valid)
                   if v)


def barcoded_reads(enc, n: int, rng):
    """Phase 10a's reads: ``n`` random oligos with their barcodes, every
    second one reverse complement, through phase 3's channel errors and
    ``synthetic_post``. Returns (posts, rc flags)."""
    arr = str_to_bases(enc.oligos_barcoded)
    posts, rcs = [], []
    for i in range(n):
        oid = int(rng.integers(len(arr)))
        rc = i % 2 == 1
        noisy = simulate_indelsubs(arr[oid], rng, 0.004, 0.0085, 0.0005)
        posts.append(synthetic_post(noisy, rng, rc=rc))
        rcs.append(rc)
    return posts, np.asarray(rcs)


def run_cli_module(argv) -> dict:
    """``python -m nanopore_dna_storage_tpu_torch.cli`` with ``argv`` in a
    process of its own; fails unless it exits 0 with one JSON line last.
    The caller's cached device memory is handed back first."""
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run(
        [sys.executable, "-m", "nanopore_dna_storage_tpu_torch.cli", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        fail(f"cli {' '.join(argv[:1])} exited {res.returncode}:\n"
             f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def phase_real_data(enc, exp, data: bytes, gpu: str, exp_args):
    """Phase 10: the real-read path at the headline config. (a)
    ``REAL_READS`` barcoded reads (``barcoded_reads``); each read's
    basecall and ``.trans`` block indices from ``viterbi_flipflop_batch``
    on the card; ``.post``, ``.fastq`` and ``.trans`` files;
    ``cli decode-posts --with-barcodes`` (its ``main`` in this process, so
    that its K1 launches count) must account for every read in
    ``info.txt``, launch K1 once per block step and write the lists of an
    in-process ``PipelineDecoder.decode_posts`` on the windows that
    ``locate_payload`` gives, in the same batches; ``cli rs-recover`` on
    them must recover the file byte for byte; the barcode search and the
    decode are timed apart. (b) the same windows as truncated ``.post``
    files through ``python -m ...cli decode-posts`` without barcodes,
    whose lists and orientations must equal
    ``decode_posts_auto_orientation`` in process. (c) ``RAW_READS``
    barcoded raw-signal reads (``simulate_raw_reads``) through
    ``Basecaller.basecall(keep_posterior=True)`` on seeded random weights,
    then ``decode_posts_with_barcodes``: every read accounted for, one K1
    launch per block step. (d) the vocabulary goldens through
    ``decode_post_vocab`` on the card equal the reference's ``.out``, and
    a larger seeded case equal to the CPU's, timed. (e) the native host
    library: whether it was built, its three functions equal to numpy.
    ``exp_args`` are the CLI flags that give ``exp``. The K1 counts are set
    to 0 before each decode. Returns the K1 launches and the
    ``real_data`` line."""
    num_oligos = 1 << exp.framing.index_len
    min_blocks = make_conv_code(ConvCodeConfig(
        mem=exp.conv_mem, rate=exp.conv_rate,
        msg_len=exp.msg_len())).nstate_pos + 1
    dec_args = [*exp_args, "--list-size", "8", "--max-deviation", "20",
                "--batch", str(REAL_BATCH), "--device", "cuda"]
    launches = 0
    line = {"gpu": gpu, "reads": REAL_READS, "batch": REAL_BATCH}

    # (a) the reads, their basecalls on the card and the barcode search
    posts, rcs = barcoded_reads(enc, REAL_READS,
                                np.random.default_rng(SEED + 10))
    batch, nblk = pack_posts(posts, bucket=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths, _ = viterbi_flipflop_batch(torch.from_numpy(batch).cuda(),
                                      torch.from_numpy(nblk).cuda())
    paths = paths.cpu().numpy()
    calls, transes = zip(*(basecall_from_path(p, int(n))
                           for p, n in zip(paths, nblk)))
    line["basecall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    located = [locate_payload(c, t, exp) for c, t in zip(calls, transes)]
    line["barcode_search_s"] = time.perf_counter() - t0
    status = ["barcode_failure" if s < 0 else
              "too_short" if e - s + 1 < min_blocks else "ok"
              for _, s, e, _ in located]
    ok = [i for i, st in enumerate(status) if st == "ok"]
    wrong_rc = int(sum(located[i][0] != rcs[i] for i in ok))
    line.update(ok=len(ok), ok_share=len(ok) / REAL_READS,
                barcode_failure=status.count("barcode_failure"),
                too_short=status.count("too_short"), wrong_orientation=wrong_rc,
                blocks=[int(nblk.min()), int(nblk.max())])
    log(f"phase 10a: {REAL_READS} barcoded reads ({int(rcs.sum())} reverse "
        f"complement), {nblk.min()}-{nblk.max()} blocks; basecalls on the "
        f"card {line['basecall_s']:.3f} s; barcode search "
        f"{line['barcode_search_s']:.3f} s "
        f"({line['barcode_search_s'] / REAL_READS * 1e3:.2f} ms a read): "
        f"{len(ok)} ok ({line['ok_share']:.3f}), {line['barcode_failure']} "
        f"barcode failures, {line['too_short']} too short, {wrong_rc} ok "
        f"reads in the wrong orientation")

    # the in-process reference: decode_posts on the windows, in the batches
    # that decode_posts_with_barcodes forms (every REAL_BATCH ok reads)
    windows = {i: posts[i][located[i][1]:located[i][2] + 1] for i in ok}
    pdec = PipelineDecoder(exp, 8, 20, device="cuda")
    torch.cuda.synchronize()
    k1_base = profiling.counter("acs.launches")
    t0 = time.perf_counter()
    want, crc = {}, 0
    for lo in range(0, len(ok), REAL_BATCH):
        idx = ok[lo:lo + REAL_BATCH]
        out = pdec.decode_posts([windows[i] for i in idx],
                                [located[i][0] for i in idx], num_oligos)
        crc += int((out.index >= 0).sum())
        for j, i in enumerate(idx):
            want[f"list_{i}"] = list_text(out.msgs[j], out.valid[j])
    torch.cuda.synchronize()
    line["decode_s"] = time.perf_counter() - t0
    ref_launches = profiling.counter("acs.launches") - k1_base
    if ref_launches != pdec.steps:
        fail(f"phase 10a: {ref_launches} K1 launches for {pdec.steps} block "
             f"steps in the in-process decode")
    launches += ref_launches

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        whole, cut = tmp / "whole", tmp / "windows"
        whole.mkdir()
        cut.mkdir()
        for i, (p, c, t) in enumerate(zip(posts, calls, transes)):
            write_post(str(whole / f"read_{i:03d}.post"), p)
            (whole / f"read_{i:03d}.fastq").write_text(
                f"@read_{i:03d}\n{c}\n+\n{'5' * len(c)}\n")
            np.savetxt(whole / f"read_{i:03d}.trans", t, fmt="%d")
            if i in windows:
                write_post(str(cut / f"read_{i:03d}.post"), windows[i])
        torch.cuda.synchronize()
        k1_base = profiling.counter("acs.launches")
        t0 = time.perf_counter()
        rec, steps = cli.main(["decode-posts", "--with-barcodes",
                               "--post-dir", str(whole), "--outdir",
                               str(tmp / "out_a"), *dec_args])
        torch.cuda.synchronize()
        line["cli_s"] = time.perf_counter() - t0
        cli_launches = profiling.counter("acs.launches") - k1_base
        if cli_launches == 0 or cli_launches != steps or \
                steps != pdec.steps:
            fail(f"phase 10a: decode-posts made {cli_launches} K1 launches "
                 f"for {steps} block steps (in process: {pdec.steps})")
        launches += cli_launches
        info = (tmp / "out_a" / "info.txt").read_text().splitlines()
        got_status = [ln.split("\t")[1] for ln in info]
        if len(info) != REAL_READS or [ln.split("\t")[0] for ln in info] != \
                [f"read_{i:03d}" for i in range(REAL_READS)] or \
                got_status != status or rec["decoded"] != len(ok):
            fail(f"phase 10a: info.txt does not account for every read as "
                 f"the barcode search does: {rec}")
        if list_files(tmp / "out_a") != want:
            fail("phase 10a: decode-posts --with-barcodes wrote other lists "
                 "than decode_posts on the located windows")
        infile = tmp / "data.bin"
        infile.write_bytes(data)
        rs = cli.main(["rs-recover", *exp_args, "--lists-dir",
                       str(tmp / "out_a"), "--data-size", str(len(data)),
                       "--num-reads", str(REAL_READS), "--num-trials", "1",
                       "--infile", str(infile)])
        if rs["successes"] != 1:
            fail(f"phase 10a: rs-recover did not recover the file: {rs}")
        line.update(k1_launches_a=cli_launches, steps_a=steps, crc_pass=crc,
                    rs_recover=rs)
        log(f"phase 10a: decode-posts --with-barcodes {line['cli_s']:.3f} s "
            f"({line['cli_s'] / REAL_READS:.4f} s/read), {cli_launches} K1 "
            f"launches for {steps} block steps; in process decode_posts on "
            f"the windows {line['decode_s']:.3f} s "
            f"({line['decode_s'] / max(len(ok), 1):.4f} s a decoded read), "
            f"the same lists; {crc} of {len(ok)} pass CRC; rs-recover "
            f"{json.dumps(rs)}")

        # (b) the windows alone, through python -m ...cli
        t0 = time.perf_counter()
        rec_b = run_cli_module(["decode-posts", "--post-dir", str(cut),
                                "--outdir", str(tmp / "out_b"), *dec_args])
        line["cli_b_s"] = time.perf_counter() - t0
        files = sorted(cut.glob("*.post"))
        torch.cuda.synchronize()
        k1_base = profiling.counter("acs.launches")
        t0 = time.perf_counter()
        want_b, rc_b = {}, []
        adec = PipelineDecoder(exp, 8, 20, device="cuda")
        for lo in range(0, len(files), REAL_BATCH):
            out, use_rc = adec.decode_posts_auto_orientation(
                [read_post(str(f)) for f in files[lo:lo + REAL_BATCH]],
                num_oligos)
            for j in range(len(use_rc)):
                want_b[f"list_{lo + j}"] = list_text(out.msgs[j],
                                                     out.valid[j])
            rc_b += [f"rc={int(r)}" for r in use_rc]
        torch.cuda.synchronize()
        line["auto_orientation_s"] = time.perf_counter() - t0
        b_launches = profiling.counter("acs.launches") - k1_base
        if b_launches != adec.steps:
            fail(f"phase 10b: {b_launches} K1 launches for {adec.steps} "
                 f"block steps")
        launches += b_launches
        info_b = (tmp / "out_b" / "info.txt").read_text().splitlines()
        if rec_b != {"reads": len(files), "decoded": len(files)} or \
                list_files(tmp / "out_b") != want_b or \
                [ln.split("\t")[2] for ln in info_b] != rc_b:
            fail("phase 10b: decode-posts without barcodes differs from "
                 "decode_posts_auto_orientation in process")
        agree = int(sum(r == f"rc={int(located[i][0])}"
                        for r, i in zip(rc_b, ok)))
    line.update(k1_launches_b=b_launches, steps_b=adec.steps,
                orientation_agrees_with_barcodes=agree)
    log(f"phase 10b: python -m ...cli decode-posts on the {len(files)} "
        f"windows {line['cli_b_s']:.3f} s with the process start; in process "
        f"decode_posts_auto_orientation {line['auto_orientation_s']:.3f} s, "
        f"{b_launches} K1 launches for {adec.steps} block steps, the same "
        f"lists and orientations; the gated pick agrees with the barcodes' "
        f"orientation on {agree} of {len(files)}")

    # (c) raw signal -> basecaller on random weights -> the barcode path
    raws, _, _ = simulate_raw_reads(enc.oligos_barcoded, RAW_READS,
                                    np.random.default_rng(SEED + 11))
    ids = [f"raw_{i}" for i in range(RAW_READS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bcs = Basecaller(seed=SEED, device="cuda").basecall(
        ids, raws, keep_posterior=True)
    torch.cuda.synchronize()
    raw_basecall_s = time.perf_counter() - t0
    rdec = PipelineDecoder(exp, 8, 20, device="cuda")
    k1_base = profiling.counter("acs.launches")
    t0 = time.perf_counter()
    recs = decode_posts_with_barcodes(
        ids, [b.posterior for b in bcs], [b.sequence for b in bcs],
        [b.block_index for b in bcs], exp, 8, 20, decoder=rdec,
        batch=RAW_READS)
    torch.cuda.synchronize()
    raw_decode_s = time.perf_counter() - t0
    c_launches = profiling.counter("acs.launches") - k1_base
    if [r.read_id for r in recs] != ids or c_launches != rdec.steps:
        fail(f"phase 10c: {len(recs)} records for {RAW_READS} reads, "
             f"{c_launches} K1 launches for {rdec.steps} block steps")
    launches += c_launches
    raw_status = {st: sum(r.status == st for r in recs)
                  for st in ("ok", "barcode_failure", "too_short")}
    line["raw_signal"] = {
        "reads": RAW_READS, "basecall_s": raw_basecall_s,
        "decode_s": raw_decode_s, "status": raw_status,
        "bases": sum(len(b.sequence) for b in bcs),
        "k1_launches": c_launches, "steps": rdec.steps}
    log(f"phase 10c: {RAW_READS} raw-signal reads: Basecaller "
        f"{raw_basecall_s:.3f} s (random weights), decode_posts_with_barcodes"
        f" {raw_decode_s:.3f} s, {json.dumps(raw_status)}, {c_launches} K1 "
        f"launches for {rdec.steps} block steps")

    # (d) the vocabulary Viterbi on the card
    vocab = {}
    root = GOLDEN / "vocab"
    for case in json.loads((root / "manifest.json").read_text()):
        post = np.fromfile(root / f"{case['name']}.post",
                           dtype="<f4").reshape(-1, 5, 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = decode_post_vocab(post, case["msg_len"], case["vocab"],
                                device="cuda").tolist()
        sec = time.perf_counter() - t0
        if got != [int(x) for x in (root / f"{case['name']}.out")
                   .read_text().split()]:
            fail(f"phase 10d: vocab golden {case['name']} differs from the "
                 f"reference's .out")
        vocab[case["name"]] = {"blocks": len(post), "s": sec}
    rng = np.random.default_rng(SEED + 12)
    words = ["".join("ACGT"[j] for j in rng.integers(0, 4, VOCAB_WORD_LEN))
             for _ in range(VOCAB_WORDS)]
    msg = rng.integers(0, VOCAB_WORDS, VOCAB_MSG_LEN)
    post = synthetic_post(np.asarray(["ACGT".index(c) for c in "".join(
        words[m] for m in msg)]), rng)
    t0 = time.perf_counter()
    got = decode_post_vocab(post, VOCAB_MSG_LEN, words, device="cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_v = decode_post_vocab(post, VOCAB_MSG_LEN, words, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(got, want_v):
        fail("phase 10d: the larger vocab case differs between the card and "
             "the CPU")
    vocab["larger"] = {"words": VOCAB_WORDS, "msg_len": VOCAB_MSG_LEN,
                       "blocks": len(post), "s": card_s, "cpu_s": cpu_s,
                       "ms_a_block": card_s / len(post) * 1e3,
                       "message_recovered": bool(np.array_equal(got, msg))}
    line["vocab"] = vocab
    log(f"phase 10d: vocab goldens equal the reference's .out; the larger "
        f"case ({VOCAB_WORDS} words of {VOCAB_WORD_LEN}, msg_len "
        f"{VOCAB_MSG_LEN}, {len(post)} blocks) {card_s:.3f} s on the card "
        f"({vocab['larger']['ms_a_block']:.3f} ms a block), {cpu_s:.3f} s on "
        f"the CPU, equal; {json.dumps(vocab)}")

    # (e) the native host library against numpy
    t0 = time.perf_counter()
    built = native.available()
    build_s = time.perf_counter() - t0
    rows = np.random.default_rng(SEED).integers(0, 256, (4096, 23),
                                                dtype=np.uint8)
    needle = exp.start_barcode
    scans = [(c, np.arange(max(len(c) // 2 + 1 - len(needle), 0)))
             for c in calls]
    t0 = time.perf_counter()
    lev = [native.levenshtein_windows_native(needle, c, st, len(needle))
           for c, st in scans]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lev_np = [levenshtein_windows(needle, c, st, len(needle))
              for c, st in scans]
    numpy_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        names = []
        for i, p in enumerate(posts[:16]):
            names.append(str(pathlib.Path(tmp) / f"{i}.post"))
            write_post(names[-1], p)
        loaded = native.load_posts_batch(names, int(nblk.max()))
        packed = pack_posts([read_post(n) for n in names],
                            pad_to=int(nblk.max()), bucket=1)
    if not (np.array_equal(native.crc8_batch_native(rows), crc8_batch(rows))
            and all(np.array_equal(a, b) for a, b in zip(lev, lev_np))
            and all(np.array_equal(a, b) for a, b in zip(loaded, packed))):
        fail("phase 10e: the native library differs from numpy")
    line["native"] = {"built": built, "build_s": build_s,
                      "start_scan_native_s": native_s,
                      "start_scan_numpy_s": numpy_s}
    ran = "built" if built else "NOT built: the numpy fallback ran"
    log(f"phase 10e: native library {ran} ({build_s:.2f} s); CRC8, the "
        f"barcode scan and the .post loader equal to numpy; the "
        f"start-barcode scan of the "
        f"{REAL_READS} basecalls {native_s:.4f} s native, {numpy_s:.4f} s "
        f"numpy")
    line["k1_launches"] = launches
    return launches, line


def loss_and_grads(state, batch):
    """The CRF loss of ``state``'s net on ``batch`` and its gradient for
    every parameter, as ``train_step`` computes them, on its device."""
    with f32_matmul():
        loss = trainmod.crf_loss(state.net, *batch)
        grads = torch.autograd.grad(loss, state.opt.params)
    return float(loss.detach()), [g.cpu() for g in grads]


def phase_train_full() -> dict:
    """Phase 11a: the trainer at the published widths (``FlipflopConfig()``)
    on the production recipe. (1) The same ``init_params`` weights
    (``torch.Generator`` seed ``SEED``) and the first ``synthetic_batches``
    batch on the card and through the CPU: the loss within
    ``TRAIN_LOSS_TOL`` and every parameter's gradient within
    ``TRAIN_GRAD_TOL`` of its largest component, the card's computed under
    ``torch.set_float32_matmul_precision("high")``. (2) ``TRAIN_STEPS``
    ``train_step``s on the card over fresh batches (made before the clock
    starts), each between two synchronisations; every loss finite. (3) One
    more step under ``torch.profiler``: its device operations and time.
    Returns the ``11a`` entry of the ``train`` line."""
    cfg = FlipflopConfig()
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    pad_T = TRAIN_SEQ_LEN * 12
    gen = trainmod.synthetic_batches(
        np.random.default_rng(SEED), TRAIN_BATCH, TRAIN_SEQ_LEN, pad_T,
        TRAIN_SEQ_LEN + 2, kmer=TRAIN_KMER, device="cpu")
    batches = [next(gen)[:4] for _ in range(TRAIN_STEPS + 2)]
    init_c, step_c = trainmod.make_trainer(cfg, TRAIN_LR, TRAIN_STEPS + 1,
                                           device="cuda")
    init_h, _ = trainmod.make_trainer(cfg, TRAIN_LR, TRAIN_STEPS + 1,
                                      device="cpu")
    card = init_c(params=params)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        loss_c, grads_c = loss_and_grads(card, [x.cuda() for x in batches[0]])
    finally:
        torch.set_float32_matmul_precision(before)
    t0 = time.perf_counter()
    loss_h, grads_h = loss_and_grads(init_h(params=params), batches[0])
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    if not (np.isfinite(loss_c) and loss_err <= TRAIN_LOSS_TOL):
        fail(f"phase 11a: the card's loss {loss_c} against the CPU's "
             f"{loss_h}")
    grad_err = {}
    for (name, _), gc, gh in zip(card.net.named_parameters(), grads_c,
                                 grads_h):
        grad_err[name] = float((gc - gh).abs().max() / gh.abs().max())
        if not grad_err[name] <= TRAIN_GRAD_TOL:
            fail(f"phase 11a: {name}'s gradient on the card is "
                 f"{grad_err[name]} of its largest component off the CPU's")
    log(f"phase 11a: loss {loss_c:.6f} on the card, {loss_h:.6f} on the CPU "
        f"({cpu_s:.2f} s there), relative error {loss_err:.3g}; gradients "
        f"within {max(grad_err.values()):.3g} of each largest component "
        f"(tolerance {TRAIN_GRAD_TOL}; TF32 asked for and refused)")

    batches = [[x.cuda() for x in b] for b in batches[1:]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for b in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        losses.append(float(step_c(card, *b)))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"phase 11a: a loss is not finite: {losses}")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_c(card, *batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    ops, dev_ms = device_ops(prof)
    steady = float(np.mean(step_s[1:]))
    log(f"phase 11a: {TRAIN_STEPS} steps at B={TRAIN_BATCH}, T={pad_T} "
        f"samples: first {step_s[0]:.3f} s, then {steady:.4f} s/step; one "
        f"step {ops} device ops, device {dev_ms:.2f} ms of {prof_s:.3f} s "
        f"(idle share {1 - dev_ms / 1e3 / prof_s:.4f}); peak "
        f"{peak / 2**30:.3f} GiB; losses {[round(x, 4) for x in losses]}")
    return {"widths": dataclasses.asdict(cfg), "batch": TRAIN_BATCH,
            "seq_len": TRAIN_SEQ_LEN, "T": pad_T, "kmer": TRAIN_KMER,
            "lr": TRAIN_LR, "steps": TRAIN_STEPS,
            "loss_card": loss_c, "loss_cpu": loss_h,
            "loss_rel_err": loss_err, "loss_tolerance": TRAIN_LOSS_TOL,
            "grad_rel_err": grad_err, "grad_tolerance": TRAIN_GRAD_TOL,
            "cpu_grad_s": cpu_s, "step_s": step_s, "s_per_step": steady,
            "step_device_ops": ops, "step_device_ms": dev_ms,
            "profiled_step_s": prof_s,
            "idle_share": 1 - dev_ms / 1e3 / prof_s,
            "peak_gib": peak / 2**30, "losses": losses}


def timed_sections() -> dict:
    """The seconds of ``simulate_and_decode_signal``'s train and decode
    sections since the last ``profiling.reset_timings``."""
    return {k.split("/")[1]: v["total_s"]
            for k, v in profiling.timing_summary().items()
            if k.startswith("simulate_signal/")}


def phase_train(enc, exp, gpu: str):
    """Phase 11: the training path. (a) ``phase_train_full``. (b)
    ``simulate_and_decode_signal(params=None)`` on the card at
    ``tests/test_signal_fidelity.py``'s settings (m=6 r=1, 4 bytes an
    oligo, RS 0.5, 24 reads, L=4, max deviation 16, 300 steps, kmer 1):
    its floor (list_correct >= reads / 2, crc_pass >= list_correct,
    unique_indices >= 3), its train and decode seconds apart
    (``utils/profiling.timed``), one K1 launch per block step. (c) 11b's
    trained basecaller decoding ``TRAINED_READS`` experiment-7 reads of
    ``enc`` (L=8, max deviation 20) through
    ``simulate_and_decode_signal(params=net)``, one K1 launch per block
    step; the accuracy is reported, not gated. (d) ``cli simulate-signal``
    in this process at 11b's code and a short training, printing the JAX
    command's keys. The K1 counts are set to 0 before each of (b)-(d).
    Returns the K1 launches of (b)-(d) and the ``train`` line."""
    line = {"gpu": gpu, "11a": phase_train_full()}
    torch.cuda.empty_cache()
    fexp = ExperimentConfig(**FIDELITY_EXP)
    data = np.random.default_rng(2).integers(0, 256, 24,
                                             dtype=np.uint8).tobytes()
    launches = {}

    profiling.reset_timings()
    k1_base = profiling.counter("acs.launches")
    stats, net = simulate_and_decode_signal(
        encode_bytes(data, fexp), fexp, num_reads=FIDELITY_READS,
        list_size=4, seed=3, max_deviation=16, train_steps=FIDELITY_STEPS,
        kmer=1, device="cuda")
    launches["11b"] = profiling.counter("acs.launches") - k1_base
    secs = timed_sections()
    log(f"phase 11b: simulate_and_decode_signal(params=None): train "
        f"{FIDELITY_STEPS} steps {secs['train']:.3f} s "
        f"({secs['train'] / FIDELITY_STEPS:.4f} s/step), decode "
        f"{secs['decode']:.3f} s; {json.dumps(vars(stats))}; "
        f"{launches['11b']} K1 launches")
    if launches["11b"] == 0 or launches["11b"] != stats.steps:
        fail(f"phase 11b: {launches['11b']} K1 launches for {stats.steps} "
             f"block steps")
    if not (stats.num_reads == FIDELITY_READS
            and stats.list_correct >= stats.num_reads * 0.5
            and stats.crc_pass >= stats.list_correct
            and stats.unique_indices >= 3):
        fail(f"phase 11b: under test_signal_fidelity's floor: {vars(stats)}")
    line["11b"] = {"reads": FIDELITY_READS, "train_steps": FIDELITY_STEPS,
                   "train_s": secs["train"], "decode_s": secs["decode"],
                   "s_per_train_step": secs["train"] / FIDELITY_STEPS,
                   "stats": vars(stats), "k1_launches": launches["11b"]}

    profiling.reset_timings()
    k1_base = profiling.counter("acs.launches")
    stats7, _ = simulate_and_decode_signal(
        enc, exp, num_reads=TRAINED_READS, params=net, list_size=8,
        seed=SEED, max_deviation=20, kmer=1, batch=TRAINED_BATCH,
        device="cuda")
    launches["11c"] = profiling.counter("acs.launches") - k1_base
    secs = timed_sections()
    log(f"phase 11c: the trained basecaller on {TRAINED_READS} "
        f"experiment-7 reads: decode {secs['decode']:.3f} s; "
        f"{json.dumps(vars(stats7))}; {launches['11c']} K1 launches")
    if launches["11c"] == 0 or launches["11c"] != stats7.steps:
        fail(f"phase 11c: {launches['11c']} K1 launches for {stats7.steps} "
             f"block steps")
    line["11c"] = {"reads": TRAINED_READS, "batch": TRAINED_BATCH,
                   "decode_s": secs["decode"], "stats": vars(stats7),
                   "k1_launches": launches["11c"]}

    argv = ["simulate-signal", *SIGNAL_CLI_ARGS, "--seed", str(SEED),
            "--device", "cuda"]
    log("phase 11d: cli " + " ".join(argv[1:]))
    k1_base = profiling.counter("acs.launches")
    t0 = time.perf_counter()
    rec, stats_d = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches["11d"] = profiling.counter("acs.launches") - k1_base
    if list(rec) != SIGNAL_CLI_KEYS or rec["num_reads"] != 8:
        fail(f"phase 11d: simulate-signal printed {rec}")
    if launches["11d"] != stats_d.steps:
        fail(f"phase 11d: {launches['11d']} K1 launches for "
             f"{stats_d.steps} block steps")
    log(f"phase 11d: {cli_s:.3f} s, {launches['11d']} K1 launches")
    line["11d"] = {"argv": argv[1:], "s": cli_s, "record": rec,
                   "k1_launches": launches["11d"]}
    return sum(launches.values()), line


def list_size_cell(data: bytes, e: int, L: int, B: int, batch: int,
                   reads: int) -> dict:
    """One cell of phase 13, experiment ``e`` at list size ``L``: (a) K1
    against its plain version on one simulated read, blocks at position 0,
    spread over the read and at its end bit-equal with the rows sorted, one
    of them also with the read made inactive, the middle block timed; (b)
    the same on ``B`` forward reads of different lengths, the first block
    that mixes active and inactive reads checked; (c) the decode of those
    ``B`` reads with the kernel alone, its forward and its traceback timed
    apart; (d) ``sim-decode`` on ``data`` from ``reads`` reads in batches
    of ``batch``, the file recovered byte for byte with one K1 launch per
    forward block step. Returns the cell's record."""
    tag = f"phase 13 (experiment {e}, L={L})"
    exp = experiment(e)
    enc = encode_bytes(data, exp)
    posts, rcs, _ = simulate_posts(enc.oligos, 4 * B,
                                   np.random.default_rng(SEED))
    fwd = [p for p, rc in zip(posts, rcs) if not rc][:B]
    if len(fwd) < B:
        fail(f"{tag}: {len(fwd)} forward reads for B={B}")
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                            msg_len=exp.msg_len()),
        list_size=L, max_deviation=20), device="cuda")
    C, W = dec.spec.code.nstate_conv, dec.spec.window
    info = lva_acs.kernel_info(L)
    log(f"{tag}: m={exp.conv_mem} r={exp.conv_rate} msg_len "
        f"{exp.msg_len()} C={C} W={W} P={dec.spec.npos_pad}; nblk "
        f"{[len(p) for p in fwd]}; kernel_info({L}) {json.dumps(info)}")
    rec = {"experiment": e, "mem": exp.conv_mem, "rate": exp.conv_rate,
           "msg_len": exp.msg_len(), "list_size": L, "C": C, "W": W,
           "kernel_info": info}
    for n in sorted({1, B}):
        batch_posts, nblks = pack_posts(fwd[:n])
        T = int(nblks.min())
        blocks = {0, 1, T // 4, T // 2, 3 * T // 4, int(nblks.max()) - 1}
        check = CheckedACS(timed=T // 2, check=blocks.__contains__,
                           inactive=T // 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, valid = dec.decode(batch_posts, nblks, acs=check)
        if check.checked < len(blocks) or not valid[:, 0].all() or (
                n > 1 and check.mixed == 0):
            fail(f"{tag}: B={n}: {check.checked} blocks checked, "
                 f"{check.mixed} mixed, top entries valid {valid[:, 0]}")
        start1, active = check.timed_args
        b = acs_bound(dec, start1, active, check.needed)
        log(f"{tag}: B={n}: {check.checked} of {check.blocks} blocks "
            f"bit-equal, rows sorted, block {T // 4} also inactive "
            f"({time.perf_counter() - t0:.1f} s); block {T // 2}: kernel "
            f"{check.ms:.4f} ms, plain {check.plain_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({check.needed} "
            f"bytes, {b['needed_ops']} ops), "
            f"{100 * b['bound_ms'] / check.ms:.1f}% of it")
        rec[f"B{n}"] = {"ms": check.ms, "plain_ms": check.plain_ms,
                        "bound": b, "share_of_bound": b["bound_ms"] / check.ms,
                        "blocks_checked": check.checked,
                        "max_abs_err": check.err}

    batch_posts, nblks = pack_posts(fwd)
    probe = Probe(int(nblks.max()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.decode(batch_posts, nblks, acs=probe)
    t1 = time.perf_counter()
    rec[f"decode_B{B}"] = {"forward_s": probe.t_fwd - t0,
                           "traceback_s": t1 - probe.t_fwd,
                           "traceback_share": (t1 - probe.t_fwd) / (t1 - t0)}
    log(f"{tag}: decode of B={B}: forward {probe.t_fwd - t0:.3f} s, "
        f"traceback and ordering {t1 - probe.t_fwd:.3f} s")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim, stats, launches, wall, tb_launches = phase_sim_decode(data, [
        "--experiment", str(e), "--list-size", str(L), "--num-reads",
        str(reads), "--batch", str(batch), "--seed", str(SEED),
        "--device", "cuda"], tag=tag)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches == 0 or launches != stats.steps:
        fail(f"{tag}: {launches} K1 launches for {stats.steps} block steps")
    log(f"{tag}: sim-decode peak device memory {peak:.2f} GiB")
    rec["sim_decode"] = {"reads": stats.num_reads, "batch": batch, "s": wall,
                         "s_per_read": wall / stats.num_reads,
                         "k1_launches": launches, "block_steps": stats.steps,
                         "traceback_launches": tb_launches,
                         "peak_gib": peak, "record": sim}
    return rec


def phase_list_sizes(data: bytes, gpu: str):
    """Phase 13: the paper's other list sizes, ``LIST_SIZE_CELLS`` through
    ``list_size_cell`` on the 100-byte file, with the K1 count set to 0
    just before each cell's sim-decode. Returns the K1 launches of the
    sim-decodes by cell and the ``list_sizes`` line."""
    torch.cuda.empty_cache()
    line = {"gpu": gpu}
    for e, L, B, batch, reads in LIST_SIZE_CELLS:
        line[f"exp{e}_L{L}"] = list_size_cell(data, e, L, B, batch, reads)
    return {k: v["sim_decode"]["k1_launches"] for k, v in line.items()
            if k != "gpu"}, line


def phase_bench(gpu: str):
    """Phase 14: the decode benchmark (``bench.py``) in this process,
    ``bench.main`` on each of ``BENCH_RUNS`` with ``--verify`` and the K1
    count set to 0 just before it: its one JSON line with a rate above 0
    and ``lists_match`` true (the config's goldens, and gate (b): the
    timed loop's first batch decoded again, its checked block steps
    bit-equal to ``acs_block_ref``, every row sorted, each read's lists
    those the timed loop gave), one K1 launch per forward block step of
    its warm-up and timed loop. Returns the K1 launches of those loops and
    the ``bench`` line."""
    torch.cuda.empty_cache()
    line = {"gpu": gpu}
    launches = 0
    for argv in BENCH_RUNS:
        argv = [*argv, "--verify"]
        buf = io.StringIO()
        torch.cuda.synchronize()
        k1_base = profiling.counter("acs.launches")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(argv)
        secs = time.perf_counter() - t0
        run_launches = profiling.counter("acs.launches") - k1_base
        out = buf.getvalue().splitlines()
        rec = json.loads(out[-1]) if out else {}
        log(f"phase 14: bench {' '.join(argv)}: exit {rc}, {secs:.1f} s, "
            f"{run_launches} K1 launches in all: {json.dumps(rec)}")
        gate = (rec.get("gate") or {}).get("bench_reads") or {}
        if rc != 0 or len(out) != 1 or not (rec.get("value") or 0) > 0 \
                or rec.get("lists_match") is not True:
            fail(f"phase 14: bench {' '.join(argv)} failed: {out}")
        if not (gate["checked"] > 0 and gate["blocks_differ"] == 0
                and gate["blocks_unsorted"] == 0
                and gate["reads"] == rec["batch"]):
            fail(f"phase 14: gate (b) of {' '.join(argv)}: {gate}")
        if rec["k1_launches"] == 0 or rec["k1_launches"] != \
                rec["block_steps"]:
            fail(f"phase 14: {rec['k1_launches']} K1 launches for "
                 f"{rec['block_steps']} block steps")
        launches += rec["k1_launches"]
        line[rec["metric"]] = {"argv": argv, "s": secs,
                               "k1_launches_all": run_launches, "line": rec}
    return launches, line


def report_part(tag: str, fn):
    """One part of phase 12, with the K1 count set to 0 just before it and
    the peak memory reset: (its result, seconds, K1 launches, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_base = profiling.counter("acs.launches")
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = profiling.counter("acs.launches") - k1_base
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase {tag}: {secs:.3f} s, {launches} K1 launches, peak "
        f"{peak:.3f} GiB")
    return out, secs, launches, peak


def phase_reports(gpu: str):
    """Phase 12: the report layer (``reports/``) at experiment 7 through
    each report's ``run``, the function its ``main`` calls. (a)
    ``file_recovery`` on a ``REPORT_FILE_SIZE``-byte file from
    ``REPORT_READS`` reads, ``REPORT_BATCH`` a chunk, saving its state: the
    file recovered byte for byte. (b) ``read_cost`` on the same file and
    reads: its sweep's last count succeeding in every trial, ``min_reads``
    set. (c) ``basecall_error`` at the fidelity report's widths and recipe
    for ``PROBE_STEPS`` steps, saving its weights: every loss finite, the
    saved file the net under the JAX package's names, the held-out edit
    distances within ``PROBE_EDIT_TOL`` of the CPU's on the same net. (d)
    ``signal_fidelity`` on that cache, with no training:
    ``FIDELITY_REPORT_READS`` reads, every one accounted for. (a), (b) and
    (d) launch K1 once per forward block step, (c) never. Returns the K1
    launches of (a)-(d) and the ``reports`` line."""
    torch.cuda.empty_cache()
    exp = experiment(7)
    line = {"gpu": gpu, "file_size": REPORT_FILE_SIZE}
    total = 0

    def part_log(tag):
        return lambda msg: log(f"phase {tag}: {msg}")

    def entry(tag, secs, launches, steps, peak, reads=None):
        nonlocal total
        if launches != steps:
            fail(f"phase {tag}: {launches} K1 launches for {steps} block "
                 f"steps")
        total += launches
        e = {"s": secs, "k1_launches": launches, "block_steps": steps,
             "peak_gib": peak}
        if reads:
            e.update(reads=reads, s_per_read=secs / reads)
        return e

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(experiment_id=7, reads=REPORT_READS, list_size=8,
                  batch=REPORT_BATCH, max_deviation=20, seed=SEED,
                  device="cuda")
        (rec, steps), secs, n, peak = report_part("12a", lambda: (
            file_recovery.run(exp, REPORT_FILE_SIZE, state=f"{tmp}/frec",
                              log=part_log("12a"), **kw)))
        log(f"phase 12a: {json.dumps(rec)}")
        if not (rec["file_bytes_match"] and rec["rs_decode_ok"]
                and rec["reads_used"] == REPORT_READS and steps > 0):
            fail(f"phase 12a: the file was not recovered: {rec}")
        line["12a"] = {**entry("12a", secs, n, steps, peak, REPORT_READS),
                       "record": rec}

        (rec, steps), secs, n, peak = report_part("12b", lambda: (
            read_cost.run(exp, REPORT_FILE_SIZE, step=REPORT_STEP,
                          num_trials=REPORT_TRIALS, state=f"{tmp}/rcost",
                          log=part_log("12b"), **kw)))
        log(f"phase 12b: {json.dumps(rec)}")
        last = rec["sweep"][-1]
        if not (last["num_reads"] == REPORT_READS
                and last["successes"] == REPORT_TRIALS
                and rec["min_reads_all_trials"] is not None and steps > 0):
            fail(f"phase 12b: the sweep's last count failed a trial or no "
                 f"count succeeded in all: {rec}")
        line["12b"] = {**entry("12b", secs, n, steps, peak, REPORT_READS),
                       "record": rec}

        cache = f"{tmp}/fidelity_params.npz"
        (rec, net), secs, n, peak = report_part("12c", lambda: (
            basecall_error.run(
                signal_fidelity.MODEL_CFG, steps=PROBE_STEPS, kmer=6,
                batch=8, seq_len=signal_fidelity.TRAIN_SEQ_LEN,
                lr=signal_fidelity.LEARNING_RATE, schedule=True,
                eval_reads=PROBE_EVAL_READS, eval_len=PROBE_EVAL_LEN,
                seed=1, device="cuda", save=cache)))
        log(f"phase 12c: {json.dumps(rec)}")
        if not np.isfinite(rec["final_loss"]):
            fail(f"phase 12c: the loss is not finite: {rec}")
        saved = signal_fidelity.load_cache(cache, "cpu")
        for (name, p), (_, q) in zip(net.named_parameters(),
                                     saved.named_parameters()):
            if not torch.equal(p.cpu(), q):
                fail(f"phase 12c: the saved {name} is not the trained one")
        eval_kw = dict(kmer=6, eval_reads=PROBE_EVAL_READS,
                       eval_len=PROBE_EVAL_LEN, seed=1)
        card = sum(basecall_error.evaluate(net, **eval_kw))
        host = sum(basecall_error.evaluate(saved, **eval_kw))
        bases = PROBE_EVAL_READS * PROBE_EVAL_LEN
        if abs(card - host) > PROBE_EDIT_TOL * bases:
            fail(f"phase 12c: {card} edits on the card against {host} on "
                 f"the CPU over {bases} bases")
        log(f"phase 12c: edits {card} on the card, {host} on the CPU, of "
            f"{bases} bases")
        line["12c"] = {**entry("12c", secs, n, 0, peak),
                       "s_per_step": secs / PROBE_STEPS,
                       "edits_card": card, "edits_cpu": host,
                       "record": rec}

        (rec, _, stats), secs, n, peak = report_part("12d", lambda: (
            signal_fidelity.run(
                exp, signal_fidelity.fidelity_data(exp, 1), experiment_id=7,
                reads=FIDELITY_REPORT_READS, train_steps=PROBE_STEPS,
                batch=FIDELITY_REPORT_READS, seed=1,
                params=signal_fidelity.load_cache(cache, "cuda"),
                device="cuda")))
        log(f"phase 12d: {json.dumps(rec)}")
        if not (rec["num_reads"] == FIDELITY_REPORT_READS
                and rec["num_correct"] + rec["num_erasure_CRC"]
                + rec["num_error_CRC"] == FIDELITY_REPORT_READS
                and stats.steps > 0):
            fail(f"phase 12d: {rec}")
        line["12d"] = {**entry("12d", secs, n, stats.steps, peak,
                               FIDELITY_REPORT_READS), "record": rec}
    return total, line


def traceback_info(L: int, Mw: int) -> dict:
    """Registers, local bytes, resident threads per SM and the shared memory
    a launch may stage the beam starts in, of the traceback kernel's build
    for list size ``L`` and ``Mw`` message words; fails if it uses local
    memory."""
    lib = _build.load_lva_traceback()
    out = (ctypes.c_int * 4)()
    err = lib.lva_traceback_info(L, Mw, out)
    if err != 0:
        fail(f"lva_traceback_info: "
             f"{lib.lva_traceback_error_string(err).decode()}")
    info = {"registers": out[0], "local_bytes": out[1],
            "threads_per_sm": out[2], "stage_limit_bytes": out[3]}
    if info["local_bytes"]:
        fail(f"the traceback kernel at L = {L}, Mw = {Mw} uses local "
             f"memory: {info}")
    return info


def round_trip_us(nbytes: int) -> float:
    """A dependent load's round trip in us: one thread's chase through
    ``nbytes`` of int64 hops, one a 128-byte line, every line visited in a
    random order (``lva_traceback_round_trip``), over ``ROUND_TRIP_HOPS``
    hops by CUDA events; fails unless the chase ends where the hops
    say."""
    lib = _build.load_lva_traceback()
    stride = 16  # int64 a 128-byte line
    lines = nbytes // (8 * stride)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    order = torch.randperm(lines, device="cuda", generator=g) * stride
    nxt = torch.zeros(lines * stride, dtype=torch.int64, device="cuda")
    nxt[order] = order.roll(-1)
    end = torch.empty(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def chase(hops):
        err = lib.lva_traceback_round_trip(nxt.data_ptr(), hops,
                                           end.data_ptr(), stream)
        if err != 0:
            fail(f"lva_traceback_round_trip: "
                 f"{lib.lva_traceback_error_string(err).decode()}")

    # a 256 MiB write evicts from the L2 what building the hops left there;
    # then a chase that revisits its lines first walks them all once, and a
    # longer cycle takes one hop (which loads the kernel): a warm-up of the
    # timed hops would leave them in the L2 for it
    torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_()
    chase(lines if lines <= ROUND_TRIP_HOPS else 1)
    ms = cuda_ms(lambda: chase(ROUND_TRIP_HOPS), 1, 0)
    at = int((order == 0).nonzero()[0, 0])
    if int(end) != int(order[(at + ROUND_TRIP_HOPS) % lines]):
        fail("the round-trip chase did not end where its hops lead")
    return 1e3 * ms / ROUND_TRIP_HOPS


class CheckedTraceback:
    """``lva_decode.traceback`` replaced inside a decode: the kernel and the
    plain loop on the same forward outputs, both timed by CUDA events, the
    results bit-equal; returns the kernel's. Records the times, the steps
    and the bytes the kernel needs."""

    def __init__(self, real, round_trip: float, l2_round_trip: float):
        self.real = real
        self.round_trip = round_trip
        self.l2_round_trip = l2_round_trip
        self.rec = None

    def __call__(self, spec, consts, tabs, sels, starts, nblks, tlo, thi):
        args = (spec, consts, tabs, sels, starts, nblks, tlo, thi)
        before = profiling.counter("traceback.launches")
        out = self.real(*args)
        if profiling.counter("traceback.launches") != before + 1:
            fail("the traceback on the card did not launch its kernel once")
        ms = cuda_ms(lambda: self.real(*args), TRACEBACK_REPS)
        plain_ms = cuda_ms(lambda: lva_decode.traceback_ref(*args), 1, 0)
        want = lva_decode.traceback_ref(*args)
        for name, got, ref in zip(("words", "okend"), out, want):
            if not torch.equal(got, ref):
                fail(f"phase 15: the kernel's {name} differ from the plain "
                     f"loop's")
        T, B, W, nch, C = sels.shape
        # a chain acts at most once a block: the longest takes at most the
        # longest read's blocks in steps, each one code; the per-read
        # inputs and the outputs once
        longest = int(nblks.max())
        nbytes = (T * B * nch * sels.element_size() + starts.numel() * 8
                  + (tlo.numel() + thi.numel()) * 8
                  + out[0].numel() * 8 + out[1].numel())
        self.rec = {"T": T, "B": B, "chains": B * nch, "W": W, "C": C,
                    "Mw": spec.n_msg_words, "ms": ms, "plain_ms": plain_ms,
                    "plain_ms_per_block": plain_ms / T,
                    "longest_chain_steps": longest, "bytes": nbytes,
                    "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                    "round_trip_us": self.round_trip,
                    "latency_floor_ms": longest * self.round_trip / 1e3,
                    # the floor were every step's code already in L2
                    "l2_latency_floor_ms":
                        longest * self.l2_round_trip / 1e3,
                    "us_per_step_of_longest": 1e3 * ms / longest,
                    "okend": int(out[1].sum())}
        return out


def phase_traceback(data: bytes, gpu: str) -> dict:
    """Phase 15: the traceback kernel against the plain loop at each of
    ``TRACEBACK_CELLS``'s shapes, on one batch of forward reads of the
    experiment decoded with ``CheckedTraceback`` in the traceback's place.
    Returns the phase's record, with the device-memory round trip its
    latency floors are counted in (``round_trip_us``)."""
    rt = round_trip_us(ROUND_TRIP_BYTES)
    rt_l2 = round_trip_us(ROUND_TRIP_L2_BYTES)
    log(f"phase 15: a dependent load's round trip over "
        f"{ROUND_TRIP_BYTES >> 20} MiB {rt:.4f} us, over "
        f"{ROUND_TRIP_L2_BYTES >> 20} MiB (in L2) {rt_l2:.4f} us")
    line = {"gpu": gpu, "round_trip_us": rt, "l2_round_trip_us": rt_l2}
    for e, L, B in TRACEBACK_CELLS:
        tag = f"phase 15 (experiment {e}, L={L}, B={B})"
        exp = experiment(e)
        enc = encode_bytes(data, exp)
        posts, rcs, _ = simulate_posts(enc.oligos, 4 * B,
                                       np.random.default_rng(SEED))
        fwd = [p for p, rc in zip(posts, rcs) if not rc][:B]
        if len(fwd) < B:
            fail(f"{tag}: {len(fwd)} forward reads for B={B}")
        dec = LVADecoder(DecodeConfig(
            code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                                msg_len=exp.msg_len()),
            list_size=L, max_deviation=20), device="cuda")
        info = traceback_info(L, dec.spec.n_msg_words)
        batch_posts, nblks = pack_posts(fwd)
        check = CheckedTraceback(lva_decode.traceback, rt, rt_l2)
        lva_decode.traceback = check
        try:
            _, _, valid = dec.decode(batch_posts, nblks)
        finally:
            lva_decode.traceback = check.real
        if check.rec is None or not valid[:, 0].all():
            fail(f"{tag}: traceback not checked, or top entries invalid: "
                 f"{valid[:, 0]}")
        r = {**check.rec, "kernel_info": info}
        r["bound_ms"], r["bound_by"] = max(
            (r["bytes_ms"], "bytes"), (r["latency_floor_ms"], "latency"))
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        log(f"{tag}: nblk {nblks.min()}-{nblks.max()}, {r['chains']} "
            f"chains, words and okend bit-equal to the plain loop; kernel "
            f"{r['ms']:.4f} ms, plain loop {r['plain_ms']:.1f} ms "
            f"({r['plain_ms_per_block']:.4f} ms a block); longest chain "
            f"at most {r['longest_chain_steps']} steps "
            f"({r['us_per_step_of_longest']:.3f} us a step); bound "
            f"{r['bytes_ms']:.4f} ms by bytes ({r['bytes']} B), "
            f"{r['latency_floor_ms']:.4f} ms by latency at {rt:.4f} us a "
            f"round trip, {100 * r['share_of_bound']:.1f}% of it "
            f"({r['l2_latency_floor_ms']:.4f} ms at the L2's); "
            f"kernel_info {json.dumps(info)}")
        line[f"exp{e}"] = r
    return line


def main() -> int:
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_kernels()
    resources = {f"L{L}": acs_resources(L=L) for L in (8, 12, 64)}
    for k, v in resources.items():
        log(f"phase 0: ACS kernel at {k}: {json.dumps(v)}")
    # the lse kernel's register bucket and its two lane buckets
    lse_resources = {f"L{L}": acs_resources(lse=True, L=L)
                     for L in (8, 12, 64)}
    for k, v in lse_resources.items():
        log(f"phase 0: lse ACS kernel at {k}: {json.dumps(v)}")
    log(f"phase 0: done in {time.perf_counter() - t0:.1f} s")

    data = np.random.default_rng(SEED).integers(
        0, 256, 100, dtype=np.uint8).tobytes()
    exp = experiment(7)
    enc = encode_bytes(data, exp)
    posts, rcs, _ = simulate_posts(enc.oligos, 1,
                                   np.random.default_rng(SEED + 1))
    headline = DecodeConfig(
        code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                            msg_len=exp.msg_len(), rc=bool(rcs[0])),
        list_size=8, max_deviation=20)
    t0 = time.perf_counter()
    dec = LVADecoder(headline, device="cuda")
    acs_ms, _, err, acs_start1 = phase_kernel(dec, posts[0])
    phase_bucket(headline, posts[0])
    log(f"phase 1: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (B, ms, plain_ms), (start1, active), nbytes, err_b = phase_batch(
        enc, exp, "cuda")
    log(f"phase 1b: done in {time.perf_counter() - t0:.1f} s")
    acs = acs_bound(dec, start1, active, nbytes)
    log(f"lva_acs bound at B={B}: {acs['needed_ops']} needed ops over the "
        f"lane peak, {nbytes} bytes needed ({acs['bytes_every_slot']} "
        f"with every slot): {acs['bound_ms']:.4f} ms, by {acs['bound_by']}")
    err = max(err, err_b)
    lva_line = {
        "gpu": gpu, "ms_B1": acs_ms, f"ms_B{B}": ms, **resources,
        f"bound_B{B}": acs, "share_of_bound": acs["bound_ms"] / ms,
        "share_of_bytes_every_slot": acs["bytes_every_slot_ms"] / ms}

    t0 = time.perf_counter()
    n = phase_goldens("cuda")
    log(f"phase 2: {n} goldens identical in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    _, stats, launches, wall, tb_launches = phase_sim_decode(data, [
        "--experiment", "7", "--list-size", "8", "--num-reads", "32",
        "--batch", "8", "--seed", str(SEED), "--device", "cuda"])
    log(f"phase 3: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; done in "
        f"{wall:.1f} s")
    if launches == 0 or launches != stats.steps:
        fail(f"{launches} kernel launches for {stats.steps} block steps")

    t0 = time.perf_counter()
    floor_us = lowering.launch_floor_us()
    log(f"phase 4: launch floor (an empty kernel, CUDA graphs of "
        f"{expand.GRAPH_CALLS}): {floor_us:.4f} us")
    probes, roofline, probes_line = phase_probes(dec, acs_ms, acs_start1,
                                                 floor_us)
    log(f"phase 4: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    expansions = phase_expand()
    log(f"phase 5: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lowerings, lowering_rates = phase_lowering(
        roofline["lane_peak_ops_per_s"], floor_us)
    log(f"phase 6: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lse_entry, lse_line = phase_lse(enc, exp, data, headline, posts[0], gpu)
    log(f"phase 7: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lse_path_line = phase_lse_path(data, gpu)
    lse_entry = lse_buckets(lse_entry, lse_line, lse_path_line,
                            lse_resources)
    log(f"phase 7e: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    basecall_launches, basecall_line = phase_basecall(enc, exp, gpu)
    log(f"phase 8: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    parallel_launches, parallel_line = phase_parallel(enc, exp, data, gpu)
    log(f"phase 9: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    real_launches, real_line = phase_real_data(
        enc, exp, data, gpu, ["--experiment", "7"])
    log(f"phase 10: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train_launches, train_line = phase_train(enc, exp, gpu)
    log(f"phase 11: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reports_launches, reports_line = phase_reports(gpu)
    log(f"phase 12: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    list_launches, list_line = phase_list_sizes(data, gpu)
    log(f"phase 13: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bench_launches, bench_line = phase_bench(gpu)
    log(f"phase 14: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    traceback_line = phase_traceback(data, gpu)
    log(f"phase 15: done in {time.perf_counter() - t0:.1f} s")

    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(f"lva_acs and lva_acs_lse times below: one block step at the main "
        f"path's B={B}")
    log(json.dumps({"lva_acs": lva_line}))
    log(json.dumps({"lva_acs_lse": lse_line}))
    log(json.dumps({"lse_path": lse_path_line}))
    log(json.dumps({"roofline": roofline}))
    log(json.dumps({"probes": probes_line}))
    log(json.dumps({"lowering": lowering_rates}))
    log(json.dumps({"basecall": basecall_line}))
    log(json.dumps({"parallel": parallel_line}))
    log(json.dumps({"real_data": real_line}))
    log(json.dumps({"train": train_line}))
    log(json.dumps({"reports": reports_line}))
    log(json.dumps({"list_sizes": list_line}))
    log(json.dumps({"bench": bench_line}))
    log(json.dumps({"traceback": traceback_line}))
    log(f"gpu: {gpu}")
    log(json.dumps({"kernels": [{
        "name": "lva_acs",
        "route": "cuda",
        "source": "nanopore_dna_storage_tpu_torch/csrc/lva_acs.cu",
        "replaces": "nanopore_dna_storage_tpu/ops/lva_pallas.py:929",
        "launches": launches,
        # phase 8's decode of the basecaller's posteriors
        "basecall_launches": basecall_launches,
        # phase 9's scale-out decode: in this process and in every rank
        "parallel_launches": parallel_launches,
        # phase 10's real-read path: decode-posts with and without
        # barcodes, their in-process references and the raw-signal leg
        "real_data_launches": real_launches,
        # phase 11's decodes: simulate_and_decode_signal from an untrained
        # model, its trained net on experiment 7, cli simulate-signal
        "train_launches": train_launches,
        # phase 12's reports: file recovery, the read-cost corpus and the
        # signal-fidelity decode
        "reports_launches": reports_launches,
        # phase 13's sim-decodes at experiments 0 (L = 64) and 8 (L = 4)
        "list_sizes_launches": list_launches,
        # phase 14's bench runs: their warm-ups and timed loops
        "bench_launches": bench_launches,
        # the build of each bucket: registers, local bytes, threads per SM
        "resources": resources,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": acs["bound_ms"],
        "bound_by": acs["bound_by"],
        # no one PyTorch call computes a list-Viterbi block step
        "library_ms": None,
    }, lse_entry, {
        "name": "lva_traceback",
        "route": "cuda",
        "source": "nanopore_dna_storage_tpu_torch/csrc/lva_traceback.cu",
        # no Pallas kernel: the JAX package's traceback is an XLA scan
        "replaces": "nanopore_dna_storage_tpu/ops/lva_pallas.py:1086",
        # phase 3's sim-decode, one a CUDA decode
        "launches": tb_launches,
        "ms": traceback_line["exp7"]["ms"],
        "plain_ms": traceback_line["exp7"]["plain_ms"],
        "bound_ms": traceback_line["exp7"]["bound_ms"],
        "bound_by": traceback_line["exp7"]["bound_by"],
        "library_ms": None,
    }, *probes, *expansions, *lowerings]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
