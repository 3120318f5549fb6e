#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

0. setup: needs a CUDA device; builds the ACS kernel from
   ``nanopore_dna_storage_tpu_torch/csrc`` with nvcc (timed);
1. the kernel against its plain PyTorch version on the card, at the
   headline decode config (experiment 7: m=11, r=5/6, msg_len 180, L=8,
   max deviation 20) on one synthetic read: buffers and selections
   bit-equal on blocks spread over the read (position 0 and an inactive
   block included), then the whole read decoded both ways; then the same
   at the main path's shapes: phase 3's first batch of reads through
   ``PipelineDecoder.decode_posts``, split by orientation into launches
   of several reads of different lengths, every block checked;
2. every golden vector of ``tests/golden/decode`` through the kernel,
   bit-identical to the reference binary's lists;
3. the main path: ``sim-decode`` at experiment 7 on a 100-byte file, which
   must recover the file byte for byte, with one kernel launch per forward
   block step.

The line before the last is ``{"kernels": [...]}``, the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or away from the
package, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

try:
    from nanopore_dna_storage_tpu_torch import cli
    from nanopore_dna_storage_tpu_torch.config import (ConvCodeConfig,
                                                       DecodeConfig)
    from nanopore_dna_storage_tpu_torch.ops import _build, lva_acs, lva_decode
    from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
    from nanopore_dna_storage_tpu_torch.ops.lva_consts import sel_format
    from nanopore_dna_storage_tpu_torch.pipeline import (encode_bytes,
                                                         experiment)
    from nanopore_dna_storage_tpu_torch.pipeline.decode import \
        PipelineDecoder
    from nanopore_dna_storage_tpu_torch.pipeline.simulate import \
        simulate_posts
except ImportError as e:
    sys.exit(f"chip_smoke: FAIL: the port package is not beside this "
             f"script: {e}")

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "decode"
SEED = 0


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
    """Fails unless scores, hashes and -inf positions are bit-equal;
    returns the max |score difference| over finite scores."""
    fin = torch.isfinite(want[0])
    if not torch.equal(torch.isfinite(got[0]), fin):
        fail("kernel and acs_block_ref disagree on which scores are -inf")
    err = float((got[0][fin] - want[0][fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    for x, y in zip(got, want):
        if not torch.equal(x, y):
            fail(f"kernel buffers differ from acs_block_ref (score error "
                 f"{err})")
    return err


def phase_kernel(dec, post):
    """Phase 1: kernel vs plain version on one read, decoder ``dec``."""
    spec, tabs, dev = dec.spec, dec.tabs, dec.device
    T = post.shape[0]
    L, C, W = spec.list_size, spec.code.nstate_conv, spec.window
    log(f"phase 1: m={spec.code.mem} L={L}: C={C} W={W} "
        f"P={spec.npos_pad} T={T} rc={spec.code.config.rc}")
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
            st_ref = [x.clone() for x in stale]
            sel_ref = torch.empty_like(sel)
            lva_acs.acs_block_ref(tabs, prev, st_ref, *args, sel_ref)
        if t == timed_block:
            # both steps only read prev and rewrite the same stale cells,
            # so repeating them leaves the state as one call would
            scratch = [x.clone() for x in stale]
            ms = cuda_ms(lambda: lva_acs.acs_block(
                tabs, prev, scratch, *args, sel), reps=20, warmup=3)
            plain_ms = cuda_ms(lambda: lva_acs.acs_block_ref(
                tabs, prev, scratch, *args, sel), reps=3)
        lva_acs.acs_block(tabs, prev, stale, *args, sel)
        if t in check:
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
    lva_acs.acs_block_ref(tabs, prev, st_ref, *args, sel_ref)
    lva_acs.acs_block(tabs, prev, stale, *args, sel)
    same_bufs(stale, st_ref)
    same_bufs(stale, before)
    if not (torch.equal(sel, sel_ref) and bool((sel == -1).all())):
        fail("inactive block selected something")
    torch.cuda.synchronize()
    log(f"phase 1: {len(check)} active blocks + 1 inactive bit-equal "
        f"({written} selections written); block {timed_block}: kernel "
        f"{ms:.4f} ms/block, acs_block_ref {plain_ms:.4f} ms/block")

    out = {}
    for name, acs in (("kernel", lva_acs.acs_block),
                      ("acs_block_ref", lva_acs.acs_block_ref)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = dec.decode(post[None], acs=acs)
        torch.cuda.synchronize()
        log(f"phase 1: whole read via {name}: "
            f"{time.perf_counter() - t0:.3f} s/read")
    (mk, sk, vk), (mr, sr, vr) = out["kernel"], out["acs_block_ref"]
    if not (np.array_equal(mk, mr) and np.array_equal(sk, sr)
            and np.array_equal(vk, vr)):
        fail("kernel and acs_block_ref decode different lists")
    if not vk[0, 0]:
        fail("headline read decoded to an empty list")
    log(f"phase 1: lists identical; {int(vk.sum())} valid entries, "
        f"top score {sk[0, 0]:.4f}")
    return ms, plain_ms, err


class CheckedACS:
    """An ACS step that runs ``acs_block_ref`` on a copy of the stale
    buffers, then the kernel on the buffers themselves, and fails unless
    the two agree bit for bit; times both once, at block ``timed``."""

    def __init__(self, timed: int):
        self.timed = timed
        self.blocks = self.mixed = 0
        self.err = 0.0
        self.ms = self.plain_ms = self.timed_B = None

    def __call__(self, tabs, prev, stale, *args):
        *rest, sel = args
        if self.blocks == self.timed:
            self.timed_B = sel.shape[0]
            scratch = [x.clone() for x in stale]
            self.ms = cuda_ms(lambda: lva_acs.acs_block(
                tabs, prev, scratch, *args), reps=20, warmup=3)
            self.plain_ms = cuda_ms(lambda: lva_acs.acs_block_ref(
                tabs, prev, scratch, *args), reps=3)
        st_ref = [x.clone() for x in stale]
        sel_ref = torch.empty_like(sel)
        lva_acs.acs_block_ref(tabs, prev, st_ref, *rest, sel_ref)
        lva_acs.acs_block(tabs, prev, stale, *args)
        self.err = max(self.err, same_bufs(stale, st_ref))
        if not torch.equal(sel, sel_ref):
            fail(f"kernel selections differ at batch block {self.blocks}")
        active = rest[-1]
        if 0 < int(active.sum()) < active.numel():
            self.mixed += 1
        self.blocks += 1
        return sel


def phase_batch(enc, exp, device):
    """Phase 1b: the kernel against its plain version at the main path's
    shapes. The reads are phase 3's first batch (same seed and channel)
    through ``PipelineDecoder.decode_posts``, which splits them by
    orientation, so each launch holds several reads of different lengths,
    each with its own beam start, some of them past their end. Every block
    of both decodes is checked. Returns (B, kernel ms, plain ms) of the
    timed block, and the max |score error|."""
    posts, rcs, _ = simulate_posts(enc.oligos, 8,
                                   np.random.default_rng(SEED))
    for flag in (False, True):
        log(f"phase 1b: rc={flag}: nblk "
            f"{[len(p) for p, r in zip(posts, rcs) if r == flag]}")
    check = CheckedACS(timed=min(map(len, posts)) // 2)
    t0 = time.perf_counter()
    out = PipelineDecoder(exp, 8, 20, device=device).decode_posts(
        posts, rcs, enc.num_oligos_data + enc.num_oligos_rs, acs=check)
    log(f"phase 1b: {check.blocks} blocks bit-equal, {check.mixed} of them "
        f"with active and inactive reads ({time.perf_counter() - t0:.1f} s); "
        f"{int((out.index >= 0).sum())} of {len(posts)} reads pass CRC; "
        f"block {check.timed} at B={check.timed_B}: kernel "
        f"{check.ms:.4f} ms/block, acs_block_ref {check.plain_ms:.4f} "
        f"ms/block")
    if check.mixed == 0:
        fail("no checked block mixed active and inactive reads")
    return (check.timed_B, check.ms, check.plain_ms), check.err


def phase_goldens(device):
    """Phase 2: the reference binary's golden lists through the kernel."""
    cases = json.loads((GOLDEN / "manifest.json").read_text())
    for case in cases:
        cfg = DecodeConfig(
            code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                                msg_len=case["msg_len"], rc=case["rc"]),
            list_size=case["list_size"],
            max_deviation=case["max_deviation"])
        post = np.fromfile(GOLDEN / f"{case['name']}.post",
                           dtype="<f4").reshape(-1, 5, 8)
        t0 = time.perf_counter()
        msgs, _, valid = LVADecoder(cfg, device=device).decode(post[None])
        got = ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]
        want = (GOLDEN / f"{case['name']}.lists").read_text().split()
        log(f"phase 2: {case['name']}: T={post.shape[0]} "
            f"{'identical' if got == want else 'DIFFERENT'} "
            f"({time.perf_counter() - t0:.3f} s)")
        if got != want:
            fail(f"golden {case['name']} differs from the reference lists")
    return len(cases)


def phase_sim_decode(data: bytes, args):
    """Phase 3: the port's ``sim-decode`` CLI in-process on ``data``.
    Returns (its JSON record, SimStats, kernel launches, seconds)."""
    with tempfile.TemporaryDirectory() as tmp:
        f = pathlib.Path(tmp) / "data.bin"
        f.write_bytes(data)
        argv = ["sim-decode", "-i", str(f), *args]
        log("phase 3: cli " + " ".join(args))
        torch.cuda.synchronize()
        lva_acs.LAUNCHES = 0
        t0 = time.perf_counter()
        rec, stats = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lva_acs.LAUNCHES
    log(f"phase 3: {wall:.3f} s for {stats.num_reads} reads = "
        f"{wall / stats.num_reads:.4f} s/read; {launches} kernel launches "
        f"for {stats.steps} forward block steps")
    if not (rec["recovered"] and rec["byte_exact"]):
        fail(f"sim-decode did not recover the file: {rec}")
    return rec, stats, launches, wall


def main() -> int:
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = _build.build("lva_acs", ["lva_acs.cu"])
    _build.load_lva_acs()
    log(f"phase 0: built {lib_path.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

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
    _, _, err = phase_kernel(LVADecoder(headline, device="cuda"), posts[0])
    log(f"phase 1: done in {time.perf_counter() - t0:.1f} s")
    (B, ms, plain_ms), err_b = phase_batch(enc, exp, "cuda")
    err = max(err, err_b)

    t0 = time.perf_counter()
    n = phase_goldens("cuda")
    log(f"phase 2: {n} goldens identical in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    _, stats, launches, _ = phase_sim_decode(data, [
        "--experiment", "7", "--list-size", "8", "--num-reads", "32",
        "--batch", "8", "--seed", str(SEED), "--device", "cuda"])
    log(f"phase 3: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches == 0 or launches != stats.steps:
        fail(f"{launches} kernel launches for {stats.steps} block steps")

    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(f"kernel times below: one block step at the main path's B={B}")
    log(f"gpu: {gpu}")
    log(json.dumps({"kernels": [{
        "name": "lva_acs",
        "route": "cuda",
        "source": "nanopore_dna_storage_tpu_torch/csrc/lva_acs.cu",
        "replaces": "nanopore_dna_storage_tpu/ops/lva_pallas.py:929",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
