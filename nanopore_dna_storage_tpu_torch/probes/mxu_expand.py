"""The expansion ``y[j] = x[j >> 2]`` as a one-hot product ``Y = X @ E`` on
a CUDA card's tensor cores, with hand-written ``wgmma``.

Counterpart of ``scripts/tpu_mxu_expand_probe.py`` (P5), ``scripts/
tpu_mxu_probe2.py`` (P6) and ``scripts/tpu_mxu_probe3.py`` (P7), which ran
the product on the TPU's matrix unit. One kernel, ``onehot_mma``
(``csrc/mxu_expand.cu``), in three modes:

* ``tf32``: operands rounded to TF32 (``round_tf32``, ``cvt.rna``), f32
  sums; the counterpart of f32 ``DEFAULT``. TF32 keeps 11 significant
  bits, so P5's 16-bit halves are not exact there: the probes count the
  elements it gets wrong;
* ``bf16``: operands rounded to bf16 (nearest even), f32 sums;
* ``u8x4``: X as 32-bit words, E as uint8; four byte planes through the
  int8 tensor cores, reassembled as ``X @ E mod 2**32``. For a one-hot E
  it moves any 32-bit pattern bit for bit: the counterpart of ``HIGHEST``.

``onehot_mma_ref`` is the plain PyTorch version; CPU tensors take it, CUDA
tensors launch the kernel. As the TPU probes' G grid steps did, G copies
run over one input, each written to its own slot.

    python -m nanopore_dna_storage_tpu_torch.probes.mxu_expand

prints P5's exactness and MAC rate, P6's sweep and P7's bit-exactness,
each rate as a share of its mode's tensor-core peak (``tc_peak``).
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops._build import check_tensor, load_mxu_expand

MODES = ("tf32", "bf16", "u8x4")
# dense tensor-core MACs per SM and clock on Hopper, by operand type; u8x4
# does 4 int8 MACs (one per byte plane) for each 32-bit word MAC
MACS_PER_SM_CLOCK = {"tf32": 1024, "bf16": 2048, "int8": 4096}
CLAMP = -1.7014118346046923e38  # P7's -2**127 sentinel for -inf

# Kernel launches made through ``onehot_mma``, by mode (CUDA tensors only).
LAUNCHES = {m: 0 for m in MODES}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 stored mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero, the low 13 bits cleared. A
    finite value may round up to infinity; infinities stay; a NaN stays a
    NaN (its quiet bit set)."""
    b = x.contiguous().view(torch.int32)
    nan = torch.isnan(x)
    finite = torch.isfinite(x)
    rounded = (b + 0x1000) & ~0x1FFF  # on the magnitude: ties away
    kept = torch.where(nan, (b | 0x400000) & ~0x1FFF, b)
    return torch.where(finite, rounded, kept).view(torch.float32)


def onehot_mma_ref(x: torch.Tensor, e: torch.Tensor, mode: str
                   ) -> torch.Tensor:
    """Plain PyTorch ``Y = X @ E``: x [..., M, K], e [K, N]. tf32 and bf16:
    f32 operands rounded as the mode rounds them, products and sums in
    float64, f32 out (each product is exact in float64, and a column of E
    with one nonzero gives the kernel's f32 sum exactly). u8x4: x 32-bit
    words (int32), e uint8, int32 out: the int64 product masked to 32 bits,
    taken as four byte planes in float64, each plane's sums exact below
    2**53."""
    if mode == "tf32":
        a, b = round_tf32(x), round_tf32(e)
    elif mode == "bf16":
        a, b = x.bfloat16().float(), e.bfloat16().float()
    elif mode == "u8x4":
        xu, ed = x.long() & 0xFFFFFFFF, e.double()
        y = sum(((((xu >> (8 * p)) & 0xFF).double() @ ed).long() << (8 * p))
                for p in range(4)) & 0xFFFFFFFF
        return torch.where(y >= 1 << 31, y - (1 << 32), y).int()
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return (a.double() @ b.double()).float()


def check_shape(M: int, K: int, N: int, copies: int) -> None:
    """Raise unless the kernel of ``csrc/mxu_expand.cu`` takes [M, K] @
    [K, N] x ``copies``: M a multiple of 64 (one ``wgmma`` tile of rows), K
    and N of 32, K at most 512 (the whole K stays in shared memory beside a
    column tile of 32 or more), and at least one copy."""
    if M < 64 or M % 64 or K < 32 or K % 32 or K > 512 or N < 32 or N % 32 \
            or copies < 1:
        raise ValueError(f"onehot_mma takes M % 64 == K % 32 == N % 32 == "
                         f"0, K <= 512 and copies >= 1, not M={M} K={K} "
                         f"N={N} copies={copies}")


def onehot_mma(x: torch.Tensor, e: torch.Tensor, mode: str,
               copies: int = 1) -> torch.Tensor:
    """``copies`` copies of ``X @ E`` over one input: x [M, K] (f32 for
    tf32 and bf16, int32 words for u8x4), e [K, N] (f32, or uint8 for
    u8x4) -> [copies, M, N] (f32, or int32 for u8x4), every copy the same.
    CPU tensors run ``onehot_mma_ref`` on the copies; CUDA tensors launch
    the kernel of ``csrc/mxu_expand.cu`` (shapes as ``check_shape``);
    anything else raises."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    dev = x.device
    if dev.type == "cpu":
        ref = onehot_mma_ref(x, e, mode)
        return ref.expand(copies, *ref.shape)
    if dev.type != "cuda":
        raise ValueError(f"onehot_mma runs on cpu or cuda, not {dev}")
    if x.dim() != 2 or e.dim() != 2 or x.shape[1] != e.shape[0]:
        raise ValueError(f"onehot_mma takes x [M, K] and e [K, N], not "
                         f"{tuple(x.shape)} and {tuple(e.shape)}")
    (M, K), N = x.shape, e.shape[1]
    check_shape(M, K, N, copies)
    u8 = mode == "u8x4"
    xt = torch.int32 if u8 else torch.float32
    check_tensor("x", x, xt, (M, K), dev)
    check_tensor("e", e, torch.uint8 if u8 else torch.float32, (K, N), dev)
    y = torch.empty((copies, M, N), dtype=xt, device=dev)
    lib = load_mxu_expand()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxu_onehot_launch(x.data_ptr(), e.data_ptr(), y.data_ptr(),
                                    MODES.index(mode), M, K, N, copies,
                                    stream)
    if err != 0:
        raise RuntimeError(f"onehot_mma ({mode}) launch failed: "
                           + lib.mxu_error_string(err).decode())
    LAUNCHES[mode] += 1
    return y


def selection(K: int, N: int) -> np.ndarray:
    """The scripts' 0/1 matrix f32 [K, N]: ``E[(j * K) // N, j] = 1``
    (``make_E(4)`` and P7's ``E`` at K = N / 4, ``bench``'s ``e``)."""
    E = np.zeros((K, N), np.float32)
    E[(np.arange(N) * K) // N, np.arange(N)] = 1.0
    return E


def mode_inputs(x: np.ndarray, E: np.ndarray, mode: str, device):
    """(x, e) tensors in the types ``mode`` takes: f32 words for u8x4 pass
    as their int32 bit patterns, E as uint8."""
    if mode == "u8x4":
        return (torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
                .to(device), torch.from_numpy(E.astype(np.uint8)).to(device))
    return (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device),
            torch.from_numpy(E).to(device))


def tc_peak(mode: str, device: int = 0) -> Tuple[float, str]:
    """(MACs per second, formula) of ``mode``'s tensor cores: SMs x dense
    MACs per SM and clock x the maximum SM clock ``nvidia-smi`` reports.
    u8x4 counts 32-bit word MACs: the int8 peak over 4."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    res = subprocess.run(
        ["nvidia-smi", "-i", str(device), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(res.stdout.strip())
    per = MACS_PER_SM_CLOCK["int8" if mode == "u8x4" else mode]
    div = 4 if mode == "u8x4" else 1
    return (sms * per * mhz * 1e6 / div,
            f"{sms} SMs x {per} {mode if div == 1 else 'int8'} MACs/clock x "
            f"{mhz:g} MHz max SM clock" + (" / 4 byte planes" if div > 1
                                           else ""))


def best_ms(fn, reps: int = 5) -> float:
    """The fastest of ``reps`` launches of ``fn`` in ms, by CUDA events
    (the scripts took the best of 5)."""
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return min(ts)


def _wrong(y: torch.Tensor, want: np.ndarray) -> int:
    """Elements of ``y`` (every copy) whose bits differ from ``want``."""
    w = torch.from_numpy(np.ascontiguousarray(want).view(np.int32)).to(
        y.device)
    return int((y.view(torch.int32) != w).sum())


def _rate(mode: str, G: int, M: int, K: int, N: int, ms: float) -> Dict:
    peak, formula = tc_peak(mode)
    rate = G * M * K * N / (ms / 1e3)
    return {"mode": mode, "shape": [M, K, N], "copies": G, "ms": ms,
            "mac_per_s_T": rate / 1e12, "share_of_peak": rate / peak,
            "peak_formula": formula}


def p5_inputs() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """P5's int32 hashes h [128, 128], their 16-bit halves as f32 x
    [256, 128] (low halves first) and E [128, 512]."""
    rng = np.random.default_rng(0)
    h = rng.integers(0, 1 << 30, (128, 128), dtype=np.int64).astype(
        np.int32)
    x = np.concatenate([(h & 0xFFFF).astype(np.float32),
                        (h >> 16).astype(np.float32)])
    return h, x, selection(128, 512)


def p5(G: int = 256) -> Dict:
    """P5: the hashes as halves through u8x4 (the halves' bits) and tf32,
    reassembled as the script does, and through u8x4 as they are. u8x4 must
    be exact; tf32's wrong elements are counted."""
    h, x, E = p5_inputs()
    want = h[:, np.arange(512) // 4]
    out = {}
    for mode in ("u8x4", "tf32"):
        xt, et = mode_inputs(x, E, mode, "cuda")
        y = onehot_mma(xt, et, mode, G)
        yf = y.view(torch.float32) if mode == "u8x4" else y
        lo, hi = yf[:, :128].long(), yf[:, 128:].long()
        got = ((hi * 65536 + lo) & 0xFFFFFFFF).int()
        out[mode] = {
            "exact": _wrong(got, want) == 0,
            "wrong_halves": _wrong(yf, x[:, np.arange(512) // 4]),
            "wrong_hashes": _wrong(got, want),
            **_rate(mode, G, 256, 128, 512,
                    best_ms(lambda: onehot_mma(xt, et, mode, G))),
        }
    ht, et = mode_inputs(h, E, "u8x4", "cuda")
    out["u8x4_hashes_direct_exact"] = \
        _wrong(onehot_mma(ht, et, "u8x4", G), want) == 0
    return out


# P6's eight points (scripts/tpu_mxu_probe2.py:57-64): rows, K, CT and the
# mode standing in for its precision and dtype
P6_POINTS = ((256, 128, 512, "u8x4", "f32 HIGHEST  256x128x512"),
             (256, 128, 512, "tf32", "f32 DEFAULT  256x128x512"),
             (256, 128, 512, "bf16", "bf16 DEFAULT 256x128x512"),
             (256, 512, 512, "tf32", "f32 DEFAULT  256x512x512"),
             (1024, 512, 512, "tf32", "f32 DEFAULT 1024x512x512"),
             (64, 128, 512, "u8x4", "f32 HIGHEST   64x128x512"),
             (320, 512, 2048, "u8x4", "f32 HIGHEST 320x512x2048 (full cell)"),
             (320, 512, 2048, "tf32", "f32 DEFAULT 320x512x2048 (full cell)"))


def p6_inputs(rows: int, K: int, N: int) -> Tuple[np.ndarray, np.ndarray]:
    x = np.random.default_rng(0).standard_normal((rows, K)).astype(
        np.float32)
    return x, selection(K, N)


def p6(G: int = 256):
    """P6: the product at its eight points; each point's elements that
    differ from the exact selection of x are counted (bf16 against the
    bf16-rounded x)."""
    out = []
    for rows, K, N, mode, label in P6_POINTS:
        x, E = p6_inputs(rows, K, N)
        xt, et = mode_inputs(x, E, mode, "cuda")
        y = onehot_mma(xt, et, mode, G)
        if mode == "bf16":
            x = torch.from_numpy(x).bfloat16().float().numpy()
        want = x[:, (np.arange(N) * K) // N]
        out.append({"label": label, "wrong": _wrong(y, want),
                    **_rate(mode, G, rows, K, N,
                            best_ms(lambda: onehot_mma(xt, et, mode, G)))})
    return out


def p7_inputs() -> Tuple[np.ndarray, np.ndarray]:
    """P7's payloads [320, 128]: scores x 1e4, every 7th row the sentinel,
    a row of tiny and a row of huge values; and E [128, 512]."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((320, 128)) * 1e4).astype(np.float32)
    x[::7] = CLAMP
    x[3, :] = np.float32(-1.234567e-30)
    x[4, :] = np.float32(8.7654321e20)
    return x, selection(128, 512)


def p7(G: int = 512) -> Dict:
    """P7: the payloads' selection through u8x4 (must be bit-exact) and
    tf32 (counted)."""
    x, E = p7_inputs()
    want = x[:, np.arange(512) // 4]
    out = {}
    for mode in ("u8x4", "tf32"):
        xt, et = mode_inputs(x, E, mode, "cuda")
        y = onehot_mma(xt, et, mode, G)
        out[mode] = {"bit_exact": _wrong(y, want) == 0,
                     "wrong": _wrong(y, want),
                     **_rate(mode, G, 320, 128, 512,
                             best_ms(lambda: onehot_mma(xt, et, mode, G)))}
    return out


def main(argv=None) -> bool:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mxu_expand: needs a CUDA device")
    g5, g7 = 256, 512  # the scripts' G
    for mode in MODES:
        peak, formula = tc_peak(mode)
        print(f"{mode} peak {peak / 1e12:.3f} T MAC/s = {formula}",
              flush=True)
    r5 = p5(g5)
    for mode in ("u8x4", "tf32"):
        r = r5[mode]
        print(f"P5 {mode}: exact: {r['exact']} ({r['wrong_hashes']} hashes "
              f"and {r['wrong_halves']} halves of {g5 * 256 * 512 // 2} / "
              f"{g5 * 256 * 512} wrong); {r['ms'] * 1e3:.0f} us/call, "
              f"{r['mac_per_s_T']:.3f} T MAC/s, "
              f"{100 * r['share_of_peak']:.3f}% of the {mode} peak",
              flush=True)
    print(f"P5 u8x4 on the hashes themselves: exact: "
          f"{r5['u8x4_hashes_direct_exact']}", flush=True)
    r6 = p6(g5)
    for r in r6:
        print(f"P6 {r['label']:38s} [{r['mode']}] {r['ms'] * 1e3:8.0f} "
              f"us/call {r['mac_per_s_T']:8.3f} T MAC/s "
              f"({100 * r['share_of_peak']:.3f}% of peak), "
              f"{r['wrong']} wrong", flush=True)
    r7 = p7(g7)
    for mode in ("u8x4", "tf32"):
        r = r7[mode]
        print(f"P7 {mode}: f32 payload selection bit-exact: "
              f"{r['bit_exact']} ({r['wrong']} of {g7 * 320 * 512} wrong); "
              f"[320,128]@[128,512] x{g7}: {r['ms'] * 1e3:.0f} us, "
              f"{r['mac_per_s_T']:.3f} T MAC/s "
              f"({100 * r['share_of_peak']:.3f}% of peak)", flush=True)
    ok = (r5["u8x4"]["exact"] and r5["u8x4_hashes_direct_exact"]
          and r7["u8x4"]["bit_exact"]
          and all(r["wrong"] == 0 for r in r6 if r["mode"] != "tf32"))
    return ok


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
