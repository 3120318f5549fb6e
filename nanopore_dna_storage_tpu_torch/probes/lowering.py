"""The lowering probes on a CUDA card: the primitives the ACS kernel rests
on, each as a hand-written kernel beside its plain PyTorch version.

Counterpart of ``scripts/tpu_pallas_probe.py`` (P1), which asked whether
Mosaic lowers six primitives; here each is a question of cost:

* ``repeat``: ``out[r, i] = x[r, i // 4]`` over f32 [8, 1024] (the first 256
  columns, each 4 times): the predecessor expansion, which is
  ``expand.lane_map`` (element map, k = 4) in its gather and shfl forms;
* ``dynrow``: ``out[0] = x[i]`` for x f32 [136, 1024], i an int32 [1] tensor
  on the card that the kernel reads itself (the scalar prefetch); an index
  outside [0, P) is clamped into it, as ``jax.lax.dynamic_slice`` clamps;
* ``int16``: ``int16(int32(x) * 64 + 7)`` over [64, 1024], wrapping modulo
  2**16 as numpy's ``astype`` does;
* ``fori``: R rounds of first-argmax over NQ candidates per column with a
  one-hot select, carrying scores, hashes, pointers and a running sum, the
  scores in registers over 1, 2, 4 or 8 lanes a column (``regs``,
  ``LANES``) or the whole state in local memory, one thread a column
  (``local``, as the ACS kernel held its candidates); at the script's NQ =
  32, R = 18 and at the ACS kernel's merge, NQ = 8L = 64, R = L = 8
  (``fori.k1``);
* ``reshape``: f32 [8, L, C] -> [8L, C] as a copy into a new tensor;
* ``alias``: ``stale[s + w] = (stale[s + w] + x[s + w]) + w`` for w < W, in
  place on stale f32 [P, 8, C] (the same tensor comes back), s an int32 [1]
  tensor on the card; window rows outside [0, P) are skipped.

CPU tensors take the plain versions (``*_ref``), CUDA tensors launch the
kernels of ``csrc/lowering.cu``, any other device raises.

    python -m nanopore_dna_storage_tpu_torch.probes.lowering [name ...]

runs the cases (all by default; ``fori`` also selects ``fori.k1``), prints
each check, OK or WRONG against the numpy result the script checks, with
the device time per call and the launch floor (an empty kernel,
``launch_floor_us``: one thread, and each of dynrow's, int16's, reshape's
and alias's grids), then the fori rates at both NQ over ``FORI_COPIES``
copies of the columns: ``regs``, ``local``, and ``local`` capped at
``regs``'s resident threads per SM, which splits the placement's gain from
the residency's. It exits non-zero if any case or rate is wrong.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops._build import check_tensor, load_lowering
from . import expand
from .merge_roofline import lane_peak
from .mxu_expand import best_ms

SCRIPT = "scripts/tpu_pallas_probe.py"
PLACEMENTS = ("regs", "local")
# (NQ, R) of the fori probe: the script's, and the ACS kernel's merge at
# L = 8 (8L candidates, L rounds); the kernel is built for these NQ
FORI_POINTS = ((32, 18), (64, 8))
# threads a block of every kernel in csrc/lowering.cu
BLOCK = 128
# lanes a column of fori regs, the kernels built
LANES = (1, 2, 4, 8)
# copies of the 1024 columns for the fori rates: 262,144 threads, about two
# waves of the card at full residency
FORI_COPIES = 256
REPEAT_K = 4
# the large shape the copy is timed at beside the script's [8, 8, 1024]:
# 268,435,456 bytes each way
RESHAPE_LARGE = (8, 8, 1 << 20)

# Kernel launches made through each wrapper (CUDA tensors only). The
# repeat probe's launches count in ``expand.LAUNCHES``.
LAUNCHES = {"dynrow": 0, "int16": 0, "fori_regs": 0, "fori_local": 0,
            "reshape": 0, "alias": 0}


def fori_ops(nq: int, placement: str = "local", lanes: int = 1) -> int:
    """Operations of one fori round on one column, one per element and pass
    as ``merge_roofline`` counts them. What the function needs, and the
    ``local`` placement executes: the first argmax, 3 per candidate
    (compare, keep the score, keep the index), then the winner's hash, its
    parity, conversion and product by zero, the pointer add, the score
    subtract and the two adds: 3 NQ + 8. ``regs`` at G = ``lanes`` lanes, as
    its code reads: the lanes' trees, 3 per pair, 3 (NQ - G); a compare, a
    predicated subtract and a predicated move per candidate (the owner's
    update and hash), 3 NQ; 6 per lane and shuffle step (two shuffles, two
    compares, two selects), 6 G log2 G; and 10 per lane (the flat index,
    the owner's offset, the count's compare and add, the owner's lane and
    the hash's shuffle, its parity, conversion and product, the two adds):
    6 NQ + 7 G + 6 G log2 G. At G = 1 the hash is read back from memory
    (its address and load) in place of the moves and the shuffle: 5 NQ +
    8."""
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}")
    if placement == "local":
        return 3 * nq + 8
    if lanes not in LANES:
        raise ValueError(f"no fori regs kernel at {lanes} lanes")
    if lanes == 1:
        return 5 * nq + 8
    return 6 * nq + 7 * lanes + 6 * lanes * (lanes.bit_length() - 1)


def _launch(name: str, lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.lowering_error_string(err).decode())
    LAUNCHES[name] += 1


def _on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor, True for a CUDA one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def dynrow_ref(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: row ``i[0]`` of x [P, C], clamped into [0, P), as
    f32 [1, C]."""
    return x.index_select(0, i.clamp(0, x.shape[0] - 1))


def dynrow(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i[0]`` of x f32 [P, C] as [1, C]; i int32 [1] stays on the
    device and the kernel reads it."""
    if not _on_card("dynrow", x):
        return dynrow_ref(x, i)
    if x.dim() != 2:
        raise ValueError(f"dynrow takes x [P, C], not {tuple(x.shape)}")
    check_tensor("x", x, torch.float32, x.shape, x.device)
    check_tensor("i", i, torch.int32, (1,), x.device)
    P, C = x.shape
    y = torch.empty((1, C), dtype=torch.float32, device=x.device)
    lib = load_lowering()
    with torch.cuda.device(x.device):
        err = lib.lowering_dynrow_launch(x.data_ptr(), i.data_ptr(),
                                         y.data_ptr(), P, C,
                                         _stream(x.device))
    _launch("dynrow", lib, err)
    return y


def int16_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``int16(x * 64 + 7)`` of int32 x, wrapping: computed in
    int64, kept modulo 2**16 and read as a signed 16-bit value."""
    v = (x.long() * 64 + 7) & 0xFFFF
    return torch.where(v >= 1 << 15, v - (1 << 16), v).to(torch.int16)


def int16(x: torch.Tensor) -> torch.Tensor:
    """``int16(x * 64 + 7)`` of int32 x, wrapping, as an int16 tensor of the
    same shape."""
    if not _on_card("int16", x):
        return int16_ref(x)
    check_tensor("x", x, torch.int32, x.shape, x.device)
    y = torch.empty(x.shape, dtype=torch.int16, device=x.device)
    lib = load_lowering()
    with torch.cuda.device(x.device):
        err = lib.lowering_int16_launch(x.data_ptr(), y.data_ptr(),
                                        x.numel(), _stream(x.device))
    _launch("int16", lib, err)
    return y


def fori_ref(x: torch.Tensor, h: torch.Tensor, rounds: int) -> torch.Tensor:
    """Plain PyTorch fori probe: scores x f32 [NQ, C], hashes h int32
    [NQ, C] (uint32 bit patterns) -> f32 [1, C]. Each round takes the first
    argmax q and its score, the one-hot hash sum, adds the one-hot to the
    pointers, lowers the winner's score by 1 and adds ``best + f32(hh & 1) *
    0.0`` to the sum; the result adds the pointers' total. The arithmetic
    and its order are ``p_fori``'s."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    sc, ptr = x, torch.zeros_like(h)
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for _ in range(rounds):
        q = sc.argmax(0, keepdim=True)  # the first maximum
        best = sc.gather(0, q)[0]
        oh = rows == q
        # an int64 sum: its low bit is the uint32 sum's
        hh = torch.where(oh, h, 0).sum(0)
        ptr = ptr + oh.int()
        sc = torch.where(oh, sc - 1.0, sc)
        out = (out + best) + (hh & 1).float() * 0.0
    return (out + ptr.sum(0).float())[None]


def fori(x: torch.Tensor, h: torch.Tensor, rounds: int,
         placement: str = "regs", copies: int = 1,
         threads_per_sm: int = 0, lanes: int = 0) -> torch.Tensor:
    """``copies`` copies of the fori probe over one input: x f32 [NQ, C], h
    int32 [NQ, C] -> f32 [copies, 1, C], every copy the same. CUDA tensors
    launch the kernel with the scores in registers over ``lanes`` lanes a
    column (``regs``: one of ``LANES``, or 0 for ``auto_lanes``) or its
    state in local memory (``local``, one thread a column, ``lanes`` 0 or
    1); NQ is 32 or 64 there. ``threads_per_sm`` > 0 launches a grid of at
    most that many threads per SM, which stride over the items; 0 launches
    one thread (regs: ``lanes``) per item."""
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}")
    if rounds < 0 or copies < 1 or threads_per_sm < 0:
        raise ValueError("rounds must be >= 0, copies >= 1 and "
                         "threads_per_sm >= 0")
    if lanes not in ((0, *LANES) if placement == "regs" else (0, 1)):
        raise ValueError(f"no fori {placement} kernel at {lanes} lanes")
    if not _on_card("fori", x):
        ref = fori_ref(x, h, rounds)
        return ref.expand(copies, *ref.shape)
    nq, C = x.shape if x.dim() == 2 else (0, 0)
    if nq not in dict(FORI_POINTS):
        raise ValueError(f"fori takes x [NQ, C] with NQ in "
                         f"{[n for n, _ in FORI_POINTS]}, not "
                         f"{tuple(x.shape)}")
    check_tensor("x", x, torch.float32, (nq, C), x.device)
    check_tensor("h", h, torch.int32, (nq, C), x.device)
    y = torch.empty((copies, 1, C), dtype=torch.float32, device=x.device)
    lib = load_lowering()
    with torch.cuda.device(x.device):
        err = lib.lowering_fori_launch(
            x.data_ptr(), h.data_ptr(), y.data_ptr(),
            PLACEMENTS.index(placement), nq, C, rounds, copies, lanes,
            threads_per_sm, 0.0, _stream(x.device))
    _launch(f"fori_{placement}", lib, err)
    return y


def auto_lanes(items: int) -> int:
    """The lanes a column ``fori`` regs takes by default over ``items``
    (copies x columns) on the current CUDA device: the fewest that give
    every SM a block, at most 8."""
    g = load_lowering().lowering_fori_lanes(items)
    if g == 0:
        raise RuntimeError("fori: the device query failed")
    return g


def fori_info(placement: str, nq: int, lanes: int = 1) -> dict:
    """Registers, local memory in bytes (stack frame and spills) and
    resident threads per SM (the occupancy calculator) of the fori kernel
    in ``placement`` at NQ = ``nq`` and ``lanes`` lanes a column (1 for
    ``local``) on the current CUDA device."""
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}")
    lib = load_lowering()
    out = (ctypes.c_int * 3)()
    err = lib.lowering_fori_info(PLACEMENTS.index(placement), nq, lanes, out)
    if err != 0:
        raise RuntimeError("fori kernel info failed: "
                           + lib.lowering_error_string(err).decode())
    return {"registers": out[0], "local_bytes": out[1],
            "threads_per_sm": out[2]}


def launch_floor_us(device="cuda", blocks: int = 1,
                    threads: int = 1) -> float:
    """The launch floor: the device time of one empty kernel on ``device``,
    one thread or ``blocks`` blocks of ``threads`` (a kernel's own grid,
    ``grid_blocks``), replayed from a CUDA graph of ``expand.GRAPH_CALLS``
    launches (``expand.graph_us``), in microseconds."""
    dev = torch.device(device)
    lib = load_lowering()

    def empty():
        with torch.cuda.device(dev):
            err = lib.lowering_empty_launch(blocks, threads, _stream(dev))
        if err != 0:
            raise RuntimeError("empty launch failed: "
                               + lib.lowering_error_string(err).decode())

    return expand.graph_us(empty)


# the cases whose kernels launch one thread per element (``grid_blocks``)
GRID_CASES = ("dynrow", "int16", "reshape", "alias")


def grid_blocks(case: "Case") -> int:
    """The blocks of ``BLOCK`` threads that ``case``'s kernel launches at
    the script's shape (dynrow, int16, reshape, alias): one thread per
    output element, per 16-byte vector for the reshape copy, per window
    element for alias, as the launchers of ``csrc/lowering.cu`` size them."""
    shape = case.shapes[{"dynrow": 1, "alias": 2}.get(case.name, 0)]
    items = {"dynrow": shape[-1], "int16": int(np.prod(shape)),
             "reshape": int(np.prod(shape)) // 4,
             "alias": ALIAS_WINDOW * int(np.prod(shape[1:]))}[case.name]
    return -(-items // BLOCK)


def reshape_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: x [8, L, C] as a new tensor [8L, C]."""
    return x.reshape(-1, x.shape[-1]).clone()


def reshape(x: torch.Tensor) -> torch.Tensor:
    """x f32 [8, L, C] copied into a new tensor [8L, C]; on the card its
    element count is a multiple of 4 and its data 16-byte aligned."""
    if not _on_card("reshape", x):
        return reshape_ref(x)
    if x.dim() != 3:
        raise ValueError(f"reshape takes x [8, L, C], not {tuple(x.shape)}")
    check_tensor("x", x, torch.float32, x.shape, x.device)
    if x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError("reshape copies 16-byte vectors: it takes a "
                         "multiple of 4 elements, 16-byte aligned")
    y = torch.empty((x.shape[0] * x.shape[1], x.shape[2]),
                    dtype=torch.float32, device=x.device)
    lib = load_lowering()
    with torch.cuda.device(x.device):
        err = lib.lowering_copy_launch(x.data_ptr(), y.data_ptr(),
                                       x.numel(), _stream(x.device))
    _launch("reshape", lib, err)
    return y


def alias_ref(stale: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
              window: int) -> torch.Tensor:
    """Plain PyTorch: rows p = s[0] + w of stale [P, ...], for w < window
    and 0 <= p < P, become ``(stale[p] + x[p]) + f32(w)``, in place; every
    other row keeps its value. Returns stale."""
    P = stale.shape[0]
    w = torch.arange(P, device=stale.device) - s
    w = w.view(P, *[1] * (stale.dim() - 1))
    upd = (stale + x) + w.float()
    stale.copy_(torch.where((w >= 0) & (w < window), upd, stale))
    return stale


def alias(stale: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
          window: int) -> torch.Tensor:
    """The window update of ``alias_ref`` on stale f32 [P, ...] in place,
    with x f32 of stale's shape and s int32 [1] on the device; returns
    stale itself."""
    if window < 1:
        raise ValueError("the window takes at least one row")
    if not _on_card("alias", stale):
        return alias_ref(stale, x, s, window)
    check_tensor("stale", stale, torch.float32, stale.shape, stale.device)
    check_tensor("x", x, torch.float32, stale.shape, stale.device)
    check_tensor("s", s, torch.int32, (1,), stale.device)
    P = stale.shape[0]
    lib = load_lowering()
    with torch.cuda.device(stale.device):
        err = lib.lowering_alias_launch(
            stale.data_ptr(), x.data_ptr(), s.data_ptr(), P, window,
            stale.numel() // P, _stream(stale.device))
    _launch("alias", lib, err)
    return stale


def np_fori(x: np.ndarray, h: np.ndarray, rounds: int) -> np.ndarray:
    """``p_fori``'s kernel in numpy: x f32 [NQ, C], h uint32 [NQ, C] ->
    f32 [1, C]."""
    sc, ptr = x, np.zeros(x.shape, np.int32)
    out = np.zeros(x.shape[1], np.float32)
    rows = np.arange(x.shape[0])[:, None]
    for _ in range(rounds):
        q = sc.argmax(0)
        best = sc.max(0)
        oh = rows == q[None, :]
        hh = np.where(oh, h, np.uint32(0)).sum(0, dtype=np.uint32)
        ptr = ptr + oh.astype(np.int32)
        sc = np.where(oh, sc - np.float32(1), sc)
        out = (out + best) + (hh & 1).astype(np.float32) * np.float32(0)
    return (out + ptr.sum(0).astype(np.float32))[None]


def np_alias(s: np.ndarray, x: np.ndarray, stale: np.ndarray,
             window: int) -> np.ndarray:
    """``p_alias``'s result in numpy, for any stale: the window rows inside
    [0, P) updated, the rest as they were."""
    out = stale.copy()
    for w in range(window):
        p = int(s[0]) + w
        if 0 <= p < len(stale):
            out[p] = (stale[p] + x[p]) + np.float32(w)
    return out


def tensors(arrays, device) -> Tuple[torch.Tensor, ...]:
    """Numpy arrays as tensors on ``device``, uint32 as their int32 bit
    patterns."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)
        for a in arrays)


def _normal(rng, shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Case:
    """One script probe at its shapes: ``name`` (the script's function
    without ``p_``; ``fori.k1`` is fori at the ACS kernel's merge), the
    kernels it runs (``forms``), how its inputs are made and the numpy
    result the script checks them against."""

    name: str
    replaces: str  # file:line of the script's pallas_call
    shapes: Tuple[Tuple[int, ...], ...]  # the inputs, in the script's order
    forms: Tuple[str, ...]
    make: Callable  # numpy Generator -> the inputs (numpy arrays)
    want: Callable  # the inputs -> the numpy result
    kernel: Callable  # (input tensors, form) -> the kernel's result
    plain: Callable  # input tensors -> the plain version's result

    def inputs(self, device) -> Tuple[Tuple[np.ndarray, ...],
                                      Tuple[torch.Tensor, ...]]:
        """The inputs from seed 0, as numpy arrays and as tensors (uint32
        as their int32 bit patterns) on ``device``."""
        arrays = self.make(np.random.default_rng(0))
        return arrays, tensors(arrays, device)

    def bind(self, tensors, form: str):
        """(kernel, plain) on copies of ``tensors``, one copy each, so that
        the in-place alias leaves the inputs alone."""
        kt = tuple(t.clone() for t in tensors)
        pt = tuple(t.clone() for t in tensors)
        return (lambda: self.kernel(kt, form)), (lambda: self.plain(pt))


def _fori_case(name: str, nq: int, rounds: int) -> Case:
    return Case(
        name, f"{SCRIPT}:94", ((nq, 1024), (nq, 1024)), PLACEMENTS,
        make=lambda rng: (_normal(rng, (nq, 1024)),
                          np.full((nq, 1024), 3, np.uint32)),
        want=lambda x, h: np_fori(x, h, rounds),
        kernel=lambda t, form: fori(*t, rounds, form)[0],
        plain=lambda t: fori_ref(*t, rounds))


ALIAS_WINDOW = 4
CASES = (
    Case("repeat", f"{SCRIPT}:27", ((8, 1024),), ("gather", "shfl"),
         make=lambda rng: (_normal(rng, (8, 1024)),),
         want=lambda x: np.repeat(x[:, :1024 // REPEAT_K], REPEAT_K, 1),
         kernel=lambda t, form: expand.lane_map(t[0], "element", REPEAT_K,
                                                form)[0],
         plain=lambda t: expand.lane_map_ref(t[0], "element", REPEAT_K)),
    Case("dynrow", f"{SCRIPT}:44", ((1,), (136, 1024)), ("dynrow",),
         make=lambda rng: (np.array([37], np.int32),
                           _normal(rng, (136, 1024))),
         want=lambda i, x: x[np.clip(i[0], 0, len(x) - 1)][None],
         kernel=lambda t, form: dynrow(t[1], t[0]),
         plain=lambda t: dynrow_ref(t[1], t[0])),
    Case("int16", f"{SCRIPT}:62", ((64, 1024),), ("int16",),
         make=lambda rng: (np.arange(64 * 1024, dtype=np.int32)
                           .reshape(64, 1024) % 33,),
         want=lambda x: (x * 64 + 7).astype(np.int16),
         kernel=lambda t, form: int16(t[0]),
         plain=lambda t: int16_ref(t[0])),
    _fori_case("fori", *FORI_POINTS[0]),
    _fori_case("fori.k1", *FORI_POINTS[1]),
    Case("reshape", f"{SCRIPT}:108", ((8, 8, 1024),), ("reshape",),
         make=lambda rng: (_normal(rng, (8, 8, 1024)),),
         want=lambda x: x.reshape(-1, x.shape[-1]),
         kernel=lambda t, form: reshape(t[0]),
         plain=lambda t: reshape_ref(t[0])),
    Case("alias", f"{SCRIPT}:125", ((1,), (16, 8, 256), (16, 8, 256)),
         ("alias",),
         make=lambda rng: (np.array([3], np.int32), _normal(rng, (16, 8, 256)),
                           _normal(rng, (16, 8, 256))),
         want=lambda s, x, stale: np_alias(s, x, stale, ALIAS_WINDOW),
         kernel=lambda t, form: alias(t[2], t[1], t[0], ALIAS_WINDOW),
         plain=lambda t: alias_ref(t[2], t[1], t[0], ALIAS_WINDOW)),
)


def same(y: np.ndarray, want: np.ndarray) -> bool:
    """Shape, dtype and every bit equal."""
    return (y.shape == want.shape and y.dtype == want.dtype
            and np.array_equal(y.view(np.uint8), want.view(np.uint8)))


def run(case: Case, device: str = "cuda") -> bool:
    """Every form of ``case`` on ``device``: prints its check (OK or WRONG
    against the numpy result) and, on a CUDA device, the device time per
    call (``expand.graph_us``); True if every form is right."""
    arrays, tensors = case.inputs(device)
    want = np.ascontiguousarray(case.want(*arrays))
    ok = True
    for form in case.forms:
        kernel, _ = case.bind(tensors, form)
        good = same(np.ascontiguousarray(kernel().cpu().numpy()), want)
        ok &= good
        line = f"{case.name} [{form}]: {'OK' if good else 'WRONG'}"
        if device != "cpu":
            line += f" {expand.graph_us(kernel):.3f} us/call"
        print(line, flush=True)
    return ok


def fori_rate(nq: int, rounds: int, placement: str,
              threads_per_sm: int = 0) -> Dict:
    """``FORI_COPIES`` copies of the fori kernel over [nq, 1024] normal
    scores on the CUDA card (``threads_per_sm`` as ``fori`` takes it, regs
    at its default lanes), timed by CUDA events (the fastest of 5), every
    copy checked against the plain version: the lanes a column, the
    resident threads per SM, candidate elements per second (each candidate
    once per round), and the operations per second and share of the FP32
    lane peak, both of what the function needs (``fori_ops``) and of what
    the placement executes."""
    cols = 1024
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_normal(rng, (nq, cols))).cuda()
    h = torch.full((nq, cols), 3, dtype=torch.int32, device="cuda")

    def call():
        return fori(x, h, rounds, placement, FORI_COPIES, threads_per_sm)

    ok = bool((call() == fori_ref(x, h, rounds)).all())
    ms = best_ms(call)
    sec = ms / 1e3
    items = FORI_COPIES * cols * rounds
    peak, _ = lane_peak()
    lanes = auto_lanes(FORI_COPIES * cols) if placement == "regs" else 1
    resident = fori_info(placement, nq, lanes)["threads_per_sm"]
    if threads_per_sm:
        resident = min(resident, threads_per_sm)
    executed = fori_ops(nq, placement, lanes)
    return {"placement": placement, "nq": nq, "rounds": rounds,
            "copies": FORI_COPIES, "cols": cols, "lanes": lanes, "ok": ok,
            "ms": ms, "threads_per_sm": resident,
            "elements_per_s": items * nq / sec,
            "needed_ops_per_s": items * fori_ops(nq) / sec,
            "share_of_lane_peak": items * fori_ops(nq) / sec / peak,
            "executed_ops_per_s": items * executed / sec,
            "executed_share_of_lane_peak": items * executed / sec / peak}


def fori_rates():
    """The fori rates at both NQ (``FORI_POINTS``): ``regs``, ``local``,
    and ``local`` capped at ``regs``'s resident threads per SM; prints each
    and the ratios. Returns the list of ``fori_rate`` results."""
    peak, formula = lane_peak()
    print(f"lane peak {peak / 1e12:.3f} T ops/s = {formula}", flush=True)
    rates = []
    for nq, rounds in FORI_POINTS:
        regs = fori_rate(nq, rounds, "regs")
        local = fori_rate(nq, rounds, "local")
        capped = fori_rate(nq, rounds, "local", regs["threads_per_sm"])
        for r in (regs, local, capped):
            print(f"fori [{r['placement']}] NQ={nq} R={rounds} x "
                  f"{FORI_COPIES} copies of {r['cols']} columns, "
                  f"{r['lanes']} lanes a column, at "
                  f"{r['threads_per_sm']} threads/SM: "
                  f"{'OK' if r['ok'] else 'WRONG'} {r['ms']:.4f} ms, "
                  f"{r['elements_per_s'] / 1e9:.2f} G elements/s; needed "
                  f"{r['needed_ops_per_s'] / 1e12:.3f} T ops/s = "
                  f"{100 * r['share_of_lane_peak']:.2f}%, executed "
                  f"{r['executed_ops_per_s'] / 1e12:.3f} T ops/s = "
                  f"{100 * r['executed_share_of_lane_peak']:.2f}% of the "
                  f"lane peak", flush=True)
        print(f"fori NQ={nq}: regs / local rate {local['ms'] / regs['ms']:.3f}"
              f", regs / local at {regs['threads_per_sm']} threads/SM "
              f"{capped['ms'] / regs['ms']:.3f}", flush=True)
        rates += [regs, local, capped]
    return rates


def select(names: Sequence[str]) -> Tuple[Case, ...]:
    """The cases named, or whose name starts with a name and a dot."""
    if not names:
        return CASES
    out = tuple(c for c in CASES
                if any(c.name == n or c.name.startswith(n + ".")
                       for n in names))
    if not out:
        raise ValueError(f"no case matches {list(names)}")
    return out


def main(argv=None) -> Tuple[bool, list]:
    """The entry point: (every case and rate right, the fori rates)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help="cases (repeat, dynrow, int16, fori, fori.k1, "
                         "reshape, alias); default all")
    args = ap.parse_args(argv)
    try:
        cases = select(args.names)
    except ValueError as e:
        ap.error(str(e))
    if not torch.cuda.is_available():
        raise SystemExit("lowering: needs a CUDA device")
    ok = all([run(c) for c in cases])
    print(f"launch floor (an empty kernel): {launch_floor_us():.3f} us/call",
          flush=True)
    for c in cases:
        if c.name in GRID_CASES:
            us = launch_floor_us(blocks=grid_blocks(c), threads=BLOCK)
            print(f"launch floor at {c.name}'s grid ({grid_blocks(c)} blocks "
                  f"of {BLOCK}): {us:.3f} us/call", flush=True)
    rates = []
    if any(c.name.startswith("fori") for c in cases):
        rates = fori_rates()
        ok = ok and all(r["ok"] for r in rates)
    return ok, rates


if __name__ == "__main__":
    raise SystemExit(0 if main()[0] else 1)
