"""The predecessor expansion ``y[j] = x[j >> log k]`` and its relatives on
a CUDA card: by a gather, by warp shuffles, and by the TPU's roll
butterfly.

Counterpart of ``scripts/tpu_pallas_probe2.py`` (P2), ``scripts/
tpu_repeat_probe.py`` (P3) and ``scripts/tpu_expand_probe.py`` (P4), which
asked which formulation of the lane upsample the TPU compiler took and what
it cost. Two kernels (``csrc/expand.cu``):

* ``lane_map``: ``y[r, j] = x[src(r, j)]`` over f32 rows, for the maps
  ``element`` (``j >> log k``), ``tile`` (``j mod n``: what
  ``pltpu.repeat`` computes), ``pair`` (``j & ~1``: ``p_roll``) and
  ``row`` (rows repeated twice: ``p_subl_upsample``), in the forms
  ``gather``, ``shfl`` (element map only) and ``butterfly`` (the scripts'
  masked roll stages, element map only);
* ``transpose``: ``[R, C] -> [C, R]`` (``p_transpose``).

Each has a plain PyTorch version (``lane_map_ref``, ``transpose_ref``);
CPU tensors take it, CUDA tensors launch the kernel.

    python -m nanopore_dna_storage_tpu_torch.probes.expand [name ...]

runs the scripts' cases (all by default; a name is a case such as
``p3.jnp_repeat.k4`` or a prefix such as ``p4``) at their shapes and
prints each check and the time per call.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops._build import check_tensor, load_expand

FORMS = ("gather", "shfl", "butterfly")
MAPS = ("element", "tile", "pair", "row")
STARTS = ("identity", "tile")

# calls in the CUDA graph that times one call of a case
GRAPH_CALLS = 100
# elements of x one block of the transpose kernel stages in shared memory
TRANSPOSE_TILE = 2048

# Kernel launches made through ``lane_map`` (by form) and ``transpose``
# (CUDA tensors only).
LAUNCHES = {"gather": 0, "shfl": 0, "butterfly": 0, "transpose": 0}


def _logk(k: int) -> int:
    if k < 1 or k & (k - 1):
        raise ValueError(f"k must be a power of two, not {k}")
    return k.bit_length() - 1


def bfly_masks(ct: int, logk: int) -> np.ndarray:
    """The roll butterfly's stage masks, int32 [S, ct]: passes of shifts
    ct/2 .. 1, each lane taking its rolled neighbour while that moves its
    tracked source index toward ``j >> logk``, until every lane holds its
    source (at most two passes); ``tpu_expand_probe.py`` ``bfly_masks``."""
    src = np.arange(ct) >> logk
    cur = np.arange(ct)
    masks = []
    for _ in range(2):
        d = ct // 2
        while d >= 1:
            cr = np.roll(cur, d)
            take = (cr >= src) & (cr < cur)
            cur = np.where(take, cr, cur)
            masks.append(take)
            d //= 2
        if (cur == src).all():
            break
    if not (cur == src).all():
        raise ValueError(f"no butterfly reaches j >> {logk} in two passes")
    return np.stack(masks).astype(np.int32)


def tracked_masks(ct: int, logk: int) -> np.ndarray:
    """One pass of the same stages, as ``tpu_pallas_probe2.py``
    ``p_butterfly`` computes them inside its kernel from the lane iota."""
    src = np.arange(ct) >> logk
    cur = np.arange(ct)
    masks = []
    for d in butterfly_shifts(ct, int(np.log2(ct))):
        cr = np.roll(cur, d)
        take = (cr >= src) & (cr < cur)
        cur = np.where(take, cr, cur)
        masks.append(take)
    return np.stack(masks).astype(np.int32)


def pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """Stage masks int32 [S, C] (0 or not) as the butterfly kernel reads
    them, bits in int32 [S, C / 32]: bit ``j % 32`` of word ``j // 32`` is
    the mask of column j."""
    S, C = masks.shape
    if C % 32:
        raise ValueError(f"{C} columns do not pack into 32-bit words")
    bit = torch.arange(32, device=masks.device, dtype=torch.int64)
    words = ((masks != 0).view(S, C // 32, 32).long() << bit).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).int()


def butterfly_shifts(ct: int, nst: int) -> Tuple[int, ...]:
    """Shifts ct/2, ct/4, .., 1, repeated, cut to ``nst`` stages
    (``tpu_expand_probe.py`` ``shifts``)."""
    one = [ct >> (1 + i) for i in range(int(np.log2(ct)))]
    return tuple((one * 2)[:nst])


def out_shape(shape, map_: str) -> Tuple[int, int]:
    """Output [rows, cols] of ``lane_map`` on an input of ``shape``."""
    r, c = shape
    return (2 * r if map_ == "row" else r), c


def _source(map_: str, k: int, shape, device) -> Tuple[torch.Tensor, ...]:
    """Source rows [rout, 1] and columns [1, cout] of every output."""
    rout, cout = out_shape(shape, map_)
    r = torch.arange(rout, device=device)[:, None]
    j = torch.arange(cout, device=device)[None, :]
    if map_ == "element":
        return r, j >> _logk(k)
    if map_ == "tile":
        return r, j % (cout // k)
    if map_ == "pair":
        return r, j & ~1
    return r >> 1, j


def _check_args(map_, k, form, start, masks, shifts):
    if map_ not in MAPS:
        raise ValueError(f"unknown map {map_!r}")
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}")
    if form != "gather" and map_ != "element":
        raise ValueError(f"the {form} form computes the element map only")
    if form == "shfl" and not 1 <= k <= 32:
        raise ValueError("shfl takes k <= 32")
    if form == "butterfly":
        if start not in STARTS:
            raise ValueError(f"unknown start {start!r}")
        if masks is None or masks.shape[0] != len(shifts):
            raise ValueError("the butterfly takes one mask row per shift")
    _logk(k)


def lane_map_ref(x: torch.Tensor, map_: str, k: int = 2,
                 form: str = "gather", masks: Optional[torch.Tensor] = None,
                 shifts: Sequence[int] = (), start: str = "tile"
                 ) -> torch.Tensor:
    """Plain PyTorch lane map: f32 [R, C] -> f32 ``out_shape``. The gather
    and shfl forms index the source; the butterfly repeats the scripts'
    ``where(mask, roll(y, d), y)`` stages from the identity or from the
    tile of the first C / k columns."""
    _check_args(map_, k, form, start, masks, shifts)
    if form != "butterfly":
        sr, sc = _source(map_, k, x.shape, x.device)
        return x[sr, sc]
    y = x[_source("tile", k, x.shape, x.device)] if start == "tile" else x
    for m, d in zip(masks, shifts):
        y = torch.where(m != 0, torch.roll(y, d, 1), y)
    return y


def lane_map(x: torch.Tensor, map_: str, k: int = 2, form: str = "gather",
             copies: int = 1, masks: Optional[torch.Tensor] = None,
             shifts: Sequence[int] = (), start: str = "tile",
             bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``copies`` copies of the lane map over one input: x f32 [R, C] ->
    f32 [copies, *out_shape], every copy the same. The butterfly takes
    ``masks`` int32 [S, C] and ``shifts`` (S ints in [0, C)); its kernel
    reads the masks as bits, which the wrapper packs (``pack_masks``)
    unless ``bits`` brings them packed. CPU tensors run ``lane_map_ref`` on
    the copies; CUDA tensors launch the kernel of ``csrc/expand.cu``, which
    writes each copy to its own slot (gather: C % 4 == 0; shfl: C % 32 ==
    0; butterfly: C % 64 == 0, C <= 2048); anything else raises."""
    _check_args(map_, k, form, start, masks, shifts)
    dev = x.device
    if dev.type == "cpu":
        ref = lane_map_ref(x, map_, k, form, masks, shifts, start)
        return ref.expand(copies, *ref.shape)
    if dev.type != "cuda":
        raise ValueError(f"lane_map runs on cpu or cuda, not {dev}")
    if x.dim() != 2 or copies < 1:
        raise ValueError("lane_map takes x [R, C] and copies >= 1")
    rout, cout = out_shape(x.shape, map_)
    if map_ in ("element", "tile") and cout % k:
        raise ValueError(f"{cout} columns do not split into k = {k}")
    if cout % {"gather": 4, "shfl": 32, "butterfly": 64}[form] or (
            form == "butterfly" and cout > 2048):
        raise ValueError(f"the {form} form does not take {cout} columns")
    check_tensor("x", x, torch.float32, x.shape, dev)
    shift_arr = None
    mask_ptr = None
    if form == "butterfly":
        check_tensor("masks", masks, torch.int32, (len(shifts), cout), dev)
        if bits is None:
            bits = pack_masks(masks)
        check_tensor("bits", bits, torch.int32, (len(shifts), cout // 32),
                     dev)
        shift_arr = (ctypes.c_int * len(shifts))(*shifts) if shifts else None
        mask_ptr = bits.data_ptr()
    y = torch.empty((copies, rout, cout), dtype=torch.float32, device=dev)
    p = cout // k if map_ == "tile" else _logk(k)
    lib = load_expand()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.expand_lane_map_launch(
            x.data_ptr(), y.data_ptr(), FORMS.index(form), MAPS.index(map_),
            p, x.shape[1], rout, cout, copies, mask_ptr, shift_arr,
            len(shifts), int(start == "tile"), stream)
    if err != 0:
        raise RuntimeError(f"lane_map ({form}) launch failed: "
                           + lib.expand_error_string(err).decode())
    LAUNCHES[form] += 1
    return y


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch transpose of f32 [R, C], as a new [C, R] tensor."""
    return x.t().contiguous()


def transpose_plan(R: int, C: int, aligned: bool = True) -> Tuple[int, bool]:
    """How the transpose kernel cuts x f32 [R, C]: the rows of its tile (4,
    8, 16 or 32, the fewest that hold R; the tile is ``TRANSPOSE_TILE`` /
    rows columns wide, one block of ``TRANSPOSE_TILE`` / 4 threads each) and
    whether it takes 16-byte loads and stores (R and C multiples of 4, the
    data ``aligned`` to 16 bytes) or 4-byte ones."""
    rows = next(t for t in (4, 8, 16, 32) if R <= t or t == 32)
    return rows, R % 4 == 0 and C % 4 == 0 and aligned


def transpose(x: torch.Tensor, copies: int = 1) -> torch.Tensor:
    """``copies`` copies of x f32 [R, C] transposed: f32 [copies, C, R].
    CPU tensors run ``transpose_ref``; CUDA tensors launch the kernel of
    ``csrc/expand.cu``, cut as ``transpose_plan`` says; anything else
    raises."""
    dev = x.device
    if dev.type == "cpu":
        ref = transpose_ref(x)
        return ref.expand(copies, *ref.shape)
    if dev.type != "cuda":
        raise ValueError(f"transpose runs on cpu or cuda, not {dev}")
    if x.dim() != 2 or copies < 1:
        raise ValueError("transpose takes x [R, C] and copies >= 1")
    check_tensor("x", x, torch.float32, x.shape, dev)
    R, C = x.shape
    y = torch.empty((copies, C, R), dtype=torch.float32, device=dev)
    rows, vec = transpose_plan(
        R, C, (x.data_ptr() | y.data_ptr()) % 16 == 0)
    lib = load_expand()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.expand_transpose_launch(x.data_ptr(), y.data_ptr(), R, C,
                                          copies, rows, int(vec), stream)
    if err != 0:
        raise RuntimeError("transpose launch failed: "
                           + lib.expand_error_string(err).decode())
    LAUNCHES["transpose"] += 1
    return y


@dataclasses.dataclass(frozen=True)
class Case:
    """One script case: ``name`` (script.function[.k]), the kernel call it
    makes and the numpy result the script checks it against."""

    name: str
    replaces: str  # file:line of the script's pallas_call
    shape: Tuple[int, int]
    map_: str = "element"  # "transpose" for p_transpose
    k: int = 2
    forms: Tuple[str, ...] = ("gather", "shfl")
    start: str = "tile"  # butterfly only
    masks: Optional[Callable] = None  # (cols, logk) -> int32 [S, cols]
    arange: bool = False  # input 0, 1, 2, .. instead of normal values

    def inputs(self, device) -> Tuple[np.ndarray, torch.Tensor]:
        if self.arange:
            x = np.arange(np.prod(self.shape), dtype=np.float32)
        else:
            x = np.random.default_rng(0).standard_normal(self.shape)
        x = x.astype(np.float32).reshape(self.shape)
        return x, torch.from_numpy(x).to(device)

    def want(self, x: np.ndarray) -> np.ndarray:
        if self.map_ == "transpose":
            return x.T
        if self.map_ == "row":
            return np.repeat(x, 2, 0)
        n = x.shape[1] // self.k
        if self.map_ == "tile":
            return np.tile(x[:, :n], (1, self.k))
        if self.map_ == "pair":
            j = np.arange(x.shape[1])[None, :]
            return np.where(j % 2 == 0, x, np.roll(x, 1, 1))
        return x[:, :n].repeat(self.k, axis=1)

    def bind(self, xt: torch.Tensor, form: str):
        """(kernel, plain) for ``form`` on ``xt``: ``kernel(copies)``
        writes ``copies`` slots, ``plain()`` one result; the butterfly's
        masks are made and packed once, here."""
        if self.map_ == "transpose":
            return (lambda copies=1: transpose(xt, copies),
                    lambda: transpose_ref(xt))
        kw, bits = {}, None
        if form == "butterfly":
            masks = torch.from_numpy(self.masks(xt.shape[1], _logk(self.k)))
            kw = dict(masks=masks.to(xt.device), start=self.start,
                      shifts=butterfly_shifts(xt.shape[1], masks.shape[0]))
            bits = pack_masks(kw["masks"])
        return (lambda copies=1: lane_map(xt, self.map_, self.k, form,
                                          copies, bits=bits, **kw),
                lambda: lane_map_ref(xt, self.map_, self.k, form, **kw))

P2, P3, P4 = ("scripts/tpu_pallas_probe2.py", "scripts/tpu_repeat_probe.py",
              "scripts/tpu_expand_probe.py")
CASES = (
    Case("p2.take", f"{P2}:19", (8, 1024)),
    Case("p2.jnprepeat", f"{P2}:19", (8, 1024)),
    Case("p2.pltpurepeat_semantics", f"{P2}:19", (8, 1024), "tile",
         forms=("gather",), arange=True),
    Case("p2.transpose", f"{P2}:73", (16, 128), "transpose",
         forms=("transpose",)),
    Case("p2.subl_upsample", f"{P2}:85", (8, 128), "row", forms=("gather",)),
    Case("p2.roll", f"{P2}:19", (8, 1024), "pair", forms=("gather",)),
    Case("p2.butterfly", f"{P2}:19", (8, 1024), forms=("butterfly",),
         start="identity", masks=tracked_masks),
    *(c for k in (2, 4) for c in (
        Case(f"p3.jnp_repeat.k{k}", f"{P3}:52", (8, 2048), k=k),
        Case(f"p3.pltpu_repeat.k{k}", f"{P3}:52", (8, 2048), "tile", k=k,
             forms=("gather",)),
        Case(f"p3.roll_butterfly.k{k}", f"{P3}:52", (8, 2048), k=k,
             forms=("butterfly",), masks=bfly_masks),
        Case(f"p4.bcast_reshape.k{k}", f"{P4}:70", (8, 2048), k=k),
        Case(f"p4.stack_reshape.k{k}", f"{P4}:70", (8, 2048), k=k),
        Case(f"p4.butterfly.k{k}", f"{P4}:70", (8, 2048), k=k,
             forms=("butterfly",), masks=bfly_masks))),
)


def graph_us(fn) -> float:
    """Device time of one ``fn()`` in microseconds: ``GRAPH_CALLS`` calls
    captured in one CUDA graph and replayed, so the host's launch cost
    drops out, as the scripts timed a loop of calls inside one jit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # build, load and warm off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_CALLS):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return 1e3 * a.elapsed_time(b) / GRAPH_CALLS


def run(case: Case, device: str = "cuda") -> bool:
    """Every form of ``case`` on ``device``: prints the script's check
    (OK / WRONG against the numpy result it checks with) and, on a CUDA
    device, the device time per call (``graph_us``); True if every form is
    right."""
    x, xt = case.inputs(device)
    want = case.want(x)
    ok = True
    for form in case.forms:
        kernel, _ = case.bind(xt, form)
        y = kernel()[0].cpu().numpy()
        good = np.array_equal(y.view(np.uint32), want.view(np.uint32))
        ok &= good
        line = f"{case.name} [{form}]: {'OK' if good else 'WRONG'}"
        if device != "cpu":
            line += f" {graph_us(kernel):.3f} us/call"
        print(line, flush=True)
    if case.map_ == "tile":  # what the scripts print about pltpu.repeat
        element = x[:, :x.shape[1] // case.k].repeat(case.k, axis=1)
        kind = "element" if np.array_equal(y, element) else \
            "tile" if np.array_equal(y, want) else "other"
        print(f"{case.name}: pltpu.repeat semantics: {kind} "
              f"(correct={kind == 'element'} against jnp.repeat)",
              flush=True)
    return ok


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


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help="cases or prefixes (p2, p3.jnp_repeat, ...); "
                         "default all")
    args = ap.parse_args(argv)
    try:
        cases = select(args.names)
    except ValueError as e:
        ap.error(str(e))
    if not torch.cuda.is_available():
        raise SystemExit("expand: needs a CUDA device")
    return all([run(c) for c in cases])


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
