"""The merge probe's register layout (``csrc/probes.cu`` ``merge_kernel``)
as a numpy model, held bit for bit against ``merge_ref`` and the Pallas
body of ``scripts/tpu_vpu_roofline.py`` in interpret mode; and the pieces
of ``probes/merge_roofline.py`` that read the kernels' SASS and turn it
into a pipe floor.

The model follows the kernel step by step: a column's 64 candidates split
over G lanes (lane l holds flat indices j * G + l), the candidates past nc
-inf with hashes 0; each round a tree of adjacent pairs over the lane's
candidates (the right child only on a strict ``>``), log2 G butterfly steps
on (score, flat index) in which the lower index wins a tie, the winner's
hashes, every lane's knockout, and the f32 sum in round order. It runs at
every G the kernel was built and timed with (``LANES``), and takes the
winner's hashes both ways the kernel did: from the staged tile at the
winner's flat index (the kernel kept, ``stage``), or by each lane's pick of
its own winner and a shuffle from the owner (the unstaged forms). The
tolerance is zero: nothing rounds but the f32 adds, done in the same
order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu_torch.probes import merge_roofline as mr
from test_torch_lse import tree_pop
from test_torch_probes import ROOF, SHAPE, _bits, _merge_inputs, _pallas

NEG = np.float32(-np.inf)
ROUNDS = 8
# the lane counts built and timed on the card (``mr.MERGE_LANES`` is the
# one kept)
LANES = (1, 2, 4, 8)


def lanes_of(a, lanes, fill):
    """a [nc, cols] padded to 64 rows with ``fill`` and split over
    ``lanes``: [lanes, 64 / lanes, cols], lane l's row j the flat index
    j * lanes + l."""
    full = np.full((64, a.shape[1]), fill, a.dtype)
    full[:len(a)] = a
    return full.reshape(64 // lanes, lanes, -1).transpose(1, 0, 2).copy()


def butterfly(v, f, lanes):
    """The kernel's ``__shfl_xor_sync`` steps over each group of ``lanes``
    lanes: v, f [lanes, cols] -> the (score, flat index) every lane holds
    after them, the lower index taken on equal scores."""
    off = 1
    while off < lanes:
        partner = np.arange(lanes) ^ off
        v2, f2 = v[partner], f[partner]
        take = (v2 > v) | ((v2 == v) & (f2 < f))
        v, f = np.where(take, v2, v), np.where(take, f2, f)
        off <<= 1
    return v, f


def lane_argmax(cs, lanes):
    """One round's (best, flat index) of a column from its lanes' scores
    cs [lanes, n, cols]: each lane's tree, then the butterfly. Every lane
    ends with the same pair; lane 0's is returned."""
    v, j = tree_pop(cs.transpose(1, 0, 2))  # the tree runs over axis 0
    f = j * lanes + np.arange(lanes)[:, None]
    v, f = butterfly(v, f, lanes)
    assert (v == v[:1]).all() and (f == f[:1]).all()
    return v[0], f[0]


def merge_lanes(x, h1, h2, rounds, lanes, stage=False):
    """The kernel over x f32 [nc, cols] and the hashes (int32, same shape)
    with ``lanes`` lanes a column: f32 [cols]. With ``stage`` the winner's
    hashes come from the staged tile at its flat index, as in the kernel
    kept; else from the lane that owns it (each lane's pick of its own
    winner, then a shuffle from the owner)."""
    cs = lanes_of(x, lanes, NEG)
    c1 = lanes_of(h1.view(np.uint32), lanes, np.uint32(0))
    c2 = lanes_of(h2.view(np.uint32), lanes, np.uint32(0))
    tile = [lanes_of(h.view(np.uint32), 1, np.uint32(0))[0]
            for h in (h1, h2)]  # [64, cols]
    cols = np.arange(x.shape[1])
    acc = np.zeros(x.shape[1], np.float32)
    for _ in range(rounds):
        v, j = tree_pop(cs.transpose(1, 0, 2))
        f = j * lanes + np.arange(lanes)[:, None]
        best, f = butterfly(v, f, lanes)
        if stage:
            a, b = (t[f[0], cols] for t in tile)
        else:
            # each lane's pick of its own winner's hashes, then the owner's
            a_loc = np.take_along_axis(c1, j[:, None], 1)[:, 0]
            b_loc = np.take_along_axis(c2, j[:, None], 1)[:, 0]
            owner = f % lanes  # the same in every lane of the group
            a, b = a_loc[owner[0], cols], b_loc[owner[0], cols]
        cs = np.where((c1 == a) & (c2 == b), NEG, cs)
        o = best[0] + (a + b).view(np.int32).astype(np.float32)
        acc = acc + o
    return acc


@functools.lru_cache(maxsize=None)
def _case(hashes, nc):
    """(x, h1, h2) of ``_merge_inputs`` cut to nc candidates, the Pallas
    body's output and ``merge_ref``'s on them, at ``ROUNDS`` rounds."""
    x, h1, h2 = (a[:nc].copy() for a in _merge_inputs(hashes, seed=nc))
    want = np.asarray(_pallas(ROOF.make_merge_kernel(ROUNDS),
                              jax.ShapeDtypeStruct(SHAPE[1:], jnp.float32),
                              x, h1, h2))
    ref = mr.merge_ref(*map(torch.from_numpy, (x, h1, h2)), ROUNDS).numpy()
    return x, h1, h2, want, ref


@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("nc", [1, 5, 33, 64])
@pytest.mark.parametrize("hashes", ["same", "different", "few"])
def test_lane_model_matches_ref_and_pallas(hashes, nc, lanes, stage):
    x, h1, h2, want, ref = _case(hashes, nc)
    assert np.array_equal(_bits(ref), _bits(want))
    flat = [a.reshape(nc, -1) for a in (x, h1, h2)]
    got = merge_lanes(*flat, ROUNDS, lanes, stage).reshape(SHAPE[1:])
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("hashes", ["few", "unique"])
def test_lane_model_ties_and_neg_inf_columns(hashes):
    """Integer tie scores and whole -inf columns, with six hash classes or
    a hash pair of its own for every candidate (so that which of the tied
    candidates each round pops shows in the sum): every lane count gives
    merge_ref's bits."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, (64, 96)).astype(np.float32)
    x[:, :5] = NEG
    if hashes == "few":
        h1 = rng.integers(0, 3, x.shape).astype(np.int32)
        h2 = rng.integers(0, 2, x.shape).astype(np.int32)
    else:
        h1 = h2 = rng.permutation(x.size).astype(np.int32).reshape(x.shape)
    want = mr.merge_ref(*(torch.from_numpy(a[:, None]) for a in (x, h1, h2)),
                        ROUNDS)[0].numpy()
    for lanes in LANES:
        for stage in (False, True):
            got = merge_lanes(x, h1, h2, ROUNDS, lanes, stage)
            assert np.array_equal(_bits(got), _bits(want))


# A cut of ``cuobjdump -sass`` output in its layout: a kernel with a loop
# that runs 2 FSETP, an FSEL, a predicated FADD and its branch, and the
# self-branch that ends every kernel; the branches to addresses, as this
# toolkit prints them, or to labels, as others do.
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113stream_kernelILi4ELi8EEEvPKfPKjS4_Pfiiii
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
                                                                /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;           /* 0x0000000000007919 */
        /*0020*/                   FSETP.GT.AND P0, PT, R2, R3, PT ;
        /*0030*/                   FSETP.GEU.AND P1, PT, R2, R4, PT ;
        /*0040*/                   FSEL R2, R3, R2, P0 ;
        /*0050*/               @P1 FADD R5, R5, R2 ;
        /*0060*/               @P0 BRA 0x20 ;               /* 0xfffffffc00000947 */
        /*0070*/                   STG.E desc[UR4][R6.64], R5 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;                    /* 0xfffffffc00fc7947 */
\t\tFunction : _ZN12_GLOBAL__N_112issue_kernelILi0EEEvPKjPji
        /*0000*/                   MOV R2, 0x1 ;
.L_x_1:
        /*0010*/                   FADD R2, R2, R2 ;
        /*0020*/               @P0 BRA `(.L_x_1) ;
.L_x_2:
        /*0030*/                   BRA `(.L_x_2);
"""


def test_parse_sass_finds_the_loop():
    funcs = mr.parse_sass(SASS)
    assert len(funcs) == 2
    instrs = mr.kernel_sass(funcs, "stream_kernelILi4ELi8E")
    assert [op for op, _ in instrs] == ["LDC", "S2R", "FSETP", "FSETP",
                                        "FSEL", "FADD", "BRA", "STG",
                                        "EXIT", "BRA"]
    assert mr.loops(instrs) == [(2, 6)]
    assert mr.counts(instrs, 2, 6) == {"FSETP": 2, "FSEL": 1, "FADD": 1,
                                       "BRA": 1}
    dyn = mr.dynamic_counts(instrs, 10)
    assert dyn["FSETP"] == 20 and dyn["FADD"] == 10 and dyn["LDC"] == 1
    assert dyn["BRA"] == 11  # the loop's ten and the final self-branch
    # the scale of stream_mix: 4 FADDs an element and round
    mix = mr.stream_mix({"x_stream_kernelEPKf": instrs})
    assert mix["FADD"] == 4 and mix["FSETP"] == 8 and mix["FSEL"] == 4
    with pytest.raises(ValueError, match="kernels match"):
        mr.kernel_sass(funcs, "kernel")
    labelled = mr.kernel_sass(funcs, "issue_kernelILi0E")
    assert mr.loops(labelled) == [(1, 2)]
    assert mr.dynamic_counts(labelled, 5) == {"MOV": 1, "FADD": 5,
                                              "BRA": 6}


def test_pipe_floor_hand_count():
    # FADD at 2e12 a second, the ALU's kinds at 1e12, SHFL at 0.5e12
    table = {"FADD": 2e12, "FMNMX": 1e12, "FSETP": 1e12, "FSEL": 1e12,
             "SHFL": 0.5e12}
    mix = {"FADD": 4, "FMNMX": 4, "FSETP": 4, "FSEL": 4, "LDG": 3}
    fl = mr.pipe_floor(mix, 1000, table)
    assert fl["by"] == "alu"
    assert fl["terms_s"]["alu"] == pytest.approx(12 * 1000 / 1e12)
    assert fl["terms_s"]["fma"] == pytest.approx(4 * 1000 / 2e12)
    assert fl["terms_s"]["issue"] == pytest.approx(19 * 1000 / 2e12)
    assert fl["terms_s"]["shfl"] == 0
    assert fl["floor_s"] == fl["terms_s"]["alu"]
    # a shuffle-heavy mix is bound by its shuffles
    assert mr.pipe_floor({"SHFL": 10, "FADD": 1}, 1, table)["by"] == "shfl"


def test_rate_table_drops_the_mix():
    rates = {k: {"per_s": float(i + 1)} for i, k in
             enumerate(mr.ISSUE_KINDS)}
    table = mr.rate_table(rates)
    assert table["FSETP"] == table["FSEL"] == 3.0
    assert table["FADD"] == 1.0 and table["FMNMX"] == 2.0
    assert set(table) == {op for k, ops in mr.ISSUE_KINDS.items()
                          if k != "fadd_fmnmx" for op in ops}
