"""Decode spec and trellis tables for the list-Viterbi port, in natural conv
indexing.

Counterparts: ``nanopore_dna_storage_tpu/ops/lva.py`` ``LVASpec.build`` and
``nanopore_dna_storage_tpu/ops/lva_pallas.py`` ``build_consts``. The Pallas
tables store conv state ``s`` at lane ``bitrev(s)`` so that predecessor
reads become lane rolls on the TPU; on the GPU a predecessor is a plain
indexed load, so every table here is indexed by the conv state itself:
the move candidate ``c`` into state ``s`` reads predecessor
``(k*s + c) mod C`` with ``k = 2`` under pattern 0 and ``k = 4`` otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..coding.conv import ConvCode, NSTATE_CRF, make_conv_code
from ..config import DecodeConfig
from ..trellis import tables as tb

NCRF = NSTATE_CRF  # 8 flip-flop CRF states

# Dual modular-hash dedup primes (largest primes < 2^30, so h*4 + 3 < 2^32).
HASH_P1 = 1073741789
HASH_P2 = 1073741783

# CRF move predecessors: flip f from any g != f, flop f from flip f-4 only
# (viterbi_convolutional_code.cpp:878-889).
CRF_MASK = tb.crf_move_mask()
G_LISTS = [tuple(int(g) for g in range(NCRF) if CRF_MASK[f, g])
           for f in range(NCRF)]
# Merge rows per CRF destination: the stay row plus one move row per g.
NQ_MAX = 1 + max(len(gl) for gl in G_LISTS)  # 8


def sel_format(L: int) -> Tuple[torch.dtype, int]:
    """(dtype, shift) of the per-slot selection code ``q*shift + slot``.

    q <= NQ_MAX - 1 = 7, so for L <= 16 the code fits int8 (7*16 + 15 =
    127); above that it is int16 with shift 64 (ops/lva_pallas.py:122-128).
    """
    return (torch.int8, 16) if L <= 16 else (torch.int16, 64)


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Everything shape-determining about one decode problem."""

    code: ConvCode
    list_size: int
    window: int  # beam width W
    npos_pad: int  # padded positions P, incl. the leading ghost row
    n_msg_words: int  # 32-bit words per traced-back message
    combine_lse: bool  # logsumexp path combining (else max)

    @classmethod
    def build(cls, cfg: DecodeConfig) -> Tuple["DecodeSpec",
                                               tb.TrellisTables]:
        code = make_conv_code(cfg.code)
        tabs = tb.build_tables(code, cfg.max_deviation)
        return cls(code=code, list_size=cfg.list_size, window=tabs.window,
                   npos_pad=tabs.npos_pad + 1,
                   n_msg_words=-(-(code.config.msg_len + code.mem) // 32),
                   combine_lse=cfg.path_combine == "logsumexp"), tabs


@dataclasses.dataclass(frozen=True)
class LVAConsts:
    """Host tables (numpy) of one decode problem, natural conv indexing."""

    cstar: np.ndarray  # int32 [4 pattern, 4 base, C]: the unique candidate
    #                    c whose move into state s emits the base; -1 if none
    nbits: np.ndarray  # int32 [2, C]: message bits appended on a move into
    #                    s (row 0: pattern 0, 1 bit; row 1: 2 bits)
    valid: np.ndarray  # uint8 [P, C]: valid states, ghost row 0 all-invalid
    pattern: np.ndarray  # int32 [P]: puncture pattern of moves into a row
    qmap: np.ndarray  # int32 [8, NQ_MAX]: merge row q -> CRF predecessor g
    #                   (row 0 is the stay row; -1 pads)
    stay_idx: np.ndarray  # int64 [8]: flat post index of each stay
    move_idx: np.ndarray  # int64 [8, 8]: flat post index of move g -> f
    init_state: int
    final_state: int

    @classmethod
    def build(cls, spec: DecodeSpec, tabs: tb.TrellisTables) -> "LVAConsts":
        code = spec.code
        C = code.nstate_conv
        base_out = tabs.base_out.astype(np.int32).transpose(0, 2, 1)  # [4,4c,C]
        cstar = np.full((4, 4, C), -1, np.int32)
        for p in range(4):
            ncs = 2 if p == 0 else 4
            for beta in range(4):
                hit = base_out[p, :ncs, :] == beta  # [ncs, C]
                # bit 0 of both generators is 1 for every supported code, so
                # at most one candidate emits each base: the merge then has
                # one move row per CRF predecessor (ops/lva_pallas.py:65-76)
                if (hit.sum(axis=0) > 1).any():
                    raise ValueError(f"base map not injective (pattern {p})")
                cstar[p, beta] = np.where(hit.any(axis=0),
                                          hit.argmax(axis=0), -1)
        valid = np.concatenate([np.zeros((1, C), bool), tabs.valid_state])
        qmap = np.full((NCRF, NQ_MAX), -1, np.int32)
        for f in range(NCRF):
            qmap[f, 1:1 + len(G_LISTS[f])] = G_LISTS[f]
        return cls(
            cstar=cstar,
            nbits=np.stack([tabs.newbits1, tabs.newbits2]).astype(np.int32),
            valid=valid.astype(np.uint8),
            pattern=np.concatenate([[0], tabs.pattern_of_pos]).astype(
                np.int32),
            qmap=qmap,
            stay_idx=tb.stay_post_index().astype(np.int64),
            move_idx=tb.move_post_index().astype(np.int64),
            init_state=int(code.initial_state),
            final_state=int(code.final_state))

    def to(self, device) -> Dict[str, torch.Tensor]:
        """The tables as contiguous tensors on ``device``."""
        dev = torch.device(device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in dataclasses.asdict(self).items()
                if isinstance(v, np.ndarray)}


def from_pallas_state(consts_jax_np, bufs) -> Tuple[torch.Tensor, ...]:
    """Carry decoder state from the JAX Pallas decoder into the port.

    ``consts_jax_np`` is the reference's ``PallasConsts`` (numpy); ``bufs``
    are its (score f32, h1 i32, h2 i32) buffers as numpy arrays
    ``[..., P, 8, L, C]`` with the conv axis bit-reversed. Lane ``r`` holds
    state ``perm[r]`` and ``perm`` is an involution, so natural state ``s``
    sits at lane ``perm[s]``. Hashes are int32 bit patterns of values below
    2^30 in both packages, so their bits carry over unchanged.
    """
    perm = np.asarray(consts_jax_np.perm)
    sc, h1, h2 = (np.asarray(b) for b in bufs)
    return (torch.from_numpy(np.ascontiguousarray(sc[..., perm], np.float32)),
            torch.from_numpy(np.ascontiguousarray(
                h1[..., perm]).view(np.int32)),
            torch.from_numpy(np.ascontiguousarray(
                h2[..., perm]).view(np.int32)))
