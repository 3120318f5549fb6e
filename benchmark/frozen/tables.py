"""Trellis tables for the joint (position x conv-state x CRF-state) decoder.

TPU-first reformulation of the reference's per-state predecessor enumeration
(viterbi_convolutional_code.cpp:860-942 ``find_prev_states`` and :944-978
``is_valid_state``). Instead of materializing a ragged predecessor list per
state, we exploit structure:

* Conv predecessors of state ``s`` are ``(2s + b) mod 2^m`` (one input bit,
  pattern 0) or ``(4s + c) mod 2^m`` (two input bits, patterns 1-3). Indexed
  over all states at once this is a reshape+tile, not a gather:
  ``prev_vals[(k*s + c) % 2^m] == tile(vals.reshape(2^m/k, k), (k, 1))``.
* Whether a conv transition emits base ``beta`` is independent of the CRF
  predecessor; it is a tiny precomputed table ``base_out[s, c]``.
* CRF predecessor structure is dense over the 8 states with a static mask
  (new-base transitions enter flip states from any other state; flop state
  ``f+4`` is entered only from flip ``f``; stays are separate).

All tables are small (O(2^m) ints), replicated per chip.

Frozen copy of ``nanopore_dna_storage_tpu_torch/trellis/tables.py`` at commit 35018d1,
kept by the benchmark so that its yardstick does not move with the program.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from .conv import ConvCode, NSTATE_CRF, NBASE


def _parity_u32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return (x & 1).astype(np.uint8)


def _conv_out_base(code: ConvCode, st1: np.ndarray, bit: np.ndarray) -> np.ndarray:
    """Base (0..3) emitted by transition from conv state st1 on input ``bit``.

    base = 2*out0 + out1, with each output XORed by the rc flag
    (viterbi_convolutional_code.cpp:440-448).
    """
    word = np.asarray(st1, dtype=np.uint32) | (
        np.asarray(bit, dtype=np.uint32) << code.mem)
    rc = np.uint8(code.config.rc)
    out0 = _parity_u32(word & np.uint32(code.g0)) ^ rc
    out1 = _parity_u32(word & np.uint32(code.g1)) ^ rc
    return (2 * out0 + out1).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class TrellisTables:
    """All static per-config decode tables."""

    code: ConvCode
    # base_out[p, s, c]: base emitted when entering conv state s, where the
    # dropped predecessor bits are c (c < 2 for p == 0, c < 4 otherwise);
    # 255 marks unused (p, c) combinations. uint8 [4, nstate_conv, 4].
    base_out: np.ndarray
    # msg bits appended on a move into conv state s. For pattern 0 this is the
    # newest state bit (shift 1); for patterns 1-3 the two newest (shift 2),
    # packed as 2*bit[m-2] + bit[m-1]... see cpp:901,933. uint8 [nstate_conv].
    newbits1: np.ndarray  # pattern 0, values 0..1
    newbits2: np.ndarray  # patterns 1-3, values 0..3
    # valid_state[pos, s] per is_valid_state; positions beyond nstate_pos
    # (ghost padding for the sliding beam) are all-invalid.
    # bool [npos_pad, nstate_conv].
    valid_state: np.ndarray
    # pattern_of_pos[pos]: puncturing element governing transitions INTO pos
    # (pos >= 1); entry 0 unused (=0). uint8 [npos_pad].
    pattern_of_pos: np.ndarray
    # per-t beam start position, replicating the reference's double-precision
    # formula (cpp:677-679). int32 [nblk] — built per nblk via beam_schedule().
    window: int  # static beam width W = min(2*max_deviation, nstate_pos)
    npos_pad: int
    max_deviation: int

    @property
    def nstate_conv(self) -> int:
        return self.code.nstate_conv

    @property
    def nstate_pos(self) -> int:
        return self.code.nstate_pos


def stay_post_index() -> np.ndarray:
    """Flat 5x8 post index of the stay transition for each CRF state.

    Stay in flip f scores post[f, f]; stay in flop f+4 scores post[4, f+4]
    (to_idx_crf_in_post, viterbi_convolutional_code.cpp:582-587, 872-873).
    """
    idx = np.empty(NSTATE_CRF, dtype=np.int32)
    for c in range(NSTATE_CRF):
        row = c if c < NBASE else NBASE
        idx[c] = row * NSTATE_CRF + c
    return idx


def move_post_index() -> np.ndarray:
    """Flat post index for a move into CRF state f from CRF state g.

    move_post[f, g] = row(f) * 8 + g. int32 [8, 8].
    """
    rows = np.array([f if f < NBASE else NBASE for f in range(NSTATE_CRF)])
    return (rows[:, None] * NSTATE_CRF
            + np.arange(NSTATE_CRF)[None, :]).astype(np.int32)


def crf_move_mask() -> np.ndarray:
    """mask[f, g]: CRF move g -> f allowed (f != g; flop only from its flip).

    bool [8, 8]. (viterbi_convolutional_code.cpp:878-889.)
    """
    f = np.arange(NSTATE_CRF)[:, None]
    g = np.arange(NSTATE_CRF)[None, :]
    flip_ok = (f < NBASE) & (g != f)
    flop_ok = (f >= NBASE) & (g == f - NBASE)
    return flip_ok | flop_ok


def _valid_state_table(code: ConvCode, npos_pad: int) -> np.ndarray:
    """Vectorized is_valid_state over (pos, conv state). cpp:944-978."""
    mem, msg_len = code.mem, code.config.msg_len
    nconv = code.nstate_conv
    msg_pos = np.asarray(code.st_pos2msg_pos, dtype=np.int64)  # [nstate_pos]
    s = np.arange(nconv, dtype=np.int64)
    shifts = np.arange(mem, dtype=np.int64)
    # pos_in_msg[pos, shift]
    pim = msg_pos[:, None] - 1 - shifts[None, :]
    # bit_at_shift[s, shift] = (s >> (mem-1-shift)) & 1
    bit = ((s[:, None] >> (mem - 1 - shifts[None, :])) & 1)  # [S, mem]
    init_bit = ((code.initial_state >> np.clip(mem + pim, 0, 31)) & 1)
    final_bit = ((code.final_state >> np.clip(pim - msg_len, 0, 31)) & 1)
    ok = np.ones((code.nstate_pos, nconv), dtype=bool)
    for region, req in (
        (pim < 0, init_bit),
        (pim >= msg_len, final_bit),
    ):
        # constraint[pos, s, shift]
        c = ~region[:, None, :] | (bit[None, :, :] == req[:, None, :])
        ok &= c.all(axis=2)
    if code.sync_marker_bits:
        period = code.sync_period
        marker = np.asarray(code.sync_marker_bits, dtype=np.int64)
        pim_fwd = np.where(
            code.config.rc, msg_len - 1 - pim, pim)
        in_msg = (pim >= 0) & (pim < msg_len)
        mod = np.mod(pim_fwd, period)
        in_marker = in_msg & (mod < len(marker))
        req = marker[np.clip(mod, 0, len(marker) - 1)]
        c = ~in_marker[:, None, :] | (bit[None, :, :] == req[:, None, :])
        ok &= c.all(axis=2)
    out = np.zeros((npos_pad, nconv), dtype=bool)
    out[: code.nstate_pos] = ok
    return out


@lru_cache(maxsize=32)
def _build_cached(code: ConvCode, max_deviation: int) -> TrellisTables:
    nconv = code.nstate_conv
    s = np.arange(nconv, dtype=np.int64)
    mask = nconv - 1
    base_out = np.full((4, nconv, 4), 255, dtype=np.uint8)
    newest = (s >> (code.mem - 1)).astype(np.uint8)  # curr_conv_bit
    second = ((s >> (code.mem - 2)) & 1).astype(np.uint8)  # curr_conv_bit_1
    # pattern 0: predecessor st1 = (2s + b) & mask emits on input bit = newest
    for b in range(2):
        st1 = (2 * s + b) & mask
        base_out[0, :, b] = _conv_out_base(code, st1, newest)
    # patterns 1-3: two-step predecessor st1 = (4s + 2b + b1) & mask.
    # The four raw output bits over the two steps are punctured down to one
    # base per pattern; under rc the kept pair order flips (cpp:905-937).
    for b in range(2):
        for b1 in range(2):
            c = 2 * b + b1
            st15 = (2 * s + b) & mask
            st1 = (2 * st15 + b1) & mask
            word1 = st1 | (second.astype(np.int64) << code.mem)
            word2 = st15 | (newest.astype(np.int64) << code.mem)
            rc = np.uint8(code.config.rc)
            bit0 = _parity_u32(word1 & code.g0) ^ rc
            bit1 = _parity_u32(word1 & code.g1) ^ rc
            bit2 = _parity_u32(word2 & code.g0) ^ rc
            bit3 = _parity_u32(word2 & code.g1) ^ rc
            pairs = {
                1: (bit2, bit1) if code.config.rc else (bit1, bit2),
                2: (bit3, bit0) if code.config.rc else (bit0, bit3),
                3: (bit3, bit1) if code.config.rc else (bit1, bit3),
            }
            for p, (hi, lo) in pairs.items():
                base_out[p, :, c] = 2 * hi + lo

    dev = max_deviation
    window = min(2 * dev, code.nstate_pos)
    # The beam start trunc((t/nblk)*npos - dev) never exceeds npos - dev - 1;
    # pad ghost (always-invalid) positions so a static-size window slice never
    # clamps and never re-updates positions the reference leaves stale.
    start_max = max(0, code.nstate_pos - 1 - dev)
    npos_pad = max(code.nstate_pos, start_max + window)

    pattern_of_pos = np.zeros(npos_pad, dtype=np.uint8)
    plen = len(code.pattern)
    for pos in range(1, npos_pad):
        pattern_of_pos[pos] = code.pattern[(pos - 1) % plen]

    return TrellisTables(
        code=code,
        base_out=base_out,
        newbits1=newest,
        newbits2=(2 * second + newest).astype(np.uint8),
        valid_state=_valid_state_table(code, npos_pad),
        pattern_of_pos=pattern_of_pos,
        window=window,
        npos_pad=npos_pad,
        max_deviation=dev,
    )


def build_tables(code: ConvCode, max_deviation=None) -> TrellisTables:
    """Build (cached) trellis tables.

    max_deviation None = exact Viterbi (reference default: msg_len + mem + 1,
    cpp:238-240).
    """
    if max_deviation is None:
        max_deviation = code.config.msg_len + code.mem + 1
    return _build_cached(code, int(max_deviation))


def beam_schedule(tables: TrellisTables, nblk: int) -> np.ndarray:
    """Per-timestep beam start positions.

    Replicates ``max(0, int64((double)t / nblk * nstate_pos - dev))``
    (viterbi_convolutional_code.cpp:677-679) including double-precision
    truncation toward zero.
    """
    t = np.arange(nblk, dtype=np.float64)
    raw = t / float(nblk) * float(tables.nstate_pos) - float(tables.max_deviation)
    start = np.maximum(np.int64(0), raw.astype(np.int64))
    return np.minimum(start, tables.npos_pad - tables.window).astype(np.int32)
