"""Batched list-Viterbi decoder over the joint (position x conv state x CRF
state) trellis (``decode_post_conv_parallel_LVA``,
viterbi_convolutional_code.cpp:589-858).

Counterpart of ``nanopore_dna_storage_tpu/ops/lva.py`` ``LVADecoder``
(``schedule``, ``decode``) and ``_unpack_msgs``, with the same
``decode(posts, nblks) -> (msgs, scores, valid)`` contract;
``decode_device`` leaves its result on the device, as the Pallas
decoder's ``decode_device`` does for the sharded decode. The decode
runs on ``device``, the card unless the caller passes ``device="cpu"``:
the ACS step is the CUDA kernel on a CUDA device and its plain PyTorch
version on the CPU, ``acs_block`` under max combining and
``acs_block_lse`` under logsumexp combining. Without a card the default
raises at once.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import DecodeConfig
from ..trellis import tables as tb
from . import lva_decode
from .lva_acs import acs_block, acs_block_lse
from .lva_consts import DecodeSpec, LVAConsts


def unpack_msgs(spec: DecodeSpec, words: np.ndarray) -> np.ndarray:
    """uint32 words [.., Mw] -> message bits [.., msg_len], MSB-first.

    Bit i of the message is packed bit (msg_len + mem - 1 - i)
    (cpp:828-836); under rc the message is also reversed (cpp:835).
    """
    code = spec.code
    msg_len = code.config.msg_len
    bitpos = msg_len + code.mem - 1 - np.arange(msg_len)
    bits = (words[..., bitpos // 32] >> (bitpos % 32)) & 1
    if code.config.rc:
        bits = bits[..., ::-1]
    return bits.astype(np.uint8)


class LVADecoder:
    """List-Viterbi decoder for one DecodeConfig on one torch device
    (``cuda`` by default; ``cpu`` runs the plain ACS step)."""

    def __init__(self, cfg: DecodeConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not "
                               "available")
        self.spec, self.tables = DecodeSpec.build(cfg)
        self.consts = LVAConsts.build(self.spec, self.tables)
        self.tabs = self.consts.to(self.device)
        self.steps = 0  # forward block steps run, one ACS call each

    def schedule(self, nblks: np.ndarray, T: int) -> np.ndarray:
        """Per-read beam starts [B, T] (host, float64 like the C++)."""
        out = np.zeros((len(nblks), T), dtype=np.int32)
        for b, n in enumerate(np.asarray(nblks)):
            s = tb.beam_schedule(self.tables, int(n))
            out[b, : int(n)] = s
            out[b, int(n):] = s[-1] if len(s) else 0
        return out

    def decode_device(self, posts: np.ndarray,
                      nblks: Optional[np.ndarray] = None,
                      acs: Optional[Callable] = None):
        """Decode a batch and leave the result on the decoder's device
        (``PallasDecoder.decode_device``): the forward block loop, the
        traceback and the ordering.

        Args:
          posts: [B, T, 5, 8] float32, zero-padded beyond each read's nblk.
          nblks: [B] block counts (default: all T).
          acs: the ACS step: by default ``acs_block_lse`` under logsumexp
            combining and ``acs_block`` otherwise; a caller that compares a
            kernel with its plain version (``lva_acs.acs_block_ref``,
            ``acs_block_lse_ref``) passes one. The K-way ``acs_block`` is
            refused under logsumexp combining: its buffers are unsorted.
        Returns:
          (scores f32 [B, L], words int64 [B, L, Mw] holding uint32 values,
          okend bool [B, L]), best score first; an entry is valid where its
          score is above -inf and ``okend`` holds.
        """
        if acs is None:
            acs = acs_block_lse if self.spec.combine_lse else acs_block
        elif acs is acs_block and self.spec.combine_lse:
            raise ValueError("the K-way ACS kernel needs sorted buffer rows, "
                             "which logsumexp combining does not keep")
        posts = np.asarray(posts, dtype=np.float32)
        B, T = posts.shape[:2]
        nblks = np.full(B, T, np.int64) if nblks is None else \
            np.asarray(nblks, np.int64)
        if (nblks < self.spec.code.nstate_pos + 1).any():
            raise ValueError("post matrix shorter than nstate_pos+1 blocks "
                             "(cpp:600-601)")
        if (nblks > T).any():
            raise ValueError("nblks exceeds the post matrix length")
        # blocks past every read's end are inactive for all: skip them
        T = int(nblks.max())
        starts = self.schedule(nblks, T)
        spec, P, W = self.spec, self.spec.npos_pad, self.spec.window
        if starts.min() < 0 or starts.max() + W >= P:
            raise ValueError("beam schedule leaves the padded trellis")
        tlo = np.zeros((B, P), np.int64)
        thi = np.zeros((B, P), np.int64)
        for b, n in enumerate(nblks):
            tlo[b], thi[b] = lva_decode.window_bounds(starts[b], int(n), P, W)

        dev = self.device
        posts_d = torch.from_numpy(posts[:, :T]).to(dev)
        starts_d = torch.from_numpy(starts).to(dev)
        nblks_d = torch.from_numpy(nblks).to(dev)
        sels, fin_sc = lva_decode.forward(spec, self.consts, self.tabs,
                                          posts_d, starts_d, nblks_d, acs)
        self.steps += T
        words, okend = lva_decode.traceback(
            spec, self.consts, self.tabs, sels, starts_d.long(), nblks_d,
            torch.from_numpy(tlo).to(dev), torch.from_numpy(thi).to(dev))
        del sels
        return lva_decode.order(fin_sc, words, okend, spec.list_size)

    def decode(self, posts: np.ndarray, nblks: Optional[np.ndarray] = None,
               acs: Optional[Callable] = None):
        """Decode a batch on the host's side: ``decode_device``, its result
        copied to the host and unpacked. Arguments as ``decode_device``.

        Returns:
          (msgs uint8 [B, L, msg_len], scores f32 [B, L], valid bool [B, L])
        """
        sc, words, okend = self.decode_device(posts, nblks, acs)
        sc = sc.cpu().numpy()
        valid = (sc > -np.inf) & okend.cpu().numpy()
        return unpack_msgs(self.spec, words.cpu().numpy()), sc, valid
