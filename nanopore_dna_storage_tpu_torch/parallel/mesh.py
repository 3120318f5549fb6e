"""Data-parallel decode over a ``torch.distributed`` process group, with the
CRC/index classification on the device.

Counterpart of ``nanopore_dna_storage_tpu/parallel/mesh.py``
(``crc_index_classify``, ``ShardedDecodeResult``, ``ShardedDecoder``,
``_unpack_bits_device``). The JAX package shards the batch axis over a
device mesh in one program; here each rank of a process group decodes its
contiguous shard of the batch on its own device and classifies it there,
the CRC-pass count reduces with one ``all_reduce`` (the ``psum``), and the
shards' results come back with ``all_gather``. Without an initialised
process group the decoder runs as world 1, rank 0, with no collective: the
counterpart of the one-chip mesh.

The classification takes the production (Pallas) path's masking
(mesh.py:130-137): an entry is valid where its score is above -inf and its
traceback reached the initial state (``okend``), and an invalid entry's
score is -inf.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..coding.crc import crc8_table
from ..config import ConvCodeConfig, DecodeConfig, ExperimentConfig
from ..ops.lva import LVADecoder
from ..ops.lva_consts import DecodeSpec

Shard = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def default_device() -> torch.device:
    """The card of this rank, ``cuda:{LOCAL_RANK % device count}``
    (``LOCAL_RANK`` as torchrun sets it, 0 without); raises without CUDA:
    nothing falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def distributed(group=None) -> Tuple[bool, int, int]:
    """(whether a process group is initialised, world size, rank); world 1,
    rank 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return True, dist.get_world_size(group), dist.get_rank(group)
    return False, 1, 0


def collective_device(device: torch.device, group=None) -> torch.device:
    """Where the group's collectives take their tensors: the rank's device
    under nccl; the host under gloo, whose ``all_gather`` may not take CUDA
    tensors."""
    if distributed(group)[0] and dist.get_backend(group) == "nccl":
        return device
    return torch.device("cpu")


def all_reduce_sum(value: torch.Tensor, device: torch.device,
                   group=None) -> int:
    """``value`` summed over the group's ranks with one ``all_reduce``, on
    ``collective_device``; ``value`` itself without a group."""
    if not distributed(group)[0]:
        return int(value)
    t = value.reshape(1).to(collective_device(device, group), torch.int64)
    dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
    return int(t)


def unpack_bits_device(spec: DecodeSpec, words: torch.Tensor) -> torch.Tensor:
    """int64 words [..., Mw] holding uint32 values -> uint8 bits
    [..., msg_len] on their device (``_unpack_bits_device``): bit i of the
    message is packed bit msg_len + mem - 1 - i, reversed under rc; equal
    to ``ops/lva.py`` ``unpack_msgs`` bit for bit."""
    code = spec.code
    msg_len = code.config.msg_len
    bitpos = msg_len + code.mem - 1 - torch.arange(msg_len,
                                                   device=words.device)
    if code.config.rc:
        bitpos = bitpos.flip(0)
    bits = (words[..., bitpos // 32] >> (bitpos % 32)) & 1
    return bits.to(torch.uint8)


def crc_index_classify(msgs: torch.Tensor, valid: torch.Tensor,
                       index_len: int, crc_len: int, prp_a_inv: int,
                       prp_b: int, num_oligos: int,
                       pad: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """CRC8 and PRP index check of candidate messages on their device
    (helper.py:371-388; the JAX package's ``crc_index_classify``).

    The bits (minus the pad bit) are left-padded with zeros to whole bytes;
    the CRC8 over every byte but the last must equal the last byte, and the
    descrambled index ``prp_a_inv * (scrambled - prp_b) mod 2^index_len``
    must lie below ``num_oligos``. ``crc_len`` is the reference's argument:
    the CRC is the last byte, as there.

    msgs: uint8 [B, L, msg_len], valid: bool [B, L] -> (ok bool [B, L],
    index int64 [B, L]).
    """
    dev = msgs.device
    table = torch.from_numpy(crc8_table().astype(np.int64)).to(dev)
    bits = msgs[..., :-1] if pad else msgs
    nbits = bits.shape[-1]
    total = -(-nbits // 8) * 8
    padded = torch.cat([bits.new_zeros(bits.shape[:-1] + (total - nbits,)),
                        bits], dim=-1)
    by = padded.reshape(padded.shape[:-1] + (total // 8, 8)).long()
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev)
    as_bytes = (by * weights).sum(-1)  # [B, L, nbytes]
    crc = torch.zeros(as_bytes.shape[:-1], dtype=torch.int64, device=dev)
    for i in range(as_bytes.shape[-1] - 1):
        crc = table[crc ^ as_bytes[..., i]]
    ok = crc == as_bytes[..., -1]
    iw = 2 ** torch.arange(index_len - 1, -1, -1, device=dev)
    scrambled = (bits[..., :index_len].long() * iw).sum(-1)
    # floor modulo, as Python's and jnp's %, on a negative scrambled - prp_b
    index = torch.remainder(prp_a_inv * (scrambled - prp_b), 1 << index_len)
    return ok & (index < num_oligos) & valid, index


@dataclasses.dataclass
class ShardedDecodeResult:
    msgs: np.ndarray  # [B, L, msg_len]
    scores: np.ndarray  # [B, L]
    ok: np.ndarray  # [B, L]
    index: np.ndarray  # [B, L]
    crc_pass_total: int  # reads with >= 1 passing candidate (all ranks)


class ShardedDecoder:
    """LVA decode and classification over the ranks of a process group, each
    on its own device (``cuda:{LOCAL_RANK}`` unless the caller passes
    ``device``), through ``LVADecoder.decode_device``: the K-way ACS kernel
    on a CUDA device, under max combining. ``path_combine`` goes to the
    decoder's ``DecodeConfig``."""

    def __init__(self, exp: ExperimentConfig, list_size: int, rc: bool,
                 max_deviation: Optional[int] = 20, *,
                 path_combine: str = "max", device=None, group=None):
        self.exp = exp
        self.group = group
        self.device = (torch.device(device) if device is not None
                       else default_device())
        _, self.world, self.rank = distributed(group)
        self.inner = LVADecoder(DecodeConfig(
            code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                                msg_len=exp.msg_len(), rc=rc),
            list_size=list_size, max_deviation=max_deviation,
            path_combine=path_combine), device=self.device)
        self.spec = self.inner.spec

    def classify(self, words: torch.Tensor, sc: torch.Tensor,
                 okend: torch.Tensor, num_oligos: int) -> Shard:
        """One ``decode_device`` result unpacked and classified on its
        device: (msgs uint8 [b, L, msg_len], scores f32 [b, L] with -inf at
        invalid entries, ok bool [b, L], index int64 [b, L])."""
        valid = (sc > float("-inf")) & okend
        scores = torch.where(valid, sc, float("-inf"))
        bits = unpack_bits_device(self.spec, words)
        f = self.exp.framing
        ok, index = crc_index_classify(bits, valid, f.index_len, f.crc_len,
                                       f.prp_a_inv, f.prp_b, num_oligos,
                                       self.exp.pad)
        return bits, scores, ok, index

    def decode_shard(self, posts: np.ndarray, nblks: np.ndarray,
                     num_oligos: int) -> Shard:
        """Decode and classify this rank's own reads; no collective. Returns
        ``classify``'s tensors on the rank's device."""
        sc, words, okend = self.inner.decode_device(posts, nblks)
        return self.classify(words, sc, okend, num_oligos)

    def decode(self, posts: np.ndarray, nblks: np.ndarray,
               num_oligos: int) -> ShardedDecodeResult:
        """Decode a global batch [B, T, 5, 8]: B padded to a multiple of the
        world size by repeating the last read, each rank its contiguous
        shard; every rank returns the whole batch's result. Every rank of
        the group must call it with the same batch: it runs one
        ``all_reduce`` and four ``all_gather``s."""
        posts = np.asarray(posts, np.float32)
        nblks = np.asarray(nblks, np.int64)
        B = posts.shape[0]
        if B == 0:
            raise ValueError("an empty batch")
        if B % self.world:
            padb = self.world - B % self.world
            posts = np.concatenate([posts, np.repeat(posts[-1:], padb, 0)])
            nblks = np.concatenate([nblks, np.repeat(nblks[-1:], padb)])
        b = posts.shape[0] // self.world
        lo = self.rank * b
        shard = self.decode_shard(posts[lo:lo + b], nblks[lo:lo + b],
                                  num_oligos)
        crc = all_reduce_sum(shard[2].any(1).sum(), self.device, self.group)
        if distributed(self.group)[0]:
            shard = tuple(self._gather(t) for t in shard)
        bits, sc, ok, index = (t.cpu().numpy() for t in shard)
        crc_from_pad = int(ok[B:].any(axis=1).sum())
        return ShardedDecodeResult(
            msgs=bits[:B], scores=sc[:B], ok=ok[:B], index=index[:B],
            crc_pass_total=crc - crc_from_pad)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's shard of a fixed-shape output, in rank order."""
        send = t.to(collective_device(self.device, self.group))
        if send.dtype == torch.bool:
            send = send.to(torch.uint8)
        parts = [torch.empty_like(send) for _ in range(self.world)]
        dist.all_gather(parts, send.contiguous(), group=self.group)
        return torch.cat(parts).to(t.dtype)
