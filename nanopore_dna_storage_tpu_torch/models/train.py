"""Flip-flop CRF basecaller training in PyTorch.

Counterpart of ``nanopore_dna_storage_tpu/models/train.py``: train the
flip-flop network on (signal, sequence) pairs from the hermetic squiggle
simulator with the conditional-likelihood loss of a globally normalised
flip-flop CRF,

    loss = logZ(all paths) - logsumexp over alignments of the true sequence,

per read divided by its block count, then the mean over reads. The
constrained term is a forward pass over the (block, sequence position)
lattice: position j occupies the CRF state of the j-th base in the flip /
flop state path (``ops/synthetic.crf_state_path``) and moves by stay or
advance, CTC with the flip-flop transitions.

* Autograd runs through the network's stages (``FlipflopNet.features``,
  ``layer``, ``scores``): the GRU recurrences and both lattices are loops
  over time on the device, as the reference's ``lax.scan``s are, and the
  backward pass walks them in reverse. Forward and backward products run in
  true float32 (``f32_matmul``), whatever the caller set.
* ``sequence_log_score`` gathers every block's stay and move scores for all
  reads at once, then loops over blocks; the lattice's empty cells hold
  ``NEG`` = -1e30, not -inf, so that ``logaddexp`` and ``where`` keep finite
  gradients.
* The optimizer is optax's ``adam`` in its own order of operations
  (``Adam``), with optax's ``warmup_cosine_decay_schedule``
  (``warmup_cosine_decay``) read at the count before each step, so the first
  update of a warm-up from 0 is zero.

Initial weights come from ``init_params`` on a ``torch.Generator``, so
their numbers differ from ``jax.random``'s; a caller holds the two packages
together by passing the JAX package's parameters to ``make_trainer``'s
``init``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from . import flipflop as ff
from ..ops.synthetic import crf_state_path
from ..signal.normalize import medmad_normalize
from ..signal.squiggle import simulate_raw_signal

NBASE = ff.NBASE
NSTATE = ff.NSTATE
NEG = -1e30  # an empty lattice cell; finite, so gradients stay finite


def _transition_score_tables(seq_states: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position stay and move indices into the flat [40] block
    transitions, for CRF state paths [..., S]: row = the state entered (a
    flop enters row 4), column = the state left (the same state for a stay,
    the previous position's for a move)."""
    st = seq_states
    row = torch.where(st < NBASE, st, NBASE)
    prev = torch.cat([st[..., :1], st[..., :-1]], dim=-1)
    return row * NSTATE + st, row * NSTATE + prev


def sequence_log_score(trans: torch.Tensor, seq_states: torch.Tensor,
                       nblk: torch.Tensor, seqlen: torch.Tensor
                       ) -> torch.Tensor:
    """logsumexp over the alignments of each read's sequence to its blocks.

    trans: [B, T, 40] raw (unnormalised) block transitions; seq_states:
    [B, S] padded CRF state paths; nblk, seqlen: [B] valid blocks and true
    path lengths. The lattice starts inside position 0; blocks past nblk
    leave it as it was; the score is read at position seqlen - 1, clamped
    into [0, S). Returns [B].
    """
    B, T, _ = trans.shape
    S = seq_states.shape[1]
    stay_idx, move_idx = _transition_score_tables(seq_states)
    stay = trans.gather(2, stay_idx[:, None, :].expand(B, T, S))
    move = trans.gather(2, move_idx[:, None, :].expand(B, T, S))
    act = ff.active_blocks(nblk, T)[..., None]
    c = torch.full((B, S), NEG, dtype=trans.dtype, device=trans.device)
    c[:, 0] = 0.0
    # unbind: one backward node stacks the T blocks' gradients
    for s_t, m_t, a_t in zip(stay.unbind(1), move.unbind(1), act.unbind(1)):
        new = torch.logaddexp(c + s_t,
                              F.pad(c[:, :-1], (1, 0), value=NEG) + m_t)
        c = torch.where(a_t, new, c)
    end = (seqlen.to(torch.int64) - 1).clamp(0, S - 1)
    return c.gather(1, end[:, None])[:, 0]


def crf_loss(net: ff.FlipflopNet, signal: torch.Tensor,
             nsamples: torch.Tensor, seq_states: torch.Tensor,
             seqlens: torch.Tensor) -> torch.Tensor:
    """Mean per-block negative conditional log-likelihood over the batch:
    signal [B, T] (medmad-normalised, zero-padded), nsamples [B] valid
    samples, seq_states [B, S] padded CRF state paths, seqlens [B] their
    lengths. The convolution takes flappie's edge plan at the padded T, as
    inference does."""
    trans = net.scores(net.states(signal))
    nblk = -(-nsamples.to(torch.int64) // net.cfg.stride)
    logz = ff.crf_log_partition(trans, nblk)
    seq = sequence_log_score(trans, seq_states, nblk, seqlens)
    return torch.mean((logz - seq) / nblk.to(trans.dtype))


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from init_value to
    peak_value over warmup_steps, then a cosine to end_value at
    decay_steps (counted from 0, the warm-up included), end_value after.
    Computed in float32 in optax's order of operations."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")
    f32 = np.float32
    alpha = f32(0.0 if peak_value == 0.0 else end_value / peak_value)
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        k = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * k
                                             / f32(cos_steps)))
        return float(f32(peak_value) * ((f32(1) - alpha) * cosine + alpha))

    return schedule


class Adam:
    """optax's ``adam(learning_rate)`` (b1 0.9, b2 0.999, eps 1e-8) on a list
    of tensors, in optax's order of operations:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        p += -rate(count) * (mu / (1 - b1^(count+1)))
             / (sqrt(nu / (1 - b2^(count+1))) + eps)

    ``rate`` is a float or a schedule of the count of updates made before
    this one (optax's ``scale_by_schedule``)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.Tensor], learning_rate):
        self.params = params
        self.rate = learning_rate if callable(learning_rate) \
            else (lambda _: learning_rate)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update of every parameter from its gradient."""
        b1, b2 = self.B1, self.B2
        # float32 as optax computes them: the bias corrections and the rate
        bc1 = float(1 - np.float32(b1) ** np.float32(self.count + 1))
        bc2 = float(1 - np.float32(b2) ** np.float32(self.count + 1))
        rate = float(np.float32(-self.rate(self.count)))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            p.add_(rate * ((mu / bc1) / ((nu / bc2).sqrt() + self.EPS)))
        self.count += 1


@dataclasses.dataclass
class TrainState:
    """The net being trained, its optimizer (the moments and the count) and
    the steps taken."""

    net: ff.FlipflopNet
    opt: Adam
    step: int = 0


def make_trainer(cfg: ff.FlipflopConfig, learning_rate: float = 1e-3,
                 total_steps: int = 0, warmup: int = 200, device="cuda"):
    """(init, train_step) on ``device``, the card unless the caller passes
    ``"cpu"``. ``total_steps > 0`` enables a linear warm-up from 0 over
    min(warmup, total_steps // 10 + 1) steps then a cosine decay to
    learning_rate / 100 at total_steps (needed for the larger kmer=6
    models; constant Adam at 1e-2 plateaus them), else the rate is
    constant.

    ``init(seed=0, params=None)`` starts a ``TrainState`` from ``params`` (a
    parameter dict such as the JAX package's ``init_params``, or a net),
    else from ``init_params`` on a generator seeded with ``seed``.
    ``train_step(state, signal, nsamples, seq_states, seqlens)`` takes one
    step and returns the loss before it (a 0-d tensor on the device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    if total_steps:
        rate = warmup_cosine_decay(0.0, learning_rate,
                                   min(warmup, total_steps // 10 + 1),
                                   total_steps, learning_rate * 1e-2)
    else:
        rate = learning_rate

    def init(seed: int = 0, params: Optional[Mapping] = None) -> TrainState:
        if params is None:
            params = ff.init_params(cfg, torch.Generator().manual_seed(seed))
        elif isinstance(params, ff.FlipflopNet):
            params = dict(params.named_parameters())
        # copies: training must not write into the caller's tensors
        params = {k: v.detach().clone() if torch.is_tensor(v) else v
                  for k, v in params.items()}
        net = ff.FlipflopNet(cfg, params, device=dev).requires_grad_(True)
        return TrainState(net, Adam(list(net.parameters()), rate))

    def train_step(state: TrainState, signal, nsamples, seq_states,
                   seqlens) -> torch.Tensor:
        params = state.opt.params
        with ff.f32_matmul():
            loss = crf_loss(state.net, signal, nsamples, seq_states,
                            seqlens)
            grads = torch.autograd.grad(loss, params)
        state.opt.step(grads)
        state.step += 1
        return loss.detach()

    return init, train_step


def synthetic_batches(rng: np.random.Generator, batch: int, seq_len: int,
                      pad_T: int, pad_S: int, kmer: Optional[int] = None,
                      device="cuda") -> Iterator[Tuple]:
    """Endless (signal, nsamples, seq_states, seqlens, seqs) batches from the
    hermetic squiggle simulator, drawn from ``rng`` in the JAX package's
    order (one seed, the same batches): signal [batch, pad_T] float32 cut
    to pad_T, nsamples and seqlens [batch] int64, seq_states [batch, pad_S]
    int64 on ``device``; seqs [batch, seq_len] uint8 numpy. ``kmer``
    selects the pore model's context length (None = the module default,
    signal/squiggle.KMER)."""
    kw = {} if kmer is None else {"kmer": kmer}
    while True:
        sigs, states, seqs = [], [], []
        for _ in range(batch):
            seq = rng.integers(0, 4, seq_len).astype(np.uint8)
            raw = simulate_raw_signal(seq, rng, deepsim_dwell=False, **kw)
            sigs.append(medmad_normalize(raw)[:pad_T])
            states.append(crf_state_path(seq))
            seqs.append(seq)
        sig = np.zeros((batch, pad_T), np.float32)
        st = np.zeros((batch, pad_S), np.int64)
        for i, (s, sp) in enumerate(zip(sigs, states)):
            sig[i, : len(s)] = s
            st[i, : len(sp)] = sp

        def on(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        yield (torch.from_numpy(sig).to(device),
               on([len(s) for s in sigs]), on(st),
               on([len(sp) for sp in states]), np.asarray(seqs))


def train_on_synthetic(cfg: ff.FlipflopConfig, steps: int, batch: int = 8,
                       seq_len: int = 40, seed: int = 0,
                       learning_rate: float = 1e-3, schedule: bool = False,
                       kmer: Optional[int] = None, device="cuda"):
    """Train a model against the hermetic pore model on ``device``. Returns
    (state, losses), the losses as floats.

    Reads are ``seq_len`` bases, their signals cut to ``seq_len * 12``
    samples; ``kmer`` selects the pore model's context length (None =
    module default) and must match the kmer the trained model will
    basecall."""
    rng = np.random.default_rng(seed)
    pad_T = seq_len * 12
    init, train_step = make_trainer(cfg, learning_rate,
                                    total_steps=steps if schedule else 0,
                                    device=device)
    state = init(seed)
    gen = synthetic_batches(rng, batch, seq_len, pad_T, seq_len + 2,
                            kmer=kmer, device=device)
    losses = []
    for _ in range(steps):
        sig, ns, st, sl, _ = next(gen)
        losses.append(train_step(state, sig, ns, st, sl))
    return state, [float(x) for x in losses]
