"""Flip-flop basecaller network in PyTorch.

Counterpart of ``nanopore_dna_storage_tpu/models/flipflop.py``, the rebuild
of flappie's guppy flip-flop architecture (flappie/src/networks.c:301-340):
a stride-2 convolution and tanh, five modified-GRU layers alternating
backward / forward / backward / forward / backward, then the globally
normalised CRF transition head (layers.c:1080-1101).

* The convolution is an unfold and one matmul; the columns where flappie's
  own edge bookkeeping differs from a symmetric zero pad are then
  overwritten from ``_flappie_conv_edge_plan``, built from the padded
  length of the batch, as the JAX package builds it.
* Each GRU layer's input projection is one matmul over (reads x time); only
  the ``[B, h] @ [h, 3h]`` recurrence runs in the loop over time. The gate
  math is grumod_step's (layers.c:648-699): z first, r second, and r
  multiplies only the recurrent part of the candidate. A backward layer
  starts at the padded end, so the padding's zeros drive the state that
  enters each read's valid blocks, as ``lax.scan(reverse=True)`` does.
* The head subtracts each read's log partition over its own valid blocks,
  divided by their count (crf_manystay_partition_function,
  layers.c:1030-1076).

Every product runs in true float32 (``f32_matmul``): the card's TF32 would
keep about three decimal digits, and a caller's setting must not change
the posteriors. ``init_params`` draws from an explicit ``torch.Generator``,
so its numbers differ from ``jax.random``'s; ``params_from_numpy`` carries
the JAX package's parameters (its ``init_params``, ``load_npz``, and the
``models/weights.py`` and ``models/import_taiyaki.py`` parsers: the same key
names and ``x @ W`` layouts) into a ``FlipflopNet``, and ``load_npz`` reads
such a dict from an ``.npz`` file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

NBASE = 4
NSTATE = 8
NPARAM = NSTATE * (NBASE + 1)  # 40 transition weights per block


@dataclasses.dataclass(frozen=True)
class FlipflopConfig:
    winlen: int = 19
    stride: int = 2
    conv_filters: int = 256
    hidden: int = 256
    temperature: float = 1.0
    layer_dirs: tuple = ("b", "f", "b", "f", "b")  # networks.c:301-340


@contextlib.contextmanager
def f32_matmul():
    """Float32 products in full float32 inside the block (no TF32 on the
    card), whatever the caller set; the caller's setting comes back after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def param_shapes(cfg: FlipflopConfig) -> Dict[str, tuple]:
    """The parameters' names and shapes, in the JAX package's layouts."""
    h, nf = cfg.hidden, cfg.conv_filters
    shapes = {"conv_w": (cfg.winlen, 1, nf), "conv_b": (nf,),
              "ff_w": (h, NPARAM), "ff_b": (NPARAM,)}
    insize = nf
    for i in range(len(cfg.layer_dirs)):
        shapes[f"gru{i}_iw"] = (insize, 3 * h)
        shapes[f"gru{i}_b"] = (3 * h,)
        shapes[f"gru{i}_sw"] = (h, 3 * h)
        insize = h
    return shapes


def init_params(cfg: FlipflopConfig,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """Random float32 weights of the production shapes on the CPU, drawn
    from ``generator`` with the JAX package's scales (``init_params``)."""
    fixed = {"conv_w": 0.3, "conv_b": 0.1, "ff_w": 0.2, "ff_b": 0.05}

    def scale(name, shape):
        if name in fixed:
            return fixed[name]
        # GRU input and recurrent weights by their fan-in; biases 0.05
        return 0.05 if name.endswith("_b") else 0.5 / math.sqrt(shape[0])

    return {name: torch.randn(shape, generator=generator) * scale(name, shape)
            for name, shape in param_shapes(cfg).items()}


def _flappie_conv_edge_plan(T: int, winlen: int, stride: int):
    """Columns where flappie's convolution differs from symmetric zero-pad.

    flappie's blocked right-edge bookkeeping (layers.c:235-256) can assign
    the final partial window to the wrong output column and leave the true
    last column bias-only (e.g. T=1000, winlen=7, stride=2: col 498 receives
    col 499's 5-tap window; col 499 = bias). Bit-parity with the reference
    basecaller requires reproducing this, so we simulate the reference's
    loop bookkeeping (left edge :202-209, blocked main :219-233, right edge
    :235-256) for the edge columns and return {col: [(tap, x_index), ...]}
    for every column whose coverage differs from the symmetric-pad conv.
    """
    padL = (winlen - 1) // 2
    padR = winlen // 2
    ncolC = -(-T // stride)
    nstepC = -(-winlen // stride)
    nstepX = stride * nstepC
    ncolsL = -(-padL // stride)
    shiftX_L = ncolsL * stride - padL
    cover = {}
    for w in range(0, padL, stride):  # left edge
        off = padL - w
        cover.setdefault(w // stride, []).extend(
            (k, k - off) for k in range(off, winlen))
    for w in range(0, winlen, stride):  # blocked main loop
        ncol_proc = (T - shiftX_L - w) // nstepX
        for j in range(ncol_proc):
            oc = ncolsL + w // stride + j * nstepC
            xoff = shiftX_L + w + j * nstepX
            if oc < ncolC:
                cover.setdefault(oc, []).extend(
                    (k, xoff + k) for k in range(winlen))
    maxCol = (T - shiftX_L) // nstepX
    rem = (T - shiftX_L) % nstepX
    offsetC_R = ncolsL + nstepC * (maxCol - 1) + rem // stride + 1
    offsetX_R = T - winlen + 1
    startR = stride - (padL + T - winlen) % stride - 1
    for w in range(startR, padR, stride):  # right edge
        oc = offsetC_R + w // stride
        if oc < ncolC:
            cover.setdefault(oc, []).extend(
                (k, offsetX_R + w + k) for k in range(winlen - (w + 1)))
    plan = {}
    for oc in range(ncolC):
        want = sorted((k, oc * stride + k - padL) for k in range(winlen)
                      if 0 <= oc * stride + k - padL < T)
        got = sorted(cover.get(oc, []))
        if got != want:
            plan[oc] = got
    return plan


def conv_same_stride(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """flappie's convolution (layers.c:173-260). x: [B, T, insize]; w:
    [winlen, insize, nf]; out [B, ceil(T / stride), nf]. Output column c
    covers input positions from c * stride - padL, zero padding with padL =
    (winlen - 1) // 2, except the columns of flappie's edge quirks, taken
    from ``_flappie_conv_edge_plan`` at this T (the batch's padded length).
    """
    B, T, insize = x.shape
    winlen, _, nf = w.shape
    pad_l, pad_r = (winlen - 1) // 2, winlen // 2
    xp = nn.functional.pad(x, (0, 0, pad_l, pad_r))
    ncol = -(-T // stride)
    # [B, ncol, insize, winlen] windows -> [B, ncol, winlen * insize]
    win = xp.unfold(1, winlen, stride)[:, :ncol]
    win = win.transpose(2, 3).reshape(B, ncol, winlen * insize)
    with f32_matmul():
        out = win @ w.reshape(winlen * insize, nf)
        for oc, pairs in _flappie_conv_edge_plan(T, winlen, stride).items():
            if not pairs:
                out[:, oc] = 0.0
                continue
            taps = torch.tensor([k for k, _ in pairs], device=x.device)
            # below one window's length the plan reaches outside [0, T):
            # such an index is taken as the JAX package takes it, negative
            # from the end, past either end clamped
            rows = torch.tensor([i + T if i < 0 else i for _, i in pairs],
                                device=x.device).clamp(0, T - 1)
            out[:, oc] = (x[:, rows].reshape(B, -1)
                          @ w[taps].reshape(-1, nf))
    return out + b


def grumod_scan(xproj: torch.Tensor, sw: torch.Tensor,
                reverse: bool) -> torch.Tensor:
    """The modified GRU over time, batched. xproj: [B, T, 3h] (= x @ iW + b);
    returns the states [B, T, h]. The state starts at zero at t = 0, or at
    t = T - 1 when ``reverse``."""
    B, T, _ = xproj.shape
    h = sw.shape[0]
    state = xproj.new_zeros((B, h))
    # the states are stacked once at the end: writing each into a buffer
    # would give autograd T copies of the whole [B, T, h] gradient
    states = []
    # unbind: one backward node stacks the T steps' input gradients
    vs = xproj.unbind(1)
    with f32_matmul():
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            v = vs[t]
            u = state @ sw  # [B, 3h]
            zr = torch.sigmoid(v[:, :2 * h] + u[:, :2 * h])
            z, r = zr[:, :h], zr[:, h:]
            hbar = torch.tanh(r * u[:, 2 * h:] + v[:, 2 * h:])
            state = z * state + (1.0 - z) * hbar
            states.append(state)
    if reverse:
        states.reverse()
    return torch.stack(states, dim=1)


def _partition_step(prev: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """One forward step of the flip-flop CRF in log space. t: [B, 5, 8]
    block transitions (rows: into flip A..T from each state, then into the
    from-state's flop); prev, out: [B, 8] state log-mass."""
    flip = torch.logsumexp(t[:, :NBASE] + prev[:, None, :], dim=2)
    stay = prev[:, NBASE:] + t[:, NBASE, NBASE:]
    move = prev[:, :NBASE] + t[:, NBASE, :NBASE]
    return torch.cat([flip, torch.logaddexp(stay, move)], dim=1)


def active_blocks(nblk: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T] bool: block t of read b is one of its nblk[b] valid blocks."""
    return torch.arange(T, device=nblk.device)[None, :] < nblk[:, None]


def crf_log_partition(trans: torch.Tensor, nblk: torch.Tensor
                      ) -> torch.Tensor:
    """Log partition of the CRF over each read's first nblk blocks. trans:
    [B, T, 40]; nblk [B]; returns [B]. Blocks past nblk leave the state as
    it was."""
    B, T, _ = trans.shape
    t58 = trans.reshape(B, T, NBASE + 1, NSTATE)
    act = active_blocks(nblk, T)[..., None]
    prev = trans.new_zeros((B, NSTATE))
    for blk, a in zip(t58.unbind(1), act.unbind(1)):
        prev = torch.where(a, _partition_step(prev, blk), prev)
    return torch.logsumexp(prev, dim=1)


class FlipflopNet(nn.Module):
    """The network as a module: ``forward(signal, nsamples)`` gives the
    transition weights [B, T', 40] of ``flipflop_transitions``. Its
    parameters keep the JAX package's names and layouts (``conv_w``
    [winlen, 1, nf], ``gru{i}_iw`` [in, 3h], ``gru{i}_sw`` [h, 3h], ...);
    ``features``, ``layer`` and ``head`` are its stages, for a caller that
    times them. ``forward`` records no gradient; the stages (and
    ``states``, ``scores``) do wherever grad is enabled and the parameters
    require it, which ``models/train.py`` turns on for its own net."""

    def __init__(self, cfg: FlipflopConfig,
                 params: Mapping[str, object], device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, shape in param_shapes(cfg).items():
            value = params[name]
            if not torch.is_tensor(value):
                value = torch.from_numpy(np.array(value, np.float32))
            if tuple(value.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(value.shape)}, "
                                 f"the config needs {shape}")
            self.register_parameter(name, nn.Parameter(
                value.detach().to(device=device, dtype=torch.float32)
                .contiguous(), requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.conv_w.device

    def features(self, signal: torch.Tensor) -> torch.Tensor:
        """signal [B, T] -> tanh of the convolution [B, T', nf]."""
        return torch.tanh(conv_same_stride(signal[..., None], self.conv_w,
                                           self.conv_b, self.cfg.stride))

    def layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """GRU layer i on x [B, T', in] -> [B, T', h]."""
        with f32_matmul():
            xp = x @ getattr(self, f"gru{i}_iw") + getattr(self, f"gru{i}_b")
        return grumod_scan(xp, getattr(self, f"gru{i}_sw"),
                           reverse=self.cfg.layer_dirs[i] == "b")

    def scores(self, x: torch.Tensor) -> torch.Tensor:
        """The CRF head's unnormalised block transitions on the last layer's
        states: tanh, times 5 / temperature (shift_scale_matrix_inplace
        divides by temperature / 5, layers.c:1084)."""
        with f32_matmul():
            raw = torch.tanh(x @ self.ff_w + self.ff_b)
        return raw * (5.0 / self.cfg.temperature)

    def head(self, x: torch.Tensor, nsamples: torch.Tensor) -> torch.Tensor:
        """``scores`` minus each read's log partition over its own blocks
        divided by their count."""
        scaled = self.scores(x)
        nblk = -(-nsamples // self.cfg.stride)
        logz = crf_log_partition(scaled, nblk) / nblk.to(scaled.dtype)
        return scaled - logz[:, None, None]

    def states(self, signal: torch.Tensor) -> torch.Tensor:
        """signal [B, T] -> the last GRU layer's states [B, T', h]."""
        x = self.features(signal)
        for i in range(len(self.cfg.layer_dirs)):
            x = self.layer(i, x)
        return x

    @torch.no_grad()
    def forward(self, signal: torch.Tensor,
                nsamples: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T = signal.shape
        if nsamples is None:
            nsamples = torch.full((B,), T, dtype=torch.int64,
                                  device=signal.device)
        return self.head(self.states(signal), nsamples.to(torch.int64))


def flipflop_transitions(params, cfg: FlipflopConfig, signal: torch.Tensor,
                         nsamples: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """signal [B, T] (medmad-normalised) -> transition weights [B, T', 40],
    on ``signal``'s device. ``params``: a ``FlipflopNet`` or a dict of the
    JAX package's parameters (``as_net``). nsamples: each read's valid
    sample count; the CRF partition covers each read's own valid blocks."""
    return as_net(params, cfg, signal.device)(signal, nsamples)


def as_net(params, cfg: Optional[FlipflopConfig] = None,
           device="cuda") -> FlipflopNet:
    """``params`` as a ``FlipflopNet`` on ``device``: a net that lies there
    as it is, a net elsewhere copied there, or a dict of the JAX package's
    parameters (numpy arrays or tensors) under ``cfg`` (see
    ``params_from_numpy``)."""
    if isinstance(params, FlipflopNet):
        want = torch.device(device)
        if params.device.type == want.type and want.index in (
                None, params.device.index):
            return params
        cfg, params = params.cfg, dict(params.named_parameters())
    return params_from_numpy(params, cfg, device=device)


def load_npz(path: str, cfg: Optional[FlipflopConfig] = None,
             device="cuda") -> FlipflopNet:
    """Converted weights saved as an ``.npz`` of the JAX package's parameter
    names (its ``load_npz``) as a ``FlipflopNet`` on ``device``."""
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files}, cfg,
                                 device=device)


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      cfg: Optional[FlipflopConfig] = None,
                      device="cuda") -> FlipflopNet:
    """The JAX package's parameter dict (numpy arrays of its ``init_params``,
    ``load_npz``, ``params_from_header`` or ``params_from_taiyaki_json``) as
    a ``FlipflopNet`` on ``device``. Without ``cfg`` the widths come from the
    shapes, with flappie's alternating directions starting backward and
    stride 2."""
    if cfg is None:
        winlen, _, nf = np.shape(arrays["conv_w"])
        nlayers = sum(1 for k in arrays if k.endswith("_sw"))
        cfg = FlipflopConfig(
            winlen=winlen, conv_filters=nf,
            hidden=np.shape(arrays["gru0_sw"])[0],
            layer_dirs=tuple("bf"[i % 2] for i in range(nlayers)))
    return FlipflopNet(cfg, arrays, device=device)
