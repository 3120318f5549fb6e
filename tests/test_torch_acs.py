"""Block-level parity of the port's ACS step against the Pallas kernel.

A mid-read decoder state is built by running the JAX ``acs_block``
(ops/lva_pallas.py, interpret mode) over the first blocks of a synthetic
read; that state is carried into the port with ``from_pallas_state`` and one
more block runs through both. The new buffers and the selections must be
bit-identical: every score is one f32 add in the same order, and hashes and
selections are integers, so the tolerance is zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.coding.conv import (conv_encode_bases,
                                                  make_conv_code)
from nanopore_dna_storage_tpu.config import ConvCodeConfig
from nanopore_dna_storage_tpu.config import DecodeConfig as JaxDecodeConfig
from nanopore_dna_storage_tpu.ops import lva_pallas
from nanopore_dna_storage_tpu.ops.lva import LVADecoder as JaxLVADecoder
from nanopore_dna_storage_tpu.ops.synthetic import synthetic_post
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.config import DecodeConfig
from nanopore_dna_storage_tpu_torch.ops import lva_acs
from nanopore_dna_storage_tpu_torch.ops.lva_consts import (
    DecodeSpec, LVAConsts, from_pallas_state, sel_format)
from test_torch_host import twin

torch.set_num_threads(1)


def _read(code_cfg, seed):
    rng = np.random.default_rng(seed)
    code = make_conv_code(dataclasses.replace(code_cfg, rc=False))
    msg = rng.integers(0, 2, (1, code_cfg.msg_len), dtype=np.uint8)
    bases = conv_encode_bases(code, msg)[0]
    if code_cfg.rc:
        bases = (3 - bases)[::-1]
    return synthetic_post(bases, rng, noise=0.9)


def _jax_states(code, cfg, post, t_stop):
    """Pallas decoder state (prev, stale) before block ``t_stop``, plus the
    decoder and the read's beam starts; ``code`` is the JAX package's config
    of ``cfg.code``."""
    jdec = JaxLVADecoder(JaxDecodeConfig(
        code=code, list_size=cfg.list_size,
        max_deviation=cfg.max_deviation, backend="pallas_interpret"))
    pd = jdec._pallas
    starts = jdec.schedule(np.array([post.shape[0]]), post.shape[0])[0]

    @jax.jit
    def step(prev, stale, postf, start1, active):
        return lva_pallas.acs_block(pd.spec, pd.consts, pd._cdev, prev,
                                    stale, postf, start1, active,
                                    interpret=True)

    b = lva_pallas._init_buffers(pd.spec, pd.consts)
    prev, stale = b[:3], b[3:]
    for t in range(t_stop):
        out = step(prev, stale, jnp.asarray(post[t].reshape(-1)),
                   jnp.int32(starts[t] + 1), jnp.bool_(True))
        prev, stale = out[:3], prev
    return pd, step, prev, stale, starts


CASES = [
    # (rate, rc, block, active, dev): r=1 is pattern 0 only, r=5 mixes
    # patterns; block 1 has padded row 1 (trellis position 0) in its window
    (1, False, 30, True, 8),
    (5, False, 25, True, 6),
    (5, False, 1, True, 6),
    (5, False, 12, False, 6),
    (5, True, 20, True, 6),
]


@pytest.mark.parametrize("rate,rc,block,active,dev", CASES)
def test_acs_block_matches_pallas(rate, rc, block, active, dev):
    L = 4
    code = ConvCodeConfig(mem=6, rate=rate, msg_len=30, rc=rc)
    cfg = DecodeConfig(code=twin(code, port_config), list_size=L,
                       max_deviation=dev)
    post = _read(code, seed=rate * 10 + rc)
    pd, step, prev, stale, starts = _jax_states(code, cfg, post, block)
    start1 = int(starts[block]) + 1
    if block == 1:
        assert start1 == 1  # the window covers trellis position 0

    spec, tabs_np = DecodeSpec.build(cfg)
    tabs = LVAConsts.build(spec, tabs_np).to("cpu")
    t_prev = [x[None] for x in from_pallas_state(
        pd.consts, [np.asarray(a) for a in prev])]
    t_stale = [x[None] for x in from_pallas_state(
        pd.consts, [np.asarray(a) for a in stale])]
    postf = torch.from_numpy(post[block].reshape(1, 40))
    sel = torch.empty((1, spec.window, 8 * L, spec.code.nstate_conv),
                      dtype=sel_format(L)[0])
    lva_acs.acs_block_ref(
        tabs, t_prev, t_stale, postf[:, tabs["stay_idx"]],
        postf[:, tabs["move_idx"]], torch.tensor([start1], dtype=torch.int32),
        torch.tensor([active]), sel)

    out = step(prev, stale, jnp.asarray(post[block].reshape(-1)),
               jnp.int32(start1), jnp.bool_(active))
    want = from_pallas_state(pd.consts, [np.asarray(a) for a in out[:3]])
    for got, ref in zip(t_stale, want):
        assert torch.equal(got[0], ref)
    want_sel = np.asarray(out[3])[..., pd.consts.perm]
    assert np.array_equal(sel[0].numpy(), want_sel)
    if active:
        assert (want_sel >= 0).any()
    else:
        assert (want_sel == -1).all()


def test_argmax_takes_first_of_tied_infinities():
    """The plain merge relies on torch.argmax returning the first maximal
    index, also when the maximum is an infinity several candidates share."""
    x = torch.tensor([[-np.inf, -np.inf, -np.inf],
                      [1.0, np.inf, np.inf],
                      [2.0, 0.5, 2.0]], dtype=torch.float32)
    assert x.argmax(dim=1).tolist() == [0, 1, 0]
