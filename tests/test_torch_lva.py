"""Decoder-level parity of the port's ``LVADecoder`` (CPU, plain ACS step)
against the JAX decoder. The golden lists of the reference binary are held
in tests/test_torch_lva_golden.py.

Scores are single f32 adds in the reference's order and messages are
integers, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.config import ConvCodeConfig
from nanopore_dna_storage_tpu.config import DecodeConfig as JaxDecodeConfig
from nanopore_dna_storage_tpu.ops.lva import LVADecoder as JaxLVADecoder
from nanopore_dna_storage_tpu_torch.config import DecodeConfig
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from test_lva_traceback import CASES, _posts

torch.set_num_threads(1)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_decoder_matches_jax(case):
    rate, rc, L, dev = CASES[case]
    rng = np.random.default_rng(rate * 10 + rc)
    enc = ConvCodeConfig(mem=6, rate=rate, msg_len=30)
    msgs, packed, nblks = _posts(enc, 2, rng, rc=rc)
    code = ConvCodeConfig(mem=6, rate=rate, msg_len=30, rc=rc)
    # one case through the Pallas kernel (interpret mode), the rest through
    # the faster XLA decoder
    backend = "pallas_interpret" if case == 0 else "xla"
    mj, sj, vj = JaxLVADecoder(JaxDecodeConfig(
        code=code, list_size=L, max_deviation=dev,
        backend=backend)).decode(packed, nblks)
    mp, sp, vp = LVADecoder(DecodeConfig(code=code, list_size=L,
                                         max_deviation=dev)).decode(
        packed, nblks)
    assert np.array_equal(vj, vp)
    assert np.array_equal(sj, sp)
    assert np.array_equal(mj, mp)
    if not rc:
        assert (mp[:, 0] == msgs).all()


def test_batch_with_different_lengths():
    """Two reads whose block counts differ in parity decode in one batch
    exactly as each does alone: the final buffer is picked per read."""
    rng = np.random.default_rng(11)
    code = ConvCodeConfig(mem=6, rate=5, msg_len=30)
    _, packed, nblks = _posts(code, 2, rng)
    while nblks[0] % 2 == nblks[1] % 2:
        _, packed, nblks = _posts(code, 2, rng)
    dec = LVADecoder(DecodeConfig(code=code, list_size=4, max_deviation=6))
    mb, sb, vb = dec.decode(packed, nblks)
    assert dec.steps == nblks.max()
    for b in range(2):
        m1, s1, v1 = dec.decode(packed[b:b + 1], nblks[b:b + 1])
        assert np.array_equal(v1[0], vb[b])
        assert np.array_equal(s1[0], sb[b])
        assert np.array_equal(m1[0], mb[b])
        assert v1[0, 0]
