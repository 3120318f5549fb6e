"""The traffic generator and the frozen copies against the program's
originals, on the CPU."""
import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.frozen import channel, lva_consts, roofline, synthetic
from benchmark.frozen.config import ConvCodeConfig as FrozenCode
from benchmark.frozen.config import DecodeConfig as FrozenDecode
from conftest import tiny_config
from nanopore_dna_storage_tpu_torch.config import (ConvCodeConfig,
                                                   DecodeConfig,
                                                   ExperimentConfig,
                                                   FramingConfig)
from nanopore_dna_storage_tpu_torch.ops import lva_consts as port_consts
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from nanopore_dna_storage_tpu_torch.pipeline.encode import encode_bytes
from nanopore_dna_storage_tpu_torch.probes.merge_roofline import \
    acs_needed_bytes
from nanopore_dna_storage_tpu_torch.ops.synthetic import synthetic_post
from nanopore_dna_storage_tpu_torch.signal.channel import simulate_indelsubs

MIX = {"batch": 3, "pool_reads": 12, "rc_share": 0.5,
       "grouping": "orientation", "check_reads": 2, "reference_chunk": 2}


def test_pool_is_the_seeds():
    seed = 2**31 + 977
    a = traffic.make_pool(tiny_config(), MIX, seed)
    b = traffic.make_pool(tiny_config(), MIX, seed)
    c = traffic.make_pool(tiny_config(), MIX, seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a.posts, b.posts))
    assert np.array_equal(a.rc, b.rc) and np.array_equal(a.oligo, b.oligo)
    assert [list(x) for x in a.calls] == [list(x) for x in b.calls]
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a.posts, c.posts))
    assert a.rc.sum() == c.rc.sum() == 6


@pytest.mark.parametrize("grouping", ["orientation", "arrival"])
def test_calls_cover_the_pool(grouping):
    pool = traffic.make_pool(tiny_config(), dict(MIX, grouping=grouping), 5)
    idx = np.concatenate(pool.calls)
    assert sorted(idx) == list(range(12))
    assert all(len(c) == 3 for c in pool.calls)
    if grouping == "orientation":
        flags = [set(pool.rc[c]) for c in pool.calls]
        assert all(len(f) == 1 for f in flags)
        assert [f.pop() for f in flags] == [False, True] * 2
    else:
        assert [list(c) for c in pool.calls] == [[0, 1, 2], [3, 4, 5],
                                                 [6, 7, 8], [9, 10, 11]]


def test_encoder_equals_the_programs():
    cfg = tiny_config()
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 9, dtype=np.uint8).tobytes()
    bases, payloads = traffic.encode(data, traffic.experiment(cfg))
    exp = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5, conv_mem=6,
                           conv_rate=1, framing=FramingConfig())
    enc = encode_bytes(data, exp)
    assert np.array_equal(payloads, enc.payloads)
    assert ["".join("ACGT"[b] for b in row) for row in bases] == enc.oligos


def test_read_simulation_equals_the_programs():
    bases = np.random.default_rng(1).integers(0, 4, 60).astype(np.uint8)
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        na = channel.simulate_indelsubs(bases, a, 0.05, 0.05, 0.05)
        nb = simulate_indelsubs(bases, b, 0.05, 0.05, 0.05)
        assert np.array_equal(na, nb)
        assert np.array_equal(synthetic.synthetic_post(na, a, noise=1.3),
                              synthetic_post(nb, b, noise=1.3))


@pytest.mark.parametrize("mem,rate,L,rc", [(6, 1, 4, False), (6, 3, 16, True),
                                           (8, 1, 64, True),
                                           (11, 5, 8, False)])
def test_tables_equal_the_programs(mem, rate, L, rc):
    msg_len = {6: 36, 8: 100, 11: 180}[mem]
    spec, tabs = lva_consts.DecodeSpec.build(FrozenDecode(
        code=FrozenCode(mem=mem, rate=rate, msg_len=msg_len, rc=rc),
        list_size=L, max_deviation=20))
    pspec, ptabs = port_consts.DecodeSpec.build(DecodeConfig(
        code=ConvCodeConfig(mem=mem, rate=rate, msg_len=msg_len, rc=rc),
        list_size=L, max_deviation=20))
    mine = lva_consts.LVAConsts.build(spec, tabs)
    theirs = port_consts.LVAConsts.build(pspec, ptabs)
    assert (spec.window, spec.npos_pad, spec.n_msg_words) == \
        (pspec.window, pspec.npos_pad, pspec.n_msg_words)
    for field in ("cstar", "nbits", "valid", "pattern", "qmap", "stay_idx",
                  "move_idx", "init_state", "final_state"):
        assert np.array_equal(getattr(mine, field), getattr(theirs, field))


def test_needed_bytes_equal_the_programs():
    """The frozen ``acs_needed_bytes`` against the program's on every block
    step of an m=6 decode on the CPU."""
    cfg = ConvCodeConfig(mem=6, rate=1, msg_len=36)
    dec = LVADecoder(DecodeConfig(code=cfg, list_size=4, max_deviation=8),
                     device="cpu")
    from nanopore_dna_storage_tpu_torch.coding.conv import (
        conv_encode_bases, make_conv_code)
    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 2, (2, 36), dtype=np.uint8)
    posts = [synthetic_post(b, rng, noise=1.5)
             for b in conv_encode_bases(make_conv_code(cfg), msgs)]
    T = max(len(p) for p in posts)
    batch = np.zeros((2, T, 5, 8), np.float32)
    for i, p in enumerate(posts):
        batch[i, :len(p)] = p
    seen = []

    def step(tabs, prev, stale, *args):
        from nanopore_dna_storage_tpu_torch.ops.lva_acs import acs_block
        acs_block(tabs, prev, stale, *args)
        *rest, sel = args
        seen.append((acs_needed_bytes(tabs, prev[0], stale[0], sel, *rest),
                     roofline.acs_needed_bytes(tabs, prev[0], stale[0], sel,
                                               *rest)))
        return sel

    torch.manual_seed(0)
    dec.decode(batch, np.asarray([len(p) for p in posts]), acs=step)
    assert len(seen) == T and all(a == b for a, b in seen)
    assert roofline.HBM_BYTES_PER_S == 3.35e12
