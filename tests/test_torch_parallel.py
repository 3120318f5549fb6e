"""The port's sharded decode and on-device classification
(``nanopore_dna_storage_tpu_torch/parallel/mesh.py``) and its single-process
orientation pick (``PipelineDecoder.decode_posts_auto_orientation``)
against the JAX package's, on the CPU.

The same numpy inputs from one seed go through both packages, each with its
own config classes (``twin``). Bits, indices, CRC verdicts and lists are
integers, so every comparison is exact; scores are float32 sums in the same
order, also compared exactly. The JAX decoder's ``decode_posts`` is
memoised per (reads, orientations): both orientation picks and the sharded
check call it on the same reads, and its CPU decode is the slow part.
"""
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.coding.framing import \
    check_and_extract as jax_check_and_extract
from nanopore_dna_storage_tpu.config import ExperimentConfig
from nanopore_dna_storage_tpu.parallel.mesh import \
    crc_index_classify as jax_crc_index_classify
from nanopore_dna_storage_tpu.pipeline import decode as jax_decode
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.coding.framing import (check_and_extract,
                                                           frame_oligos)
from nanopore_dna_storage_tpu_torch.io.post import pack_posts
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder, unpack_msgs
from nanopore_dna_storage_tpu_torch.parallel import mesh
from nanopore_dna_storage_tpu_torch.pipeline import decode as port_decode
from nanopore_dna_storage_tpu_torch.pipeline import encode_bytes
from nanopore_dna_storage_tpu_torch.pipeline.simulate import simulate_posts
from test_torch_host import twin

torch.set_num_threads(1)

# test_torch_pipeline.py's m=6 r=1/2 config at 2 bytes per oligo
EXP = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5, conv_mem=6,
                       conv_rate=1)
PORT_EXP = twin(EXP, port_config)
DATA = bytes(range(8))
L, DEV = 2, 4
F = PORT_EXP.framing


def _memoised(decode_posts):
    cache = {}

    def call(posts, rc_flags, num_oligos):
        key = (tuple(map(id, posts)), tuple(map(bool, rc_flags)),
               num_oligos)
        if key not in cache:
            cache[key] = decode_posts(posts, rc_flags, num_oligos)
        return cache[key]

    return call


@pytest.fixture(scope="module")
def reads():
    """Four reads of ``DATA`` in both orientations, their packed batch, and
    one JAX and one port pipeline decoder."""
    enc = encode_bytes(DATA, PORT_EXP)
    posts, rcs, _ = simulate_posts(enc.oligos, 4, np.random.default_rng(1),
                                   sub_prob=0.01, del_prob=0.01,
                                   ins_prob=0.0)
    assert rcs.any() and (~rcs).any()
    batch, nblks = pack_posts(posts)
    jax_dec = jax_decode.PipelineDecoder(EXP, L, DEV)
    jax_dec.decode_posts = _memoised(jax_dec.decode_posts)
    return dict(
        posts=posts, batch=batch, nblks=nblks,
        num_oligos=enc.num_oligos_data + enc.num_oligos_rs, jax=jax_dec,
        port=port_decode.PipelineDecoder(PORT_EXP, L, DEV, device="cpu"))


def _random_bits(rng, shape, msg_len, pad):
    """Random candidate messages with some framed ones among them, so that
    both verdicts occur."""
    bits = rng.integers(0, 2, shape + (msg_len,), dtype=np.uint8)
    payloads = rng.integers(0, 256, (shape[0], 2), dtype=np.uint8)
    framed = frame_oligos(payloads, F, pad=pad)
    if framed.shape[-1] == msg_len:
        bits[:, 0] = framed
    return bits


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("msg_len", [36, 40])
@pytest.mark.parametrize("num_oligos", [6, 4096])
def test_crc_index_classify_matches_jax(pad, msg_len, num_oligos):
    rng = np.random.default_rng(msg_len + pad)
    msg_len += pad
    bits = _random_bits(rng, (9, 4), msg_len, pad)
    valid = rng.random((9, 4)) < 0.8
    ok, index = mesh.crc_index_classify(
        torch.from_numpy(bits), torch.from_numpy(valid), F.index_len,
        F.crc_len, F.prp_a_inv, F.prp_b, num_oligos, pad)
    ok_j, index_j = jax_crc_index_classify(
        bits, valid, F.index_len, F.crc_len, F.prp_a_inv, F.prp_b,
        num_oligos, pad)
    assert ok.dtype == torch.bool and ok.shape == (9, 4)
    assert np.array_equal(ok.numpy(), np.asarray(ok_j))
    assert np.array_equal(index.numpy(), np.asarray(index_j))
    if msg_len - pad == 36:
        assert ok.any() and not ok.all()


@pytest.mark.parametrize("pad", [False, True])
def test_crc_index_classify_matches_host_check(pad):
    exp = twin(ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                                conv_mem=6, conv_rate=1, pad=pad),
               port_config)
    enc = encode_bytes(bytes(range(40)), exp)
    total = enc.num_oligos_data + enc.num_oligos_rs
    truth = frame_oligos(enc.payloads, exp.framing, pad=pad)
    rng = np.random.default_rng(4)
    msgs = truth[rng.integers(0, total, (10, 3))]
    flip = (rng.random(msgs.shape) < 0.02).astype(np.uint8)
    msgs = msgs ^ flip
    ok, index = mesh.crc_index_classify(
        torch.from_numpy(msgs), torch.ones(10, 3, dtype=torch.bool),
        F.index_len, F.crc_len, F.prp_a_inv, F.prp_b, total - 2, pad)
    ok_h, index_h = check_and_extract(msgs, exp.framing, total - 2, pad=pad)
    assert np.array_equal(ok.numpy(), ok_h)
    assert np.array_equal(index.numpy(), index_h)
    assert ok_h.any() and not ok_h.all()


@pytest.mark.parametrize("rc", [False, True])
def test_unpack_bits_device_matches_unpack_msgs(rc):
    dec = LVADecoder(port_config.DecodeConfig(
        code=port_config.ConvCodeConfig(mem=6, rate=1, msg_len=PORT_EXP
                                        .msg_len(), rc=rc),
        list_size=L, max_deviation=DEV), device="cpu")
    rng = np.random.default_rng(rc)
    words = rng.integers(0, 2**32, (5, L, dec.spec.n_msg_words),
                         dtype=np.int64)
    got = mesh.unpack_bits_device(dec.spec, torch.from_numpy(words))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), unpack_msgs(dec.spec, words))


def test_decode_device_matches_decode(reads):
    dec = reads["port"].fwd
    batch, nblks = reads["batch"][:2], reads["nblks"][:2]
    sc, words, okend = dec.decode_device(batch, nblks)
    assert sc.dtype == torch.float32 and words.dtype == torch.int64
    assert sc.device.type == words.device.type == okend.device.type == "cpu"
    assert int(words.min()) >= 0 and int(words.max()) < 2**32
    msgs, scores, valid = dec.decode(batch, nblks)
    assert np.array_equal(unpack_msgs(dec.spec, words.numpy()), msgs)
    assert np.array_equal(mesh.unpack_bits_device(dec.spec, words).numpy(),
                          msgs)
    assert np.array_equal(sc.numpy(), scores)
    assert np.array_equal((sc > -np.inf).numpy() & okend.numpy(), valid)


def test_sharded_decoder_world1_matches_jax(reads):
    """tests/test_mesh.py's check without the 8-device mesh: the port's
    ShardedDecoder as one rank, against the JAX pipeline decode and the
    host CRC/index check."""
    total = reads["num_oligos"]
    n = len(reads["posts"])
    sharded = mesh.ShardedDecoder(PORT_EXP, L, rc=False, max_deviation=DEV,
                                  device="cpu")
    assert (sharded.world, sharded.rank) == (1, 0)
    res = sharded.decode(reads["batch"], reads["nblks"], total)
    out = reads["jax"].decode_posts(reads["posts"], [False] * n, total)
    ok_h, index_h = jax_check_and_extract(out.msgs, EXP.framing, total,
                                          pad=EXP.pad)
    ok_h &= out.valid
    assert np.array_equal(res.msgs, out.msgs)
    assert np.array_equal(res.ok, ok_h)
    assert np.array_equal(res.index, index_h)
    assert np.array_equal(res.scores > -np.inf, out.valid)
    assert np.array_equal(res.scores[:, 0], out.best_score)
    assert res.crc_pass_total == int(ok_h.any(axis=1).sum())
    assert 0 < res.crc_pass_total < n  # RC reads fail forward

    # decode_shard: the same on the device, no gather
    bits, sc, ok, index = sharded.decode_shard(reads["batch"][1:3],
                                               reads["nblks"][1:3], total)
    assert np.array_equal(bits.numpy(), res.msgs[1:3])
    assert np.array_equal(sc.numpy(), res.scores[1:3])
    assert np.array_equal(ok.numpy(), res.ok[1:3])
    assert np.array_equal(index.numpy(), res.index[1:3])


@pytest.mark.parametrize("gated", [True, False])
def test_decode_posts_auto_orientation_matches_jax(reads, gated):
    total = reads["num_oligos"]
    out_j, rc_j = reads["jax"].decode_posts_auto_orientation(
        reads["posts"], total, gated=gated)
    out_p, rc_p = reads["port"].decode_posts_auto_orientation(
        reads["posts"], total, gated=gated)
    assert np.array_equal(rc_p, rc_j)
    for a in ("msgs", "valid", "index", "payload", "chosen_msg",
              "best_score"):
        assert np.array_equal(getattr(out_p, a), getattr(out_j, a)), a
    assert rc_p.any() and (out_p.index >= 0).all()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.ShardedDecoder(PORT_EXP, L, rc=False)
