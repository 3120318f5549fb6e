"""The port's basecaller chain against the JAX package on the CPU: the
flip-flop network (``models/flipflop.py``), the forward-backward
posteriors (``ops/fwdbwd.py``) and the Viterbi basecall
(``ops/crf_decode.py``); ``test_torch_basecall_pipeline.py`` holds
``Basecaller`` and the signal-fidelity simulation on them.

The same numpy inputs and the JAX package's ``init_params`` weights
(carried into the port by ``params_from_numpy``) go through both packages;
the port runs with ``device="cpu"``. Tolerances: float32 values that pass
through products, exp and log are summed in another order by PyTorch than
by XLA, so transitions and posteriors agree to ``RTOL`` relative and
``ATOL`` absolute (the values are O(1) to O(10); PyTorch and XLA differ by a
few units in the last place per step, about 2e-6 at most over 500 steps).
Viterbi paths are integers, equal when both are fed the same posteriors;
their scores are sums of the same float32 values in the same order, within
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.models import flipflop as jax_ff
from nanopore_dna_storage_tpu.ops import crf_decode as jax_crf
from nanopore_dna_storage_tpu.ops import fwdbwd as jax_fwdbwd
from nanopore_dna_storage_tpu_torch.models import flipflop as port_ff
from nanopore_dna_storage_tpu_torch.ops import crf_decode as port_crf
from nanopore_dna_storage_tpu_torch.ops import fwdbwd as port_fwdbwd

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
# most cases: a small model; one case at the published widths
SMALL = dict(winlen=7, stride=2, conv_filters=16, hidden=32,
             layer_dirs=("b", "f"))
FULL = {}


def configs(widths):
    return jax_ff.FlipflopConfig(**widths), port_ff.FlipflopConfig(**widths)


def jax_params(widths, seed=3):
    cfg, _ = configs(widths)
    return {k: np.asarray(v) for k, v in jax_ff.init_params(cfg, seed).items()}


def tensor(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T,winlen", [(1000, 7), (1001, 7), (517, 19),
                                      (1024, 19), (12, 19)])
def test_conv_same_stride_matches(T, winlen):
    rng = np.random.default_rng(T + winlen)
    x = rng.standard_normal((2, T, 1)).astype(np.float32)
    w = rng.standard_normal((winlen, 1, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    plan = port_ff._flappie_conv_edge_plan(T, winlen, 2)
    assert plan == jax_ff._flappie_conv_edge_plan(T, winlen, 2)
    if (T, winlen) == (1000, 7):  # flappie's right-edge quirk
        assert plan[498] and plan[499] == []
    want = np.asarray(jax_ff.conv_same_stride(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b), 2))
    got = port_ff.conv_same_stride(tensor(x), tensor(w), tensor(b), 2)
    assert got.shape == want.shape == (2, -(-T // 2), 24)
    close(got.numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
def test_grumod_scan_matches(reverse):
    rng = np.random.default_rng(11 + reverse)
    h = 32
    xproj = rng.standard_normal((3, 90, 3 * h)).astype(np.float32)
    sw = (rng.standard_normal((h, 3 * h)) * 0.5 / np.sqrt(h)).astype(
        np.float32)
    want = np.stack([np.asarray(jax_ff.grumod_scan(jnp.asarray(x),
                                                   jnp.asarray(sw), reverse))
                     for x in xproj])
    got = port_ff.grumod_scan(tensor(xproj), tensor(sw), reverse)
    close(got.numpy(), want)


def test_crf_log_partition_matches():
    rng = np.random.default_rng(12)
    trans = (rng.standard_normal((4, 70, 40)) * 3).astype(np.float32)
    nblk = np.array([70, 1, 33, 69])
    want = [float(jax_ff.crf_log_partition(jnp.asarray(t), n))
            for t, n in zip(trans, nblk)]
    got = port_ff.crf_log_partition(tensor(trans), tensor(nblk))
    close(got.numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("widths,T,nsamples", [
    (SMALL, 1000, [1000, 963, 501]),
    (FULL, 400, [400, 331])], ids=["small", "full"])
def test_flipflop_transitions_match(widths, T, nsamples):
    """A padded batch of reads of unequal length: the conv's edge plan from
    the padded T, backward layers from the padded end, each read's own
    partition."""
    jcfg, pcfg = configs(widths)
    params = jax_params(widths)
    rng = np.random.default_rng(T)
    sig = rng.standard_normal((len(nsamples), T)).astype(np.float32)
    ns = np.asarray(nsamples, np.int32)
    for i, n in enumerate(ns):
        sig[i, n:] = 0.0
    want = np.asarray(jax_ff.flipflop_transitions(
        params, jcfg, jnp.asarray(sig), jnp.asarray(ns)))
    net = port_ff.params_from_numpy(params, pcfg, device="cpu")
    got = net(tensor(sig), tensor(ns, torch.int64))
    assert got.shape == want.shape == (len(ns), T // 2, 40)
    close(got.numpy(), want)
    # the functional form on the dict gives the same tensor
    again = port_ff.flipflop_transitions(params, pcfg, tensor(sig),
                                         tensor(ns, torch.int64))
    assert torch.equal(again, got)


@pytest.fixture(scope="module")
def jax_transitions():
    """Transitions [3, 160, 40] of the small model from JAX, with -inf
    entries: a whole flip row of some blocks, and both the stay and the
    move into one flop (so logaddexp(-inf, -inf) arises)."""
    jcfg, _ = configs(SMALL)
    rng = np.random.default_rng(13)
    sig = rng.standard_normal((3, 320)).astype(np.float32)
    ns = np.array([320, 250, 97], np.int32)
    trans = np.array(jax_ff.flipflop_transitions(
        jax_params(SMALL), jcfg, jnp.asarray(sig), jnp.asarray(ns)))
    t58 = trans.reshape(3, 160, 5, 8)
    t58[:, 10, 2, :] = -np.inf  # into flip G from every state
    t58[0, 20:23, 4, [1, 5]] = -np.inf  # stay in flop C and move into it
    return trans, -(-ns // 2)


def test_transition_posteriors_match(jax_transitions):
    trans, nblk = jax_transitions
    want = np.asarray(jax_fwdbwd.batched_transition_posteriors(
        jnp.asarray(trans), jnp.asarray(nblk)))
    got = port_fwdbwd.batched_transition_posteriors(
        tensor(trans), tensor(nblk, torch.int64)).numpy()
    assert got.shape == want.shape == (3, 160, 5, 8)
    for b, n in enumerate(nblk):
        g, w = got[b, :n], want[b, :n]
        assert not np.isnan(g).any() and not np.isnan(w).any()
        assert np.array_equal(np.isneginf(g), np.isneginf(w))
        assert np.isneginf(g[10, 2]).all()
        fin = np.isfinite(w)
        close(g[fin], w[fin])
    # one read alone, as the JAX package's per-read function takes it
    one = port_fwdbwd.transition_posteriors(tensor(trans[2]), int(nblk[2]))
    close(one.numpy()[: nblk[2]][np.isfinite(want[2, : nblk[2]])],
          want[2, : nblk[2]][np.isfinite(want[2, : nblk[2]])])


def test_minus_inf_gives_minus_inf():
    """logaddexp(-inf, -inf) and logsumexp over all -inf give -inf in the
    CRF steps, not NaN."""
    t = torch.full((1, 5, 8), float("-inf"))
    prev = torch.zeros(1, 8)
    for step in (port_ff._partition_step, port_fwdbwd._fwd_step,
                 port_fwdbwd._bwd_step):
        out = step(prev, t)
        assert torch.isneginf(out).all(), step.__name__


def test_viterbi_matches_on_the_same_posteriors(jax_transitions):
    trans, nblk = jax_transitions
    post = np.asarray(jax_fwdbwd.batched_transition_posteriors(
        jnp.asarray(trans), jnp.asarray(nblk)))
    wp, ws = jax_crf.viterbi_flipflop_batch(jnp.asarray(post),
                                            jnp.asarray(nblk))
    gp, gs = port_crf.viterbi_flipflop_batch(tensor(post),
                                             tensor(nblk, torch.int64))
    assert gp.dtype == torch.int32
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)
    for b, n in enumerate(nblk):
        assert port_crf.basecall_from_path(gp[b].numpy(), n)[0] == \
            jax_crf.basecall_from_path(np.asarray(wp[b]), n)[0]
    p1, s1 = port_crf.viterbi_flipflop(tensor(post[1]), int(nblk[1]))
    assert np.array_equal(p1.numpy(), np.asarray(wp[1]))
    assert float(s1) == float(gs[1])


def test_viterbi_ties_match():
    """Small integer scores tie everywhere: the first maximal flip source,
    stay over move on a flop tie, the first maximal final state."""
    rng = np.random.default_rng(14)
    post = rng.integers(-2, 1, (4, 60, 5, 8)).astype(np.float32)
    post[1, 5:9] = -np.inf  # no move at all: every candidate ties at -inf
    nblk = np.array([60, 60, 41, 2])
    wp, ws = jax_crf.viterbi_flipflop_batch(jnp.asarray(post),
                                            jnp.asarray(nblk))
    gp, gs = port_crf.viterbi_flipflop_batch(tensor(post),
                                             tensor(nblk, torch.int64))
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert np.array_equal(gs.numpy(), np.asarray(ws))


def test_init_params_and_carrying_across():
    _, cfg = configs(SMALL)
    a = port_ff.init_params(cfg, torch.Generator().manual_seed(5))
    b = port_ff.init_params(cfg, torch.Generator().manual_seed(5))
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        port_ff.param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: v.shape for k, v in jax_params(SMALL).items()}
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
               for k in a)
    # the widths from the shapes: flappie's b / f / b / f / b, stride 2
    net = port_ff.params_from_numpy(jax_params(FULL), device="cpu")
    assert net.cfg == port_ff.FlipflopConfig()
    assert port_ff.as_net(net, device="cpu") is net
    with pytest.raises(ValueError, match="shape"):
        port_ff.FlipflopNet(port_ff.FlipflopConfig(hidden=64),
                            jax_params(FULL), device="cpu")
    torch.set_float32_matmul_precision("high")
    try:
        with port_ff.f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
