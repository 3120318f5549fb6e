"""The port's basecaller trainer (``models/train.py``) against the JAX
package's on the CPU.

The same numpy inputs, and the JAX package's ``init_params`` weights
carried across by ``params_from_numpy``, go through both packages; the port
runs with ``device="cpu"``. Tolerances:

* the lattice scores and the loss are float32 sums of the same values in
  the same order, but PyTorch's and XLA's ``logaddexp`` and ``logsumexp``
  round differently in the last place: ``RTOL`` relative;
* gradients come back through five matmul-and-tanh recurrences summed in
  another order: each parameter's gradient within ``GRAD_TOL`` of its
  largest component (2e-5 measured at most);
* the schedule and Adam compute the same float32 formulas in the same
  order: ``OPT_RTOL``; near the schedule's end 1 + cos is small, so one
  unit in the last place of numpy's and XLA's float32 cos (6e-8) weighs
  more: the rate within ``COS_ULP`` of the peak rate, absolute;
* five training steps from the same weights over the same batches: losses
  within ``RTOL``, weights within ``STEP_ATOL`` absolute (1.3e-6 measured;
  a gradient component whose sign flips under rounding would move a weight
  by the whole rate, 3e-3).

Batches are bit-equal: both packages draw the same numpy values in the same
order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nanopore_dna_storage_tpu.models import flipflop as jax_ff
from nanopore_dna_storage_tpu.models import train as jax_train
from nanopore_dna_storage_tpu_torch.models import flipflop as port_ff
from nanopore_dna_storage_tpu_torch.models import train as port_train
from nanopore_dna_storage_tpu_torch.ops.synthetic import crf_state_path
from test_torch_basecall import configs, jax_params

torch.set_num_threads(1)

RTOL = 1e-5
GRAD_TOL = 1e-4
OPT_RTOL = 1e-6
COS_ULP = 1.2e-7
STEP_ATOL = 1e-5
# test_train.py's tiny model, with two and three layers
BF = dict(winlen=5, stride=2, conv_filters=12, hidden=12,
          layer_dirs=("b", "f"))
BFB = dict(BF, layer_dirs=("b", "f", "b"))


def batch_pair(seed, batch=3, seq_len=20, kmer=None):
    """The first batch of each package's ``synthetic_batches`` from one
    seed (signals cut to 12 samples a base)."""
    args = (batch, seq_len, seq_len * 12, seq_len + 2)
    want = next(jax_train.synthetic_batches(np.random.default_rng(seed),
                                            *args, kmer=kmer))
    got = next(port_train.synthetic_batches(np.random.default_rng(seed),
                                            *args, kmer=kmer, device="cpu"))
    return want, got


def lattice_case(seed, B=5, T=30, S=12):
    """Random transitions and padded state paths; nblk below T and equal to
    it, seqlen 1, S and in between, and states past seqlen left as
    padding."""
    rng = np.random.default_rng(seed)
    trans = rng.standard_normal((B, T, 40)).astype(np.float32) * 2
    seqlen = np.asarray([1, S, 7, 4, S], np.int32)[:B]
    nblk = np.asarray([T, 17, T, 3, 24], np.int32)[:B]
    states = np.zeros((B, S), np.int64)
    for i, n in enumerate(seqlen):
        bases = rng.integers(0, 4, n).astype(np.uint8)
        states[i, :n] = crf_state_path(bases)[:n]
    return trans, states, nblk, seqlen


def test_transition_score_tables_match():
    _, states, _, _ = lattice_case(0)
    got = port_train._transition_score_tables(torch.from_numpy(states))
    for g, w in zip(got, jax.vmap(jax_train._transition_score_tables)(
            jnp.asarray(states))):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequence_log_score_matches(seed):
    trans, states, nblk, seqlen = lattice_case(seed)
    want = np.asarray(jax.vmap(jax_train.sequence_log_score)(
        jnp.asarray(trans), jnp.asarray(states), jnp.asarray(nblk),
        jnp.asarray(seqlen)))
    got = port_train.sequence_log_score(
        torch.from_numpy(trans), torch.from_numpy(states),
        torch.from_numpy(nblk).long(), torch.from_numpy(seqlen).long())
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("widths", [BF, BFB], ids=["bf", "bfb"])
def test_crf_loss_and_gradients_match(widths):
    jcfg, pcfg = configs(widths)
    params = jax_params(widths, seed=0)
    want_b, got_b = batch_pair(4)
    loss, grads = jax.value_and_grad(jax_train.crf_loss)(
        params, jcfg, *want_b[:4])
    net = port_ff.params_from_numpy(params, pcfg, device="cpu")
    net.requires_grad_(True)
    got = port_train.crf_loss(net, *got_b[:4])
    got_grads = torch.autograd.grad(got, list(net.parameters()))
    assert float(loss) > 0
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=RTOL)
    for (name, _), g in zip(net.named_parameters(), got_grads):
        want = np.asarray(grads[name])
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("kmer", [None, 6])
def test_synthetic_batches_match(kmer):
    args = (3, 25, 300, 27)
    jgen = jax_train.synthetic_batches(np.random.default_rng(7), *args,
                                       kmer=kmer)
    pgen = port_train.synthetic_batches(np.random.default_rng(7), *args,
                                        kmer=kmer, device="cpu")
    for _ in range(2):
        want, got = next(jgen), next(pgen)
        for w, g in zip(want, got):
            g = g.numpy() if torch.is_tensor(g) else g
            assert g.shape == np.shape(w) and np.array_equal(g, w)
        assert got[0].dtype == torch.float32 and got[2].dtype == torch.int64


@pytest.mark.parametrize("lr,total,warmup", [(3e-3, 40, 200), (1e-2, 7, 3),
                                             (1e-3, 300, 10)])
def test_schedule_matches_optax(lr, total, warmup):
    """The rate at every count of the run and past its end, as
    ``make_trainer`` builds it in both packages."""
    steps = min(warmup, total // 10 + 1)
    want = optax.warmup_cosine_decay_schedule(0.0, lr, steps, total,
                                              lr * 1e-2)
    got = port_train.warmup_cosine_decay(0.0, lr, steps, total, lr * 1e-2)
    counts = range(total + 5)
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(want(jnp.int32(c))) for c in counts],
                               rtol=OPT_RTOL, atol=COS_ULP * lr)
    assert got(0) == 0.0  # the first update of a warm-up from 0


def test_schedule_refuses_what_optax_refuses():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 1, 1e-5)
    with pytest.raises(ValueError):
        port_train.warmup_cosine_decay(0.0, 1e-3, 1, 1, 1e-5)


@pytest.mark.parametrize("schedule", [False, True])
def test_adam_matches_optax(schedule):
    """Five identical gradients into optax's adam and the port's."""
    rng = np.random.default_rng(9)
    shapes = [(4, 6), (6,), (3, 2, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) *
              10.0 ** rng.integers(-4, 2) for s in shapes] for _ in range(5)]
    rate = (port_train.warmup_cosine_decay(0.0, 1e-2, 2, 6, 1e-4)
            if schedule else 1e-2)
    opt = optax.adam(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6, 1e-4)
                     if schedule else 1e-2)
    want = [jnp.asarray(p) for p in params]
    state = opt.init(want)
    got = [torch.from_numpy(p.copy()) for p in params]
    port = port_train.Adam(got, rate)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, want)
        want = optax.apply_updates(want, upd)
        port.step([torch.from_numpy(x) for x in g])
        for w, p in zip(want, got):
            np.testing.assert_allclose(p.numpy(), np.asarray(w),
                                       rtol=OPT_RTOL, atol=1e-9)
    assert port.count == 5
    if schedule:  # rate 0 at count 0: the first step moved nothing
        port0 = port_train.Adam([torch.from_numpy(params[0].copy())], rate)
        port0.step([torch.from_numpy(grads[0][0])])
        assert torch.equal(port0.params[0], torch.from_numpy(params[0]))


@pytest.mark.parametrize("total", [0, 20], ids=["constant", "schedule"])
def test_train_steps_match(total):
    """Five ``train_step``s from the JAX package's initial weights over the
    same batches."""
    jcfg, pcfg = configs(BF)
    jinit, jstep = jax_train.make_trainer(jcfg, 3e-3, total_steps=total)
    pinit, pstep = port_train.make_trainer(pcfg, 3e-3, total_steps=total,
                                           device="cpu")
    js = jinit(0)
    start = {k: np.asarray(v) for k, v in js.params.items()}
    ps = pinit(params=start)
    args = (3, 20, 240, 22)
    jgen = jax_train.synthetic_batches(np.random.default_rng(1), *args)
    pgen = port_train.synthetic_batches(np.random.default_rng(1), *args,
                                        device="cpu")
    for _ in range(5):
        js.params, js.opt_state, want = jstep(js.params, js.opt_state,
                                              *next(jgen)[:4])
        got = pstep(ps, *next(pgen)[:4])
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert ps.step == 5 and ps.opt.count == 5
    for name, p in ps.net.named_parameters():
        want = np.asarray(js.params[name])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
        assert not np.array_equal(want, start[name]), name


def _buffer_scan(xproj, sw, reverse):
    """The scan as it stood before the states were stacked: each state
    written into a preallocated buffer."""
    B, T, _ = xproj.shape
    h = sw.shape[0]
    out = xproj.new_empty((B, T, h))
    state = xproj.new_zeros((B, h))
    with port_ff.f32_matmul():
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            v = xproj[:, t]
            u = state @ sw
            zr = torch.sigmoid(v[:, :2 * h] + u[:, :2 * h])
            z, r = zr[:, :h], zr[:, h:]
            hbar = torch.tanh(r * u[:, 2 * h:] + v[:, 2 * h:])
            state = z * state + (1.0 - z) * hbar
            out[:, t] = state
    return out


@pytest.mark.parametrize("widths", [BFB, dict(winlen=7, stride=2,
                                                   conv_filters=16, hidden=32,
                                                   layer_dirs=("b", "f"))])
def test_forward_bit_equal_to_the_buffer_scan(widths):
    """``FlipflopNet.forward``, and the grad-enabled stages, give exactly
    what the buffer-writing scan gave."""
    _, pcfg = configs(widths)
    net = port_ff.params_from_numpy(jax_params(widths), pcfg, device="cpu")
    rng = np.random.default_rng(5)
    sig = torch.from_numpy(rng.standard_normal((3, 301)).astype(np.float32))
    ns = torch.tensor([301, 250, 97])
    x = net.features(sig)
    for i, d in enumerate(pcfg.layer_dirs):
        with port_ff.f32_matmul():
            xp = x @ getattr(net, f"gru{i}_iw") + getattr(net, f"gru{i}_b")
        x = _buffer_scan(xp, getattr(net, f"gru{i}_sw"), d == "b")
    want = net.head(x, ns)
    assert torch.equal(net(sig, ns), want)
    net.requires_grad_(True)
    assert torch.equal(net.head(net.states(sig), ns).detach(), want)


def test_load_npz_matches(tmp_path):
    widths = BF
    jcfg, pcfg = configs(widths)
    path = tmp_path / "w.npz"
    np.savez(path, **jax_params(widths))
    want = jax_ff.load_npz(str(path))
    net = port_ff.load_npz(str(path), device="cpu")
    assert net.cfg == pcfg
    for name, p in net.named_parameters():
        assert np.array_equal(p.numpy(), np.asarray(want[name])), name
    assert not any(p.requires_grad for p in net.parameters())
    sig = np.random.default_rng(2).standard_normal((2, 200)).astype(
        np.float32)
    np.testing.assert_allclose(
        net(torch.from_numpy(sig)).numpy(),
        np.asarray(jax_ff.flipflop_transitions(want, jcfg, jnp.asarray(sig))),
        rtol=RTOL, atol=RTOL)


def test_train_on_synthetic_runs_on_the_cpu():
    """A few steps of the port's own recipe: the first batch is
    ``synthetic_batches``'s, the losses finite, the weights moved."""
    _, pcfg = configs(BF)
    state, losses = port_train.train_on_synthetic(
        pcfg, steps=3, batch=2, seq_len=20, seed=3, learning_rate=1e-2,
        schedule=True, device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert state.step == 3 and state.net.device == torch.device("cpu")
    start = port_ff.init_params(pcfg, torch.Generator().manual_seed(3))
    init, step = port_train.make_trainer(pcfg, 1e-2, total_steps=3,
                                         device="cpu")
    fresh = init(params=start)
    batches = port_train.synthetic_batches(np.random.default_rng(3), 2, 20,
                                           240, 22, device="cpu")
    assert float(step(fresh, *next(batches)[:4])) == losses[0]
    # the warm-up starts at rate 0: the first step leaves the weights
    for name, p in fresh.net.named_parameters():
        assert torch.equal(p.detach(), start[name]), name
    assert float(step(fresh, *next(batches)[:4])) == losses[1]
    assert not torch.equal(fresh.net.ff_w.detach(), start["ff_w"])
    # the trainer copied the caller's tensors: they are as drawn
    again = port_ff.init_params(pcfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(start[k], again[k]) for k in start)


def test_trainer_defaults_to_the_card():
    """Without a device the trainer asks for the card, and without one it
    raises at once instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py trains on it")
    _, pcfg = configs(BF)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.make_trainer(pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.train_on_synthetic(pcfg, steps=1)
