"""The port's own copies of the JAX package's signal and weight modules
(``signal/normalize.py``, ``signal/squiggle.py``, ``models/weights.py``,
``models/import_taiyaki.py``), held bit for bit against their originals.

Both packages get the same numpy inputs, and the random draws come from two
numpy Generators made from one seed, so the tolerance is zero: outputs are
made by the same numpy and scipy calls in the same order.
"""
import numpy as np
import pytest

from nanopore_dna_storage_tpu.models import flipflop as jax_ff
from nanopore_dna_storage_tpu.models import import_taiyaki as jax_taiyaki
from nanopore_dna_storage_tpu.models import weights as jax_weights
from nanopore_dna_storage_tpu.signal import normalize as jax_normalize
from nanopore_dna_storage_tpu.signal import squiggle as jax_squiggle
from nanopore_dna_storage_tpu_torch.models import \
    import_taiyaki as port_taiyaki
from nanopore_dna_storage_tpu_torch.models import weights as port_weights
from nanopore_dna_storage_tpu_torch.signal import normalize as port_normalize
from nanopore_dna_storage_tpu_torch.signal import squiggle as port_squiggle
from test_torch_host import _same

# the JAX package's small test model, and the published widths with a
# narrow hidden size (the header round trip at full width is slow there)
SMALL = dict(winlen=5, stride=2, conv_filters=16, hidden=16)
WIDE = dict(winlen=19, stride=2, conv_filters=16, hidden=24,
            layer_dirs=("b", "f", "b", "f", "b"))


def raw_signal(seed: int, n: int) -> np.ndarray:
    """A raw read with low-variation stretches at both ends (stalls that
    the MAD segmentation trims) around a noisy middle."""
    rng = np.random.default_rng(seed)
    x = rng.normal(100.0, 8.0, n).astype(np.float32)
    x[: n // 7] = rng.normal(100.0, 0.5, n // 7)
    x[-(n // 9):] = rng.normal(90.0, 0.3, n // 9)
    return x


@pytest.mark.parametrize("seed,n", [(0, 2500), (1, 777), (2, 95), (3, 4096)])
def test_normalize_matches(seed, n):
    x = raw_signal(seed, n)
    for p in (0.0, 0.25, 0.5, 0.999, 1.0):
        assert port_normalize.quantile_linear(x, p) == \
            jax_normalize.quantile_linear(x, p)
    _same(port_normalize.medmad_normalize(x),
          jax_normalize.medmad_normalize(x))
    _same(port_normalize.medmad_normalize(np.full(40, 3.0, np.float32)),
          jax_normalize.medmad_normalize(np.full(40, 3.0, np.float32)))
    for chunk, perc in ((100, 0.0), (50, 0.3)):
        assert port_normalize.trim_raw_by_mad(x, chunk, perc) == \
            jax_normalize.trim_raw_by_mad(x, chunk, perc)
    assert port_normalize.trim_and_segment(x) == \
        jax_normalize.trim_and_segment(x)
    assert port_normalize.trim_and_segment(x, 10, 5, 64, 0.1) == \
        jax_normalize.trim_and_segment(x, 10, 5, 64, 0.1)


def test_pore_model_and_squiggle_match():
    _same(port_squiggle.pore_model(), jax_squiggle.pore_model())
    _same(port_squiggle.pore_model(0.5), jax_squiggle.pore_model(0.5))
    bases = np.random.default_rng(4).integers(0, 4, 120).astype(np.uint8)
    for kmer in range(1, 7):
        _same(port_squiggle.sequence_to_squiggle(bases, kmer),
              jax_squiggle.sequence_to_squiggle(bases, kmer))
    assert port_squiggle.PUBLISHED_PROFILE.__dict__ == \
        jax_squiggle.PUBLISHED_PROFILE.__dict__


PROFILES = {"clean": None, "published": "published",
            "bursty": dict(burst_rate=0.2, burst_len=3.0, drift=0.3,
                           drift_period=50.0)}


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("deepsim", [True, False])
def test_raw_signal_matches(profile, deepsim):
    spec = PROFILES[profile]

    def prof(mod):
        if spec is None:
            return None
        if spec == "published":
            return mod.PUBLISHED_PROFILE
        return mod.ChannelProfile(**spec)

    bases = np.random.default_rng(5).integers(0, 4, 90).astype(np.uint8)
    got_rng, want_rng = np.random.default_rng(6), np.random.default_rng(6)
    for kmer in (1, 6):
        _same(port_squiggle.simulate_raw_signal(
                  bases, got_rng, deepsim, kmer=kmer,
                  profile=prof(port_squiggle)),
              jax_squiggle.simulate_raw_signal(
                  bases, want_rng, deepsim, kmer=kmer,
                  profile=prof(jax_squiggle)))
    _same(port_squiggle.deepsim_dwells(300, got_rng, 0.2),
          jax_squiggle.deepsim_dwells(300, want_rng, 0.2))
    # both generators stand at the same place after the same draws
    assert got_rng.random() == want_rng.random()


@pytest.mark.parametrize("widths", [SMALL, WIDE], ids=["small", "wide"])
def test_weights_header_round_trip_matches(widths, tmp_path):
    cfg = jax_ff.FlipflopConfig(**widths)
    params = {k: np.asarray(v) for k, v in jax_ff.init_params(cfg, 7).items()}
    mine, theirs = tmp_path / "port.h", tmp_path / "jax.h"
    port_weights.write_model_header(str(mine), params, stride=cfg.stride)
    jax_weights.write_model_header(str(theirs), params, stride=cfg.stride)
    assert mine.read_bytes() == theirs.read_bytes()
    got, stride = port_weights.params_from_header(str(mine))
    want, want_stride = jax_weights.params_from_header(str(theirs))
    assert stride == want_stride == cfg.stride
    assert sorted(got) == sorted(want) == sorted(params)
    for k in params:
        _same(got[k], want[k], k)
        _same(got[k].reshape(params[k].shape), params[k], k)
    got_mats, got_consts = port_weights.parse_model_header(mine.read_text())
    want_mats, want_consts = jax_weights.parse_model_header(
        theirs.read_text())
    assert got_consts == want_consts and sorted(got_mats) == sorted(want_mats)
    for k in got_mats:
        _same(got_mats[k], want_mats[k], k)


@pytest.mark.parametrize("widths", [SMALL, WIDE], ids=["small", "wide"])
def test_taiyaki_json_round_trip_matches(widths, tmp_path):
    cfg = jax_ff.FlipflopConfig(**widths)
    params = {k: np.asarray(v) for k, v in jax_ff.init_params(cfg, 3).items()}
    mine, theirs = tmp_path / "port.jsn", tmp_path / "jax.jsn"
    port_taiyaki.write_taiyaki_json(str(mine), params, stride=2,
                                    layer_dirs=cfg.layer_dirs)
    jax_taiyaki.write_taiyaki_json(str(theirs), params, stride=2,
                                   layer_dirs=cfg.layer_dirs)
    assert mine.read_bytes() == theirs.read_bytes()
    got, stride, dirs = port_taiyaki.params_from_taiyaki_json(str(mine))
    want, want_stride, want_dirs = jax_taiyaki.params_from_taiyaki_json(
        str(theirs))
    assert (stride, dirs) == (want_stride, want_dirs) == (2, cfg.layer_dirs)
    for k in params:
        _same(got[k], want[k], k)
        _same(got[k], params[k], k)
