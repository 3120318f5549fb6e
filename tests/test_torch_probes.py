"""Parity of the port's merge-family probes (``probes/merge_roofline.py``,
``probes/treepop.py``) with the TPU probe scripts they replace.

The scripts' Pallas kernel bodies (``scripts/tpu_vpu_roofline.py``,
``scripts/tpu_treepop_probe.py``, imported by file path) run in interpret
mode on the CPU, and the plain PyTorch versions run on the same numpy
inputs. The tolerance is zero, bit for bit on every output: the probes do
the same f32 adds in the same order, compares, selects and int32 adds,
and no products, so nothing may round differently.
"""
import importlib.util
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nanopore_dna_storage_tpu_torch.config import (ConvCodeConfig,
                                                   DecodeConfig)
from nanopore_dna_storage_tpu_torch.ops.lva_consts import DecodeSpec
from nanopore_dna_storage_tpu_torch.probes import merge_roofline as mr
from nanopore_dna_storage_tpu_torch.probes import treepop as tp

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (64, 8, 128)  # the scripts' NC and F, a narrower CT


def _script(name):
    """Import ``scripts/<name>.py`` by path, leaving the environment as it
    was (the roofline script sets a JAX cache directory)."""
    key = "JAX_COMPILATION_CACHE_DIR"
    was = os.environ.get(key)
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if was is None:
        os.environ.pop(key, None)
    return mod


ROOF = _script("tpu_vpu_roofline")
TREE = _script("tpu_treepop_probe")


def _pallas(kernel, out_shape, *args):
    fn = pl.pallas_call(kernel, out_shape=out_shape, interpret=True)
    return fn(*map(jnp.asarray, args))


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _merge_inputs(hashes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    if hashes == "few":  # six (h1, h2) classes: whole classes knocked out,
        # all -inf columns from round 7, denormal bitcasts in the stream
        return (x, rng.integers(0, 3, SHAPE).astype(np.int32),
                rng.integers(0, 2, SHAPE).astype(np.int32))
    h1 = rng.integers(0, 1 << 30, SHAPE, dtype=np.int64).astype(np.int32)
    h2 = h1 if hashes == "same" else rng.integers(
        0, 1 << 30, SHAPE, dtype=np.int64).astype(np.int32)
    return x, h1, h2


@pytest.mark.parametrize("hashes", ["same", "different", "few"])
@pytest.mark.parametrize("rounds", [1, 8])
@pytest.mark.parametrize("kind", ["merge", "stream"])
def test_merge_and_stream_match_pallas(kind, rounds, hashes):
    x, h1, h2 = _merge_inputs(hashes, seed=rounds)
    make = (ROOF.make_merge_kernel if kind == "merge"
            else ROOF.make_stream_kernel)
    want = _pallas(make(rounds), jax.ShapeDtypeStruct(SHAPE[1:], jnp.float32),
                   x, h1, h2)
    ref = mr.merge_ref if kind == "merge" else mr.stream_ref
    got = ref(*map(torch.from_numpy, (x, h1, h2)), rounds)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    if kind == "merge" and hashes == "few" and rounds == 8:
        assert np.isneginf(got.numpy()).all()


def _tree_inputs(scores, seed):
    rng = np.random.default_rng(seed)
    if scores == "normal":
        x = rng.normal(size=SHAPE).astype(np.float32)
    else:  # integer scores in {0, 1, 2}, and some columns all -inf
        x = rng.integers(0, 3, SHAPE).astype(np.float32)
        x[:, 0, :4] = -np.inf
    h = rng.permutation(x.size).astype(np.int32).reshape(SHAPE)
    return x, h


@pytest.mark.parametrize("scores", ["normal", "ties"])
@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_treepop_matches_pallas(variant, scores):
    x, h = _tree_inputs(scores, seed=len(variant))
    want_v, want_h = _pallas(
        TREE.make(variant),
        [jax.ShapeDtypeStruct(SHAPE[1:], jnp.float32),
         jax.ShapeDtypeStruct(SHAPE[1:], jnp.int32)], x, h)
    got_v, got_h = tp.treepop_ref(torch.from_numpy(x), torch.from_numpy(h),
                                  variant)
    assert np.array_equal(_bits(got_v.numpy()), _bits(want_v))
    assert np.array_equal(got_h.numpy(), np.asarray(want_h))
    n = tp.CONCAT_N if variant == "concat" else SHAPE[0]
    first = np.take_along_axis(h[:n], x[:n].argmax(0)[None], 0)[0]
    if variant == "halves" and scores == "ties":
        # pairing i with i + n/2 does not keep the first maximum on ties
        assert not np.array_equal(got_h.numpy(), first)
    else:
        assert np.array_equal(got_h.numpy(), first)


def test_run_when_matches_pallas(monkeypatch, capsys):
    """The script's own ``run_when(128)``, its pallas_call run in interpret
    mode, against the guarded plain tree on the inputs it made."""
    seen = {}

    def pallas_call(kernel, **kw):
        fn = pl.pallas_call(kernel, interpret=True, **kw)

        def call(*args):
            seen["args"] = [np.array(a) for a in args]
            seen["out"] = [np.array(o) for o in fn(*args)]
            return seen["out"]
        return call

    monkeypatch.setattr(TREE, "pl", types.SimpleNamespace(
        pallas_call=pallas_call, when=pl.when))
    TREE.run_when(128)
    assert "when ct=128: value_ok=True payload_ok=True" in \
        capsys.readouterr().out
    x, h = seen["args"]
    assert x.shape == (64, 8, 128)
    got_v, got_h = tp.treepop_ref(torch.from_numpy(x), torch.from_numpy(h),
                                  "reshape_pair", guarded=True)
    assert np.array_equal(_bits(got_v.numpy()), _bits(seen["out"][0]))
    assert np.array_equal(got_h.numpy(), seen["out"][1])


def test_failed_guard_leaves_outputs_zero():
    x, h = _tree_inputs("normal", seed=0)
    x[0, 0, 0] = 2e9
    v, p = tp.treepop(torch.from_numpy(x), torch.from_numpy(h),
                      "reshape_pair", guarded=True)
    assert not v.any() and not p.any()


@pytest.mark.parametrize("name", [*tp.VARIANTS, "when"])
def test_treepop_entry_points_on_cpu(name, capsys):
    ok = (tp.run_when(64, device="cpu") if name == "when"
          else tp.run(name, device="cpu"))
    assert ok
    assert "value_ok=True payload_ok=True" in capsys.readouterr().out


def test_acs_work_ops_hand_count():
    cfg = DecodeConfig(code=ConvCodeConfig(mem=6, rate=1, msg_len=30),
                       list_size=2, max_deviation=6)
    spec, _ = DecodeSpec.build(cfg)
    assert (spec.list_size, spec.code.nstate_conv) == (2, 64)
    # per (read, window row, CRF state, conv state) at L = 2:
    # merge: 2 rounds x (12 sweeps x 16 candidates + 4 ops x 2 slots) = 400
    # hashes: 4 betas x 2 hashes x 11 ops x 2 slots = 176
    assert mr.acs_work_ops(spec, 3) == spec.window * 8 * 64 * 3 * (400 + 176)
    # the headline config's 7,104 ops per cell
    big = DecodeSpec.build(DecodeConfig(
        code=ConvCodeConfig(mem=11, rate=5, msg_len=180), list_size=8,
        max_deviation=20))[0]
    assert mr.acs_work_ops(big, 1) == big.window * 8 * 2048 * 7104


def test_acs_executed_ops_hand_count():
    spec, _ = DecodeSpec.build(DecodeConfig(
        code=ConvCodeConfig(mem=6, rate=1, msg_len=30), list_size=2,
        max_deviation=6))
    valid = torch.zeros((spec.window, 64), dtype=torch.bool)
    valid[:3, :10] = True
    # flip states: 8 rows, 2 x (12 x 16 + 8) merge + 22 x 7 x 2 hash ops;
    # flop states: 2 rows, 2 x (12 x 4 + 8) merge + 22 x 1 x 2 hash ops
    flip, flop = 2 * (192 + 8) + 308, 2 * (48 + 8) + 44
    rows = [8] * 4 + [2] * 4
    assert mr.acs_executed_ops(spec, rows, valid) == 30 * (4 * flip
                                                          + 4 * flop)
    # every state valid: the hash terms of both counts agree, and only the
    # padding of the flop rows separates the merge terms
    pad = 4 * 2 * 12 * 6 * 2  # 4 flop states x L rounds x 12 x 6 rows x L
    assert mr.acs_executed_ops(spec, rows, valid | True) + \
        spec.window * 64 * pad == mr.acs_work_ops(spec, 1)


def test_acs_needed_ops_hand_count():
    spec, _ = DecodeSpec.build(DecodeConfig(
        code=ConvCodeConfig(mem=6, rate=1, msg_len=30), list_size=2,
        max_deviation=6))
    valid = torch.zeros((spec.window, 64), dtype=torch.bool)
    valid[:3, :10] = True
    rows = [8] * 4 + [2] * 4
    # flip states, n = 8 rows at L = 2: argmax 3 x 8 x 2, pair checks
    # 3 x 1, score adds 8 + 1, first move heads' hashes 22 x 7, outputs 8
    flip = 48 + 3 + 9 + 154 + 8
    flop = 12 + 3 + 3 + 22 + 8  # n = 2
    assert mr.acs_needed_ops(spec, rows, valid) == 30 * (4 * flip
                                                        + 4 * flop)
    # the headline config: about a fourteenth of the flat scan's count
    big = DecodeSpec.build(DecodeConfig(
        code=ConvCodeConfig(mem=11, rate=5, msg_len=180), list_size=8,
        max_deviation=20))[0]
    ones = torch.ones((big.window, 2048), dtype=torch.bool)
    need = mr.acs_needed_ops(big, rows, ones)
    assert need == big.window * 2048 * (4 * (192 + 84 + 15 + 154 + 32)
                                        + 4 * (48 + 84 + 9 + 22 + 32))
    assert 13 < mr.acs_executed_ops(big, rows, ones) / need < 15


@pytest.mark.parametrize("kind", ["merge", "stream", "treepop"])
def test_cpu_tensors_take_the_plain_path(kind):
    x, h1, h2 = map(torch.from_numpy, _merge_inputs("different"))
    launches = (dict(mr.LAUNCHES), tp.LAUNCHES)
    if kind == "treepop":
        got = tp.treepop(x, h1, "concat")
        want = tp.treepop_ref(x, h1, "concat")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        got = getattr(mr, kind)(x, h1, h2, 2, copies=3)
        want = getattr(mr, f"{kind}_ref")(x, h1, h2, 2)
        assert got.shape == (3, *SHAPE[1:])
        assert all(torch.equal(g, want) for g in got)
    assert (dict(mr.LAUNCHES), tp.LAUNCHES) == launches


@pytest.mark.parametrize("kind", ["merge", "stream", "treepop"])
def test_unsupported_device_raises(kind):
    x = torch.empty(SHAPE, dtype=torch.float32, device="meta")
    h = torch.empty(SHAPE, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        if kind == "treepop":
            tp.treepop(x, h, "argmax")
        else:
            getattr(mr, kind)(x, h, h, 1)


_NO_JAX = """
import sys
sys.modules["jax"] = None  # any import of jax now fails
import torch
torch.set_num_threads(1)
from nanopore_dna_storage_tpu_torch.probes import merge_roofline, treepop
x = torch.randn(64, 2, 16)
h = torch.randint(0, 1 << 30, (64, 2, 16), dtype=torch.int32)
assert merge_roofline.merge(x, h, h, 2, copies=2).shape == (2, 2, 16)
assert merge_roofline.stream(x, h, h, 2).shape == (1, 2, 16)
assert treepop.run("concat", device="cpu")
assert treepop.run_when(16, device="cpu")
bad = [m for m in sys.modules
       if m.startswith(("jax.", "scripts", "tpu_"))
       or (m == "jax" and sys.modules[m] is not None)]
assert not bad, bad
print("ok")
"""


def test_probes_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=100)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
