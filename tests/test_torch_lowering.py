"""Parity of the port's lowering probes (``probes/lowering.py``) with the TPU
probe script they replace, ``scripts/tpu_pallas_probe.py`` (P1), imported by
file path.

Each of the script's six probes runs as the script runs it, with
``pl.pallas_call`` in interpret mode; the inputs and output of its kernel
are captured, and the port's plain versions and CPU wrappers run on the
same inputs. The kernels themselves are kept, so that further inputs (int16
values that overflow, scores that tie, a random stale buffer, the window at
the last rows) go through the script's own kernel too. Edge behaviour the
script leaves undefined (a row index or a window outside [0, P)) and the
fori probe at the ACS kernel's shape are held to numpy. The tolerance is
zero, bit for bit: every probe is integer work, a copy, or one f32 add or
subtract per step.
"""
import importlib.util
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nanopore_dna_storage_tpu_torch.probes import expand
from nanopore_dna_storage_tpu_torch.probes import lowering as lo

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "tpu_pallas_probe", ROOT / lo.SCRIPT)
P1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P1)
PROBES = ("repeat", "dynrow", "int16", "fori", "reshape", "alias")


def _capture(monkeypatch):
    """Swap the script's ``pl.pallas_call`` for interpret mode; return the
    list each call appends (kernel, keywords, inputs, output) to."""
    seen = []

    def pallas_call(kernel, **kw):
        fn = pl.pallas_call(kernel, interpret=True, **kw)

        def call(*args):
            out = fn(*args)
            seen.append((kernel, kw, [np.array(a) for a in args],
                         np.array(out)))
            return out
        return call

    monkeypatch.setattr(P1, "pl", types.SimpleNamespace(
        pallas_call=pallas_call, ds=pl.ds, program_id=pl.program_id,
        BlockSpec=pl.BlockSpec))
    return seen


def _script(name, monkeypatch, capsys):
    """Run the script's ``p_<name>``; return its kernel, the keywords of its
    pallas_call, the kernel's inputs and its output."""
    seen = _capture(monkeypatch)
    P1.ALL[name]()
    assert f"{name} OK" in capsys.readouterr().out
    assert len(seen) == 1
    return seen[0]


def _rerun(kernel, kw, *inputs):
    """The script's kernel on other inputs, in interpret mode."""
    return np.array(pl.pallas_call(kernel, interpret=True, **kw)(
        *map(jnp.asarray, inputs)))


def _port_inputs(name, script_inputs):
    """The port's inputs for the script's: fori also takes the hashes the
    script's kernel makes inside (all 3)."""
    if name == "fori":
        x, = script_inputs
        return (x, np.full(x.shape, 3, np.uint32))
    return tuple(script_inputs)


def _check_port(case, arrays, want):
    """The plain version and the CPU wrapper of every form on ``arrays``,
    bit-equal to ``want``; the numpy reference too."""
    assert lo.same(np.ascontiguousarray(case.want(*arrays)), want)
    tensors = lo.tensors(arrays, "cpu")
    launches = dict(lo.LAUNCHES), dict(expand.LAUNCHES)
    for form in case.forms:
        kernel, plain = case.bind(tensors, form)
        assert lo.same(plain().numpy(), want), form
        assert lo.same(np.ascontiguousarray(kernel().numpy()), want), form
    assert (lo.LAUNCHES, expand.LAUNCHES) == launches


def _case(name):
    return next(c for c in lo.CASES if c.name == name)


@pytest.mark.parametrize("name", PROBES)
def test_probe_matches_the_script_kernel(name, monkeypatch, capsys):
    _, _, inputs, y = _script(name, monkeypatch, capsys)
    case = _case(name)
    assert tuple(a.shape for a in _port_inputs(name, inputs)) == case.shapes
    _check_port(case, _port_inputs(name, inputs), y)


@pytest.mark.parametrize("name", [c.name for c in lo.CASES])
def test_case_replaces_the_scripts_pallas_call(name):
    case = _case(name)
    path, line = case.replaces.split(":")
    assert path == lo.SCRIPT
    lines = (ROOT / path).read_text().splitlines()
    assert "pl.pallas_call(" in lines[int(line) - 1]
    arrays, tensors = case.inputs("cpu")
    assert tuple(a.shape for a in arrays) == case.shapes
    assert all(t.shape == a.shape for t, a in zip(tensors, arrays))


@pytest.mark.parametrize("values", ["random", "extremes"])
def test_int16_wraps_as_the_script_kernel(values, monkeypatch, capsys):
    kernel, kw, _, _ = _script("int16", monkeypatch, capsys)
    rng = np.random.default_rng(5)
    if values == "random":
        x = rng.integers(-2**31, 2**31, (64, 1024), dtype=np.int64)
    else:  # every value whose product wraps int32 or int16 at an edge
        edges = np.array([2**31 - 1, -2**31, 2**25, -2**25, 2**25 - 1, 511,
                          512, -512, -513, 1023, 1024, 0, -1], np.int64)
        x = np.resize(edges, 64 * 1024).reshape(64, 1024)
    x = x.astype(np.int32)
    y = _rerun(kernel, kw, x)
    assert np.array_equal(y, (x * 64 + 7).astype(np.int16))
    assert not np.array_equal(y.astype(np.int64), x.astype(np.int64) * 64 + 7)
    _check_port(_case("int16"), (x,), y)


@pytest.mark.parametrize("scores", ["integers", "integers_with_neg_inf"])
def test_fori_ties_take_the_first_index(scores, monkeypatch, capsys):
    kernel, kw, (x0,), _ = _script("fori", monkeypatch, capsys)
    x = np.random.default_rng(6).integers(0, 3, x0.shape).astype(np.float32)
    if scores == "integers_with_neg_inf":
        x[:, :8] = -np.inf
        x[5:, 8:16] = -np.inf
    y = _rerun(kernel, kw, x)
    _check_port(_case("fori"), (x, np.full(x.shape, 3, np.uint32)), y)


@pytest.mark.parametrize("scores", ["normal", "integers"])
@pytest.mark.parametrize("hashes", ["threes", "random"])
def test_fori_at_the_acs_merge_shape(scores, hashes):
    """NQ = 8L = 64 candidates, R = L = 8 rounds: the plain version against
    numpy (the script's kernel is fixed at NQ = 32)."""
    nq, rounds = lo.FORI_POINTS[1]
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((nq, 1024)) if scores == "normal"
         else rng.integers(0, 2, (nq, 1024))).astype(np.float32)
    h = (np.full((nq, 1024), 3, np.uint32) if hashes == "threes" else
         rng.integers(0, 1 << 32, (nq, 1024), dtype=np.uint64)
         .astype(np.uint32))
    want = lo.np_fori(x, h, rounds)
    assert np.isfinite(want).all()
    _check_port(_case("fori.k1"), (x, h), want)


@pytest.mark.parametrize("start", [3, 12])  # the script's, the last rows
def test_alias_keeps_the_rows_outside_a_random_window(start, monkeypatch,
                                                      capsys):
    kernel, kw, (_, x, _), _ = _script("alias", monkeypatch, capsys)
    stale = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32)
    s = np.array([start], np.int32)
    y = _rerun(kernel, kw, s, x, stale)
    window = range(start, start + lo.ALIAS_WINDOW)
    outside = [p for p in range(len(stale)) if p not in window]
    assert np.array_equal(y[outside], stale[outside])
    assert not np.array_equal(y[list(window)], stale[list(window)])
    _check_port(_case("alias"), (s, x, stale), y)
    st = torch.from_numpy(stale.copy())
    got = lo.alias(st, torch.from_numpy(x), torch.from_numpy(s),
                   lo.ALIAS_WINDOW)
    assert got is st and lo.same(st.numpy(), y)


@pytest.mark.parametrize("start", [13, 15, 16, 100, -1, -3, -100])
def test_alias_skips_window_rows_outside_the_buffer(start):
    rng = np.random.default_rng(9)
    x, stale = (rng.standard_normal((16, 8, 256)).astype(np.float32)
                for _ in range(2))
    s = np.array([start], np.int32)
    want = lo.np_alias(s, x, stale, lo.ALIAS_WINDOW)
    inside = [start + w for w in range(lo.ALIAS_WINDOW)
              if 0 <= start + w < 16]
    assert all((want[p] != stale[p]).any() for p in inside)
    _check_port(_case("alias"), (s, x, stale), want)


@pytest.mark.parametrize("index", [0, 135, 136, 1000, 2**31 - 1, -1, -2**31])
def test_dynrow_clamps_the_index(index):
    x = np.random.default_rng(10).standard_normal((136, 1024)).astype(
        np.float32)
    i = np.array([index], np.int32)
    want = x[min(max(index, 0), 135)][None]
    _check_port(_case("dynrow"), (i, x), want)


@pytest.mark.parametrize("name", ["dynrow", "int16", "fori", "reshape",
                                  "alias"])
def test_unsupported_device_raises(name):
    meta = torch.empty((64, 1024), dtype=torch.float32, device="meta")
    calls = {
        "dynrow": lambda: lo.dynrow(meta, torch.zeros(1, dtype=torch.int32)),
        "int16": lambda: lo.int16(meta.int()),
        "fori": lambda: lo.fori(meta, meta.int(), 8),
        "reshape": lambda: lo.reshape(meta.view(8, 8, 1024)),
        "alias": lambda: lo.alias(meta, meta,
                                  torch.zeros(1, dtype=torch.int32), 4),
    }
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        calls[name]()


def test_bad_arguments_raise():
    x = torch.zeros((32, 64))
    h = torch.zeros((32, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown placement"):
        lo.fori(x, h, 8, "shared")
    with pytest.raises(ValueError, match="rounds"):
        lo.fori(x, h, -1)
    with pytest.raises(ValueError, match="copies"):
        lo.fori(x, h, 8, copies=0)
    with pytest.raises(ValueError, match="threads_per_sm"):
        lo.fori(x, h, 8, threads_per_sm=-1)
    with pytest.raises(ValueError, match="unknown placement"):
        lo.fori_ops(32, "shared")
    with pytest.raises(ValueError, match="window"):
        lo.alias(x, x, torch.zeros(1, dtype=torch.int32), 0)


def test_fori_copies_and_op_count():
    nq, rounds = lo.FORI_POINTS[0]
    x = torch.randn(nq, 64)
    h = torch.full((nq, 64), 3, dtype=torch.int32)
    want = lo.fori_ref(x, h, rounds)
    for per_sm in (0, 128):  # the grid's cap is the card's: none here
        got = lo.fori(x, h, rounds, "local", copies=3, threads_per_sm=per_sm)
        assert got.shape == (3, 1, 64)
        assert all(torch.equal(g, want) for g in got)
    # what the function needs (and local executes), and what regs executes
    # at one lane a column
    assert [lo.fori_ops(n) for n in (32, 64)] == [104, 200]
    assert [lo.fori_ops(n, "local") for n in (32, 64)] == [104, 200]
    assert [lo.fori_ops(n, "regs") for n in (32, 64)] == [168, 328]


def test_select_cases():
    assert lo.select([]) == lo.CASES
    assert [c.name for c in lo.select(["fori"])] == ["fori", "fori.k1"]
    assert [c.name for c in lo.select(["alias", "int16"])] == \
        ["int16", "alias"]
    with pytest.raises(ValueError, match="no case"):
        lo.select(["p9"])


def test_grid_blocks_are_the_launchers_grids():
    """The empty kernel is timed at the grids that dynrow, int16, reshape
    and alias launch at the script's shapes: blocks of 128 threads over a
    row of 1024, 64 x 1024 elements, 65,536 floats as 16-byte vectors, and
    the 4 window rows of 8 x 256."""
    grids = {c.name: lo.grid_blocks(c) for c in lo.CASES
             if c.name in lo.GRID_CASES}
    assert grids == {"dynrow": 8, "int16": 512, "reshape": 128, "alias": 64}
    assert lo.BLOCK == 128
