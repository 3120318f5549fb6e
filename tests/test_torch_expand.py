"""Parity of the port's expansion probes (``probes/expand.py``) with the TPU
probe scripts they replace: ``scripts/tpu_pallas_probe2.py`` (P2),
``scripts/tpu_repeat_probe.py`` (P3) and ``scripts/tpu_expand_probe.py``
(P4), imported by file path.

Each script case runs as the script runs it, with ``pl.pallas_call`` in
interpret mode (and, for P3 and P4, ``jax.jit`` as the identity and the
timing loop cut to one call); the inputs and output of its kernel are
captured and the port's plain versions (``lane_map_ref``,
``transpose_ref``) and CPU wrappers run on the same input. The tolerance is
zero, bit for bit: every case only moves f32 values.

Two kernels cannot be traced by this JAX: P2's ``p_take`` and P3's
``roll_butterfly`` close over numpy arrays (the take index, the stage
masks), and ``pallas_call`` refuses a kernel that captures constants. For
those the test runs a copy of the kernel body that takes the index or the
masks as an input, and also checks the result against the numpy result the
script itself checks against.
"""
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nanopore_dna_storage_tpu_torch.probes import expand as ex

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P2 = _script("tpu_pallas_probe2")
P3 = _script("tpu_repeat_probe")
P4 = _script("tpu_expand_probe")


def _capture(monkeypatch, mod):
    """Swap ``mod``'s pallas_call for interpret mode (and its jax.jit and
    fori_loop for one plain call); return the list the first concrete call
    appends (inputs, output) to."""
    seen = []

    def pallas_call(kernel, **kw):
        fn = pl.pallas_call(kernel, interpret=True, **kw)

        def call(*args):
            out = fn(*args)
            if not seen:
                seen.append(([np.array(a) for a in args], np.array(out)))
            return out
        return call

    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        pallas_call=pallas_call, BlockSpec=pl.BlockSpec))
    monkeypatch.setattr(mod, "jax", types.SimpleNamespace(
        jit=lambda f: f, ShapeDtypeStruct=jax.ShapeDtypeStruct,
        lax=types.SimpleNamespace(
            fori_loop=lambda lo, hi, body, init: body(jnp.int32(lo), init),
            broadcasted_iota=jax.lax.broadcasted_iota)))
    return seen


def _take_kernel(x_ref, idx_ref, o_ref):
    """``p_take``'s body, its index passed in instead of closed over."""
    o_ref[...] = jnp.take(x_ref[...], idx_ref[...], axis=1)


def _roll_butterfly(k):
    """P3 ``roll_butterfly``'s body, its masks passed in; the masks and
    shifts are the script's own loop, which is ``tpu_expand_probe.py``
    ``bfly_masks`` and ``shifts``."""
    ct = P3.CT
    masks = P4.bfly_masks(ct, int(np.log2(k)))
    shifts = [ct >> (1 + i) for i in range(int(np.log2(ct)))] * 2

    def kernel(x_ref, m_ref, o_ref):
        sl = x_ref[:][:, : ct // k]
        y = jnp.tile(sl, (1, k))
        for s, d in zip(range(masks.shape[0]), shifts):
            y = jnp.where(m_ref[s] != 0, pltpu.roll(y, d, 1), y)
        o_ref[:] = y
    return kernel, masks


def _script_case(case, monkeypatch, capsys):
    """Run the script's own code for ``case``; return its kernel's input
    x, its output y, and the numpy result the script checks against."""
    script, fn, *rest = case.name.split(".")
    k = int(rest[0][1:]) if rest else 2
    if case.name == "p2.take":
        x = np.random.default_rng(0).standard_normal((8, P2.C)).astype(
            np.float32)
        idx = (np.arange(P2.C) // P2.K).astype(np.int32)
        y = pl.pallas_call(_take_kernel, interpret=True, out_shape=jax.
                           ShapeDtypeStruct(x.shape, jnp.float32))(x, idx)
        return x, np.array(y), x[:, np.arange(P2.C) // P2.K]
    if fn == "roll_butterfly":
        kernel, masks = _roll_butterfly(k)
        x = np.random.default_rng(0).standard_normal((8, P3.CT)).astype(
            np.float32)
        y = pl.pallas_call(kernel, interpret=True, out_shape=jax.
                           ShapeDtypeStruct(x.shape, jnp.float32))(x, masks)
        return x, np.array(y), x[:, : P3.CT // k].repeat(k, axis=1)
    mod = {"p2": P2, "p3": P3, "p4": P4}[script]
    seen = _capture(monkeypatch, mod)
    if script == "p2":
        P2.ALL[fn]()
    else:
        mod.run(fn, k)
    out = capsys.readouterr().out
    assert seen, out
    (x, *_), y = seen[0]
    if script == "p2" and fn == "pltpurepeat_semantics":
        assert "pltpu.repeat semantics: tile" in out
    elif script == "p2":
        assert f"{fn} OK" in out
    else:  # P3's pltpu.repeat tiles, so its element-repeat check fails
        assert f"correct={fn != 'pltpu_repeat'}" in out
    return x, y, case.want(x)


@pytest.mark.parametrize("name", [c.name for c in ex.CASES])
def test_case_matches_the_script_kernel(name, monkeypatch, capsys):
    case = next(c for c in ex.CASES if c.name == name)
    x, y, script_want = _script_case(case, monkeypatch, capsys)
    assert np.array_equal(case.want(x).view(np.uint32),
                          np.asarray(script_want).view(np.uint32))
    xt = torch.from_numpy(np.ascontiguousarray(x))
    for form in case.forms:
        kernel, plain = case.bind(xt, form)
        assert np.array_equal(plain().numpy().view(np.uint32),
                              y.view(np.uint32)), form
        got = kernel(3)  # the CPU wrapper: the plain version, 3 copies
        assert got.shape == (3, *y.shape)
        assert all(np.array_equal(g.numpy(), y) for g in got)


@pytest.mark.parametrize("k", [2, 4])
def test_pltpu_repeat_tiles_and_differs_from_the_element_repeat(k):
    x = torch.arange(8 * 64, dtype=torch.float32).reshape(8, 64)
    tile = ex.lane_map_ref(x, "tile", k)
    element = ex.lane_map_ref(x, "element", k)
    assert torch.equal(tile, x[:, : 64 // k].repeat(1, k))
    assert not torch.equal(tile, element)


@pytest.mark.parametrize("ct,logk", [(1024, 1), (2048, 1), (2048, 2)])
def test_masks_match_the_scripts(ct, logk):
    """The port's copies of the scripts' mask builders: P4's ``bfly_masks``
    and ``shifts``, and P2's in-kernel index tracking (one pass, which
    reaches j >> 1 at ct = 1024)."""
    masks = ex.bfly_masks(ct, logk)
    assert np.array_equal(masks, P4.bfly_masks(ct, logk))
    assert ex.butterfly_shifts(ct, len(masks)) == \
        tuple(P4.shifts(ct, len(masks)))
    x = torch.from_numpy(np.random.default_rng(ct).standard_normal(
        (4, ct)).astype(np.float32))
    want = ex.lane_map_ref(x, "element", 1 << logk)
    got = ex.lane_map_ref(x, "element", 1 << logk, "butterfly",
                          torch.from_numpy(masks),
                          ex.butterfly_shifts(ct, len(masks)))
    assert torch.equal(got, want)
    if logk == 1 and ct == 1024:
        tracked = ex.tracked_masks(ct, logk)
        got = ex.lane_map_ref(x, "element", 2, "butterfly",
                              torch.from_numpy(tracked),
                              ex.butterfly_shifts(ct, len(tracked)),
                              start="identity")
        assert torch.equal(got, want)


def test_select_cases():
    assert ex.select([]) == ex.CASES
    assert [c.name for c in ex.select(["p3.jnp_repeat"])] == \
        ["p3.jnp_repeat.k2", "p3.jnp_repeat.k4"]
    assert len(ex.select(["p2"])) == 7
    with pytest.raises(ValueError, match="no case"):
        ex.select(["p9"])


@pytest.mark.parametrize("call", ["lane_map", "transpose"])
def test_cpu_tensors_take_the_plain_path(call):
    x = torch.randn(8, 64)
    launches = dict(ex.LAUNCHES)
    if call == "transpose":
        assert torch.equal(ex.transpose(x, 2)[1], x.t())
    else:
        assert torch.equal(ex.lane_map(x, "pair", copies=2)[1],
                           ex.lane_map_ref(x, "pair"))
    assert ex.LAUNCHES == launches


@pytest.mark.parametrize("form", ex.FORMS)
def test_unsupported_device_raises(form):
    x = torch.empty((8, 64), dtype=torch.float32, device="meta")
    kw = {}
    if form == "butterfly":
        kw = dict(masks=torch.zeros((1, 64), dtype=torch.int32),
                  shifts=(1,))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ex.lane_map(x, "element", 2, form, **kw)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ex.transpose(x)


def test_bad_arguments_raise():
    x = torch.randn(8, 64)
    with pytest.raises(ValueError, match="element map only"):
        ex.lane_map(x, "tile", 2, "shfl")
    with pytest.raises(ValueError, match="power of two"):
        ex.lane_map(x, "element", 3)
    with pytest.raises(ValueError, match="one mask row per shift"):
        ex.lane_map(x, "element", 2, "butterfly",
                    masks=torch.zeros((2, 64), dtype=torch.int32),
                    shifts=(1,))


@pytest.mark.parametrize("ct,logk", [(1024, 1), (2048, 1), (2048, 2)])
def test_packed_bits_unpack_to_the_masks(ct, logk):
    """``pack_masks`` (what the butterfly kernel reads) unpacks to the
    scripts' masks, P4's ``bfly_masks`` and P2's ``tracked_masks``: bit
    j % 32 of word j // 32 is column j's mask."""
    for masks in (P4.bfly_masks(ct, logk), ex.tracked_masks(ct, logk)):
        bits = ex.pack_masks(torch.from_numpy(masks)).numpy()
        assert bits.shape == (len(masks), ct // 32) and bits.dtype == np.int32
        unpacked = (bits.view(np.uint32)[:, :, None]
                    >> np.arange(32, dtype=np.uint32)) & 1
        assert np.array_equal(unpacked.reshape(len(masks), ct), masks != 0)


@pytest.mark.parametrize("ct,logk,start", [(1024, 1, "identity"),
                                           (2048, 1, "tile"),
                                           (2048, 2, "tile")])
def test_butterfly_kernel_layout_model(ct, logk, start):
    """A numpy model of the butterfly kernel's data path: thread (warp w,
    lane l) holds columns span l + 2 w and + 1 (span = ct / 32); a stage
    whose shift is a whole number of spans rotates the lanes of every warp
    (the shuffle), any other reads the row back through a shared buffer.
    Both give roll(y, d), so the model equals ``lane_map_ref``."""
    masks = (ex.tracked_masks if start == "identity" else ex.bfly_masks)(
        ct, logk)
    shifts = ex.butterfly_shifts(ct, len(masks))
    x = np.random.default_rng(ct + logk).standard_normal(ct).astype(
        np.float32)
    span, warps = ct // 32, ct // 64
    lane, w = np.meshgrid(np.arange(32), np.arange(warps), indexing="ij")
    j = span * lane + 2 * w  # [32, warps]: each thread's first column
    n = ct >> logk
    v = np.stack([x[j % n if start == "tile" else j],
                  x[(j + 1) % n if start == "tile" else j + 1]])
    bits = ex.pack_masks(torch.from_numpy(masks)).numpy().view(np.uint32)
    shuffled = 0
    for s, d in enumerate(shifts):
        word = bits[s][j >> 5] >> (j & 31).astype(np.uint32)
        m = np.stack([word & 1, (word >> 1) & 1]) != 0
        if d % span == 0:
            r = v[:, (np.arange(32) - d // span) % 32, :]
            shuffled += 1
        else:
            row = np.empty(ct, np.float32)
            row[j], row[j + 1] = v[0], v[1]
            r = np.stack([row[(j - d) % ct], row[(j + 1 - d) % ct]])
        v = np.where(m, r, v)
    got = np.empty(ct, np.float32)
    got[j], got[j + 1] = v[0], v[1]
    want = ex.lane_map_ref(torch.from_numpy(x[None]), "element", 1 << logk,
                           "butterfly", torch.from_numpy(masks), shifts,
                           start)[0].numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert shuffled == 5  # the rolls by ct / 2 .. ct / 32 are shuffles


@pytest.mark.parametrize("cout", [1024, 2048, 96])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32])
def test_shfl_kernel_layout_model(k, cout):
    """A numpy model of the shuffle kernel's data path: warp w owns columns
    base = 128 w .. base + 127 of a row, lane l the four at base + 4 l;
    register i of lane l holds source (base >> p) + 32 i + l, loaded only
    below the warp's source count; value d of lane l is the shuffle of
    every register from lane s % 32, s = (4 l >> p) + d, the one of
    register s // 32 selected; element e is value e >> p, stored only below
    cout (at cout = 96 the warp is partial). It equals ``lane_map_ref``."""
    p = k.bit_length() - 1
    regs = max(1, 4 >> p)
    x = np.random.default_rng(k * cout).standard_normal((3, cout)).astype(
        np.float32)
    got = np.full(x.shape, np.nan, np.float32)
    lane = np.arange(32)
    shuffles = 0
    for r in range(x.shape[0]):
        for base in range(0, cout, 128):
            nsrc = min(cout - base, 128) >> p
            s = 32 * np.arange(regs)[:, None] + lane  # [register, lane]
            src = np.where(s < nsrc, x[r, (base >> p) + np.minimum(
                s, nsrc - 1)], np.float32(0))
            val = np.zeros((regs, 32), np.float32)
            for d in range(regs):
                s = ((4 * lane) >> p) + d
                for i in range(regs):
                    t = src[i, s & 31]  # __shfl_sync(src[i], s % 32)
                    val[d] = np.where(s >> 5 == i, t, val[d])
                    shuffles += 1
            j0 = base + 4 * lane
            live = j0 < cout
            for e in range(4):
                got[r, j0[live] + e] = val[e >> p, live]
    want = ex.lane_map_ref(torch.from_numpy(x), "element", k, "shfl").numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # one shuffle per value and register: 16, 4, then 1 from k = 4 on
    assert shuffles == x.shape[0] * -(-cout // 128) * regs * regs


@pytest.mark.parametrize("shape,aligned", [
    ((16, 128), True), ((128, 16), True), ((17, 45), True),
    ((33, 100), True), ((1, 1), True), ((16, 128), False)])
def test_transpose_kernel_layout_model(shape, aligned):
    """A numpy model of the transpose kernel's data path, as
    ``transpose_plan`` cuts x: block b stages its tile (thread t loads four
    neighbouring elements of tile row t // (TC / 4), as one 16-byte load on
    the vector path, masked per element on the scalar one) into shared
    memory with each row's columns XOR-swizzled by its group of four; thread
    t then reads y's row c0 + t // G, elements r0 + 4 (t % G) .. + 3, from
    the tile's column and stores them (whole, or masked at y's row end). It
    equals ``transpose_ref``; every tile slot is written once, and every
    warp's reads of one tile row group hit 32 banks, its quarter-warps'
    16-byte writes 8 distinct 16-byte bank groups."""
    R, C = shape
    rows, vec = ex.transpose_plan(R, C, aligned)
    assert rows == {16: 16, 128: 32, 17: 32, 33: 32, 1: 4}[R]
    assert vec == (aligned and shape in ((16, 128), (128, 16)))
    tile_n = ex.TRANSPOSE_TILE
    TC, G, swz = tile_n // rows, rows // 4, 128 // rows
    x = np.random.default_rng(R * C).standard_normal(shape).astype(
        np.float32)
    got = np.full((C, R), np.nan, np.float32)
    t = np.arange(tile_n // 4)
    tiles_c = -(-C // TC)
    for b in range(-(-R // rows) * tiles_c):
        r0, c0 = (b // tiles_c) * rows, (b % tiles_c) * TC
        i, j = t // (TC // 4), 4 * (t % (TC // 4))
        slot = i * TC + (j ^ ((i >> 2) * swz))
        assert slot.min() >= 0 and slot.max() < tile_n
        for quarter in slot.reshape(-1, 8) // 4:
            assert len(set(quarter % 8)) == 8
        tile = np.full(tile_n, np.nan, np.float32)
        written = np.zeros(tile_n, int)
        r = r0 + i
        for e in range(4):
            c = c0 + j + e
            ok = (r < R) & ((c0 + j < C) if vec else (c < C))
            tile[slot + e] = np.where(
                ok, x[np.minimum(r, R - 1), np.minimum(c, C - 1)],
                np.float32(0))
            written[slot + e] += 1
        assert (written == 1).all()
        g, jj = t % G, t // G
        col = 4 * g * TC + (jj ^ (g * swz))
        for m in range(4):
            for warp in (col + m * TC).reshape(-1, 32):
                assert len(set(warp % 32)) == 32
        q = tile[col[:, None] + TC * np.arange(4)]  # [thread, 4]
        r, c = r0 + 4 * g, c0 + jj
        live = (r < R) & (c < C)
        if vec:
            assert (R - r[live] >= 4).all()
        for e in range(4):
            st = live & (R - r > e)
            got[c[st], r[st] + e] = q[st, e]
    want = ex.transpose_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_expand_turns_refuses_the_cpu(capfd):
    """The turns runner times each root in a process of its own, with that
    root on PYTHONPATH; without a CUDA device that process exits non-zero,
    and so does the runner, printing no times."""
    if torch.cuda.is_available():
        pytest.skip("on a CUDA device the runner times; this checks the CPU")
    from nanopore_dna_storage_tpu_torch.probes import expand_turns
    assert expand_turns.main(["--roots", str(ROOT)]) == 1
    out, err = capfd.readouterr()
    assert "needs a CUDA device" in err and "_ms" not in out
