"""Parity of the port's one-hot tensor-core product (``probes/
mxu_expand.py``) with the TPU probe scripts it replaces:
``scripts/tpu_mxu_expand_probe.py`` (P5), ``scripts/tpu_mxu_probe2.py``
(P6) and ``scripts/tpu_mxu_probe3.py`` (P7), imported by file path.

Each script runs its own code with ``pl.pallas_call`` in interpret mode,
``jax.jit`` as the identity and its grid cut to 2 steps; its kernel's
inputs and output are captured and ``onehot_mma_ref`` runs on the same
inputs. Tolerances:

* ``u8x4`` against ``HIGHEST``, and ``bf16`` against the bf16 dot: zero,
  bit for bit. A one-hot column makes each output one exact product.
* ``tf32`` against JAX's f32 ``DEFAULT``: 2**-11 relative. This CPU has no
  TF32, so JAX's f32 dot is exact here, and ``round_tf32`` keeps 10
  mantissa bits, rounding to nearest.
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

from nanopore_dna_storage_tpu_torch.probes import mxu_expand as mx

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
TF32_REL = 2.0 ** -11


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P5 = _script("tpu_mxu_expand_probe")
P6 = _script("tpu_mxu_probe2")
P7 = _script("tpu_mxu_probe3")


def _capture(monkeypatch, mod):
    """Interpret-mode pallas_call, identity jit and a 2-step grid in
    ``mod``; returns the list the first call appends (inputs, output) to."""
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
        jit=lambda f: f, lax=jax.lax, ShapeDtypeStruct=jax.ShapeDtypeStruct))
    monkeypatch.setattr(mod, "G", 2)
    return seen


def _u8x4(x, e):
    """``onehot_mma_ref`` in u8x4 on f32 x's bit patterns, as f32."""
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32).view(np.int32))
    return mx.onehot_mma_ref(xt, torch.from_numpy(e.astype(np.uint8)),
                             "u8x4").numpy().view(np.float32)


def _tf32_close(x, e, exact):
    got = mx.onehot_mma_ref(torch.from_numpy(x), torch.from_numpy(e),
                            "tf32").numpy()
    assert np.all(np.abs(got - exact) <= TF32_REL * np.abs(exact))
    return got


def _bits(a):
    return np.asarray(a).view(np.uint32)


def test_p5_kernel(monkeypatch, capsys):
    seen = _capture(monkeypatch, P5)
    P5.main()
    assert "exact: True" in capsys.readouterr().out
    (x, E), y = seen[0]
    h, x5, E5 = mx.p5_inputs()
    assert np.array_equal(x, x5) and np.array_equal(E, E5)
    # u8x4 is the HIGHEST product bit for bit, on the halves and on the
    # hashes themselves
    assert np.array_equal(_bits(_u8x4(x, E)), _bits(y))
    want = h[:, np.arange(512) // 4]
    got = mx.onehot_mma_ref(torch.from_numpy(h),
                            torch.from_numpy(E.astype(np.uint8)), "u8x4")
    assert np.array_equal(got.numpy(), want)
    # tf32 on 16-bit halves: within 2**-11, and not exact
    exact = np.asarray(jnp.dot(x, E, precision=jax.lax.Precision.DEFAULT))
    assert np.array_equal(exact, y)
    assert not np.array_equal(_tf32_close(x, E, exact), y)


def _p6_points(monkeypatch):
    points = []
    monkeypatch.setattr(P6, "bench", lambda *a: points.append(a))
    P6.main()
    monkeypatch.undo()
    return points


@pytest.mark.parametrize("i", range(8))
def test_p6_bench(i, monkeypatch, capsys):
    rows, k, ct, prec, dtype, label = _p6_points(monkeypatch)[i]
    r, kk, n, mode, plabel = mx.P6_POINTS[i]
    assert (r, kk, n, plabel) == (rows, k, ct, label)
    highest = prec == jax.lax.Precision.HIGHEST
    assert mode == ("u8x4" if highest else "tf32" if dtype == np.float32
                    else "bf16")
    seen = _capture(monkeypatch, P6)
    P6.bench(rows, k, ct, prec, dtype, label)
    assert label in capsys.readouterr().out
    (x, e), y = seen[0]
    assert y.shape == (rows, ct)
    assert np.array_equal(e.astype(np.float32), mx.selection(k, ct))
    px, pe = mx.p6_inputs(rows, k, ct)
    assert np.array_equal(x.astype(np.float32),
                          px if mode != "bf16" else torch.from_numpy(px)
                          .bfloat16().float().numpy())
    xf, ef = x.astype(np.float32), e.astype(np.float32)
    if mode == "u8x4":
        assert np.array_equal(_bits(_u8x4(xf, ef)), _bits(y))
    elif mode == "bf16":
        got = mx.onehot_mma_ref(torch.from_numpy(xf), torch.from_numpy(ef),
                                "bf16")
        assert np.array_equal(_bits(got.numpy()), _bits(y))
    else:
        _tf32_close(xf, ef, y)


def test_p7_main(monkeypatch, capsys):
    seen = _capture(monkeypatch, P7)
    P7.main()
    assert "f32 payload selection bit-exact: True" in capsys.readouterr().out
    (x, E), y = seen[0]
    px, pE = mx.p7_inputs()
    assert np.array_equal(_bits(x), _bits(px)) and np.array_equal(E, pE)
    assert (x == np.float32(mx.CLAMP)).any()
    got = _u8x4(x, E)
    assert np.array_equal(_bits(got), _bits(y))
    assert np.array_equal(_bits(got), _bits(x[:, np.arange(512) // 4]))
    _tf32_close(x, E, y)


def _np_round_tf32(a):
    """Bit-level TF32 rounding in numpy: add half an ulp of the 10-bit
    mantissa to the magnitude and clear the low 13 bits (ties away from
    zero); infinities stay, NaNs stay NaN with the quiet bit set."""
    b = a.view(np.uint32).astype(np.uint64)
    special = (b & 0x7F800000) == 0x7F800000
    nan = special & ((b & 0x7FFFFF) != 0)
    out = np.where(special, np.where(nan, (b | 0x400000) & 0xFFFFE000, b),
                   (b + 0x1000) & 0xFFFFE000)
    return out.astype(np.uint32).view(np.float32)


def test_round_tf32_matches_numpy():
    ulp = 2.0 ** -10
    special = np.array(
        [1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
         1 + 1.5 * ulp, 0.0, -0.0, np.inf, -np.inf, np.nan,
         np.finfo(np.float32).max, -np.finfo(np.float32).max,
         np.float32(mx.CLAMP), 1e-45, 65535.0], np.float32)
    tricky = np.array([0x7F800001, 0xFFC00001, 0x00001000, 0x00000FFF],
                      np.uint32).view(np.float32)
    rand = np.random.default_rng(0).standard_normal(10000).astype(
        np.float32) * np.float32(1e3)
    a = np.concatenate([special, tricky, rand])
    got = mx.round_tf32(torch.from_numpy(a)).numpy()
    assert np.array_equal(_bits(got), _bits(_np_round_tf32(a)))
    # ties go away from zero; the largest finite values round to infinity
    assert got[0] == 1 + ulp and got[1] == -(1 + ulp) and got[2] == 1.0
    assert got[3] == 1 + 2 * ulp
    assert np.isinf(got[9]) and got[9] > 0 and np.isinf(got[10])
    assert np.isnan(got[8]) and np.isnan(got[14]) and np.isnan(got[15])
    # the sentinel is exact; a 16-bit half is not
    assert got[11] == np.float32(mx.CLAMP) and got[13] == 65536.0
    assert _bits(got[16:18]).tolist() == [0x2000, 0]
    assert (np.abs(got[18:] - rand) <= TF32_REL * np.abs(rand)).all()


def test_u8x4_is_the_product_mod_2_32():
    """For any u8 E (not only one-hot) u8x4 is the int64 product of the
    unsigned 32-bit words masked to 32 bits."""
    rng = np.random.default_rng(3)
    x = rng.integers(-2 ** 31, 2 ** 31, (16, 64), dtype=np.int64).astype(
        np.int32)
    e = rng.integers(0, 256, (64, 32), dtype=np.int64).astype(np.uint8)
    want = ((x.astype(np.int64) & 0xFFFFFFFF) @ e.astype(np.int64)) \
        & 0xFFFFFFFF
    got = mx.onehot_mma_ref(torch.from_numpy(x), torch.from_numpy(e),
                            "u8x4")
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.astype(np.uint32))


@pytest.mark.parametrize("mode", mx.MODES)
def test_cpu_tensors_take_the_plain_path(mode):
    x, E = mx.p7_inputs()
    xt, et = mx.mode_inputs(x[:32], E, mode, "cpu")
    launches = dict(mx.LAUNCHES)
    got = mx.onehot_mma(xt, et, mode, copies=2)
    want = mx.onehot_mma_ref(xt, et, mode)
    assert got.shape == (2, 32, 512)
    assert all(torch.equal(g, want) for g in got)
    assert mx.LAUNCHES == launches


@pytest.mark.parametrize("mode", mx.MODES)
def test_unsupported_device_raises(mode):
    x = torch.empty((32, 128), dtype=torch.float32, device="meta")
    e = torch.empty((128, 512), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        mx.onehot_mma(x, e, mode)
    with pytest.raises(ValueError, match="unknown mode"):
        mx.onehot_mma(x, e, "fp8")


@pytest.mark.parametrize("M,K,N,copies,ok", [
    (256, 128, 512, 256, True),  # P5, P6's first three, P7 at 512 copies
    (320, 128, 512, 512, True),
    *((r, k, n, 256, True) for r, k, n, _, _ in mx.P6_POINTS[3:]),
    (32, 128, 512, 1, False), (100, 128, 512, 1, False),
    (0, 128, 512, 1, False), (256, 16, 512, 1, False),
    (256, 48, 512, 1, False), (256, 1024, 512, 1, False),
    (256, 128, 16, 1, False), (256, 128, 48, 1, False),
    (256, 128, 512, 0, False)])
def test_shape_rule(M, K, N, copies, ok):
    """The kernel's shape rule, which the wrapper checks before a launch:
    every P5, P6 and P7 point passes; each bad M, K, N or copy count
    raises."""
    if ok:
        mx.check_shape(M, K, N, copies)
    else:
        with pytest.raises(ValueError, match="onehot_mma takes"):
            mx.check_shape(M, K, N, copies)
