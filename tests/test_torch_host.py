"""The port's own copies of the JAX package's numpy host modules, held bit
for bit against their originals on seeded inputs, and a check that no file
of the port imports ``jax``, ``optax`` or the JAX package.

Each test builds one config per package from the same fields (``twin``) and
feeds both the same numpy inputs; outputs are integers or float32 arrays
made by the same numpy calls, so the tolerance is zero.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

from nanopore_dna_storage_tpu import config as jax_config
from nanopore_dna_storage_tpu.coding import conv as jax_conv
from nanopore_dna_storage_tpu.coding import crc as jax_crc
from nanopore_dna_storage_tpu.coding import framing as jax_framing
from nanopore_dna_storage_tpu.coding import rs as jax_rs
from nanopore_dna_storage_tpu.io import post as jax_post
from nanopore_dna_storage_tpu.ops import synthetic as jax_synthetic
from nanopore_dna_storage_tpu.pipeline import encode as jax_encode
from nanopore_dna_storage_tpu.pipeline import experiments as jax_experiments
from nanopore_dna_storage_tpu.signal import channel as jax_channel
from nanopore_dna_storage_tpu.trellis import tables as jax_tables
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.coding import conv as port_conv
from nanopore_dna_storage_tpu_torch.coding import crc as port_crc
from nanopore_dna_storage_tpu_torch.coding import framing as port_framing
from nanopore_dna_storage_tpu_torch.coding import rs as port_rs
from nanopore_dna_storage_tpu_torch.io import post as port_post
from nanopore_dna_storage_tpu_torch.ops import synthetic as port_synthetic
from nanopore_dna_storage_tpu_torch.pipeline import encode as port_encode
from nanopore_dna_storage_tpu_torch.pipeline import \
    experiments as port_experiments
from nanopore_dna_storage_tpu_torch.signal import channel as port_channel
from nanopore_dna_storage_tpu_torch.trellis import tables as port_tables

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "nanopore_dna_storage_tpu_torch"


def twin(cfg, module):
    """``cfg`` rebuilt field by field as the class of the same name in
    ``module`` (a package's ``config``), nested configs included."""
    kw = {f.name: (twin(v, module) if dataclasses.is_dataclass(v) else v)
          for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}
    return getattr(module, type(cfg).__name__)(**kw)


def _same(a, b, where=""):
    """Dataclass fields, tuples and arrays equal, bit for bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("i", range(13))
def test_experiments_match(i):
    got = port_experiments.experiment(i)
    want = jax_experiments.experiment(i)
    assert twin(got, jax_config) == want
    assert got.msg_len() == want.msg_len()
    size = 17 * got.bytes_per_oligo
    assert got.oligo_counts(size) == want.oligo_counts(size)


CODES = [(6, 1, 30, False), (6, 7, 32, True), (8, 3, 164, True),
         (11, 5, 180, False), (14, 2, 30, True), (14, 4, 40, False)]


@pytest.mark.parametrize("mem,rate,msg_len,rc", CODES)
def test_conv_code_and_tables_match(mem, rate, msg_len, rc):
    cfg = jax_config.ConvCodeConfig(mem=mem, rate=rate, msg_len=msg_len,
                                    rc=rc)
    jc = jax_conv.make_conv_code(cfg)
    pc = port_conv.make_conv_code(twin(cfg, port_config))
    _same(pc, jc)
    # encoding takes the forward code; rc is a property of the decode
    fwd = dataclasses.replace(cfg, rc=False)
    rng = np.random.default_rng(mem * 10 + rate)
    msgs = rng.integers(0, 2, (5, msg_len), dtype=np.uint8)
    bases = port_conv.conv_encode_bases(
        port_conv.make_conv_code(twin(fwd, port_config)), msgs)
    _same(bases, jax_conv.conv_encode_bases(jax_conv.make_conv_code(fwd),
                                            msgs))
    strs = port_conv.bases_to_str(bases)
    assert strs == jax_conv.bases_to_str(bases)
    _same(port_conv.str_to_bases(strs), jax_conv.str_to_bases(strs))
    _same(port_conv.reverse_complement_bases(bases),
          jax_conv.reverse_complement_bases(bases))
    _same(port_conv.termination_bits(pc), jax_conv.termination_bits(jc))
    for dev in (6, 20, None):
        pt = port_tables.build_tables(pc, dev)
        _same(pt, jax_tables.build_tables(jc, dev))
        for nblk in (pt.nstate_pos + 1, 3 * pt.nstate_pos):
            _same(port_tables.beam_schedule(pt, nblk),
                  jax_tables.beam_schedule(jax_tables.build_tables(jc, dev),
                                           nblk))


def test_table_cache_hits_on_an_equal_config():
    cfg = port_config.ConvCodeConfig(mem=6, rate=3, msg_len=36)
    first = port_tables.build_tables(port_conv.make_conv_code(cfg), 7)
    hits = port_tables._build_cached.cache_info().hits
    again = port_tables.build_tables(port_conv.make_conv_code(
        dataclasses.replace(cfg)), 7)
    assert again is first
    assert port_tables._build_cached.cache_info().hits == hits + 1


def test_post_indices_and_crf_mask_match():
    for fn in ("stay_post_index", "move_post_index", "crf_move_mask"):
        _same(getattr(port_tables, fn)(), getattr(jax_tables, fn)(), fn)


def test_crc_matches():
    assert port_crc.crc8(b"123456789") == 0xF4
    data = np.random.default_rng(0).integers(0, 256, (64, 23),
                                             dtype=np.uint8)
    _same(port_crc.crc8_batch(data), jax_crc.crc8_batch(data))
    _same(port_crc.crc8_table(), jax_crc.crc8_table())
    assert [port_crc.crc8(r.tobytes()) for r in data] == \
        [jax_crc.crc8(r.tobytes()) for r in data]


@pytest.mark.parametrize("pad", [False, True])
def test_framing_matches(pad):
    f = jax_config.FramingConfig()
    pf = twin(f, port_config)
    rng = np.random.default_rng(int(pad))
    payloads = rng.integers(0, 256, (40, 6), dtype=np.uint8)
    msgs = port_framing.frame_oligos(payloads, pf, pad=pad)
    _same(msgs, jax_framing.frame_oligos(payloads, f, pad=pad))
    # every message, then copies with a few bits flipped: some fail the CRC
    flip = (rng.random((3,) + msgs.shape) < 0.01).astype(np.uint8)
    cands = np.concatenate([msgs[None], msgs[None] ^ flip])
    ok, index = port_framing.check_and_extract(cands, pf, 30, pad=pad)
    ok_j, index_j = jax_framing.check_and_extract(cands, f, 30, pad=pad)
    _same((ok, index), (ok_j, index_j))
    assert ok[0, :30].all() and not ok[0, 30:].any() and not ok[1:].all()
    _same(port_framing.extract_payload(cands, pf, 6, pad=pad),
          jax_framing.extract_payload(cands, f, 6, pad=pad))


@pytest.mark.parametrize("lost", [0, 3, 6, 7])
def test_rs_matches(lost):
    """RS encode, then decode with ``lost`` oligos erased (6 parity oligos:
    7 erasures cannot be repaired, and both packages say so)."""
    rng = np.random.default_rng(lost)
    payloads = rng.integers(0, 256, (12, 8), dtype=np.uint8)
    coded = port_rs.rs_encode_oligos(payloads, 6)
    _same(coded, jax_rs.rs_encode_oligos(payloads, 6))
    keep = np.sort(rng.permutation(18)[lost:])
    got = port_rs.rs_decode_oligos(keep, coded[keep], 6, 18)
    _same(got, jax_rs.rs_decode_oligos(keep, coded[keep], 6, 18))
    assert got[0] == (lost <= 6)
    if lost <= 6:
        _same(got[1], payloads)


@pytest.mark.parametrize("rc", [False, True])
def test_synthetic_post_and_channel_match(rc):
    bases = np.random.default_rng(7).integers(0, 4, 150).astype(np.uint8)
    got, want = (np.random.default_rng(8) for _ in range(2))
    for _ in range(3):
        noisy = port_channel.simulate_indelsubs(bases, got, 0.02, 0.03, 0.01)
        _same(noisy, jax_channel.simulate_indelsubs(bases, want, 0.02, 0.03,
                                                    0.01))
        _same(port_synthetic.synthetic_post(noisy, got, rc=rc, noise=1.1),
              jax_synthetic.synthetic_post(noisy, want, rc=rc, noise=1.1))
    posts = [port_synthetic.synthetic_post(bases[:n], got) for n in (40, 90)]
    _same(port_post.pack_posts(posts), jax_post.pack_posts(posts))


@pytest.mark.parametrize("exp_id", [0, 7, 12])
def test_encode_bytes_matches(exp_id):
    data = np.random.default_rng(exp_id).integers(0, 256, 100,
                                                  dtype=np.uint8).tobytes()
    _same(port_encode.encode_bytes(data, port_experiments.experiment(exp_id)),
          jax_encode.encode_bytes(data, jax_experiments.experiment(exp_id)))


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "optax", "nanopore_dna_storage_tpu"))


def _imports(path: pathlib.Path):
    """Absolute module names that ``path`` imports, with their lines."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((a.name, node.lineno) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno


def test_forbidden_matches_by_name_or_dotted_prefix():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("optax") and _forbidden("optax.schedules")
    assert _forbidden("nanopore_dna_storage_tpu.coding.conv")
    assert not _forbidden("jaxlib_free") and not _forbidden("numpy")
    assert not _forbidden("nanopore_dna_storage_tpu_torch.coding.conv")


# modules of the port the guards below must reach, in every subpackage
PORT_MODULES = ("cli.py", "coding/conv.py", "io/fast5.py", "io/lists.py",
                "models/flipflop.py", "models/train.py",
                "native/__init__.py", "ops/lva.py", "ops/vocab.py",
                "parallel/mesh.py", "pipeline/data_prep.py",
                "pipeline/real_data.py", "pipeline/simulate.py",
                "probes/expand.py", "signal/barcode.py", "trellis/tables.py",
                "utils/profiling.py")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    walked = {f.relative_to(PORT).as_posix() for f in files
              if PORT in f.parents}
    assert set(PORT_MODULES) <= walked, set(PORT_MODULES) - walked
    return files


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {name}"
           for f in files for name, line in _imports(f) if _forbidden(name)]
    assert not bad, bad


def _module_level(nodes):
    """Import statements run when a module is imported: those outside
    function and class bodies."""
    for node in nodes:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
            yield from _module_level(ast.iter_child_nodes(node))


def test_port_imports_h5py_only_inside_functions():
    """The card's machine has no h5py: importing any module of the port
    (the CLI and ``pipeline/real_data.py`` among them) must not need it."""
    bad = []
    for f in _port_files():
        for node in _module_level(ast.parse(f.read_text()).body):
            names = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""]
            bad += [f"{f.relative_to(ROOT)}:{node.lineno}" for n in names
                    if n == "h5py" or n.startswith("h5py.")]
    assert not bad, bad
