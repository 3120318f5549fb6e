"""Build the port's CUDA kernels with nvcc at first use and bind them with
ctypes.

The sources in ``csrc/`` have a plain C interface, so one ``nvcc`` call per
library builds them in seconds without PyTorch's headers. The output goes to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
or, for an installed package, to ``~/.cache/nanopore_dna_storage_tpu_torch/
kernels``. Libraries are named by a hash of the sources, the headers in
``csrc/`` and the flags, so an edited source or header rebuilds and an
unchanged one loads the library already built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> pathlib.Path:
    root = pathlib.Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():  # running from the checkout
        return root / "build" / "kernels"
    return (pathlib.Path.home() / ".cache" / "nanopore_dna_storage_tpu_torch"
            / "kernels")


BUILD_DIR = _build_dir()

# --fmad=false: every score is a single f32 add, prev + transition, in the
# reference's order. The kernel does no multiply on scores, so nvcc has
# nothing to contract into an FMA; the flag keeps it that way if the score
# arithmetic ever grows a product, since bit parity with the reference
# depends on it.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas=-v")

_LIBS: dict = {}


def nvcc() -> str:
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def compiled(compiler: str, flags, paths, out_dir: pathlib.Path,
             stem: str, headers=()) -> pathlib.Path:
    """``paths`` compiled by ``compiler`` with ``flags`` (which end in
    ``-shared``) into ``out_dir/<stem>-<hash>.so``, the hash of the flags,
    the sources and the ``headers`` they include, unless it is there; the
    compiler's output is kept beside it as ``.log``. Raises RuntimeError
    if the compiler fails."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in [*paths, *headers]:
        digest.update(p.read_bytes())
    out = out_dir / f"{stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        res = subprocess.run(
            [compiler, *flags, "-o", tmp, *map(str, paths)],
            capture_output=True, text=True, check=False)
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"{pathlib.Path(compiler).name} failed for "
                               f"{stem}:\n{res.stderr}")
        os.replace(tmp, out)  # atomic: two processes building at once both succeed
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str, sources) -> pathlib.Path:
    """Compile ``sources`` (names in ``csrc/``) into ``lib<name>-<hash>.so``
    with nvcc, the headers of ``csrc/`` in the hash; the compiler's output
    is kept beside it as ``.log``."""
    return compiled(nvcc(), NVCC_FLAGS, [CSRC / s for s in sources],
                    BUILD_DIR, f"lib{name}", sorted(CSRC.glob("*.cuh")))


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's wrapper checks before it passes a pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _load_step(name: str) -> ctypes.CDLL:
    """An ACS block-step library ``csrc/<name>.cu``, built on first call;
    both have the same C interface under the prefix ``name``."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build(name, [f"{name}.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        launch, info, error_string = (getattr(lib, f"{name}_{x}") for x in
                                      ("launch", "info", "error_string"))
        # 16 pointers (buffers, selections, transitions, start1, active,
        # tables), then B, P, L, C, W and the CUDA stream
        launch.argtypes = [p] * 16 + [i] * 5 + [p]
        launch.restype = i
        # L, and where registers, local bytes and threads per SM go
        info.argtypes = [i, ctypes.POINTER(i)]
        info.restype = i
        error_string.argtypes = [i]
        error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def load_lva_acs() -> ctypes.CDLL:
    """The K-way ACS kernel library (``csrc/lva_acs.cu``), built on first
    call."""
    return _load_step("lva_acs")


def load_lva_lse() -> ctypes.CDLL:
    """The logsumexp ACS kernel library (``csrc/lva_lse.cu``), built on
    first call."""
    return _load_step("lva_lse")


def load_lva_traceback() -> ctypes.CDLL:
    """The selection traceback kernel library (``csrc/lva_traceback.cu``),
    built on first call."""
    if "lva_traceback" not in _LIBS:
        lib = ctypes.CDLL(str(build("lva_traceback", ["lva_traceback.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        # 11 pointers (sels, starts, nblks, tlo, thi, qmap, pattern, nbits,
        # cstar, words, okend), then B, T, W, L, C, P, Mw, the last row, the
        # initial and final conv states, and the CUDA stream
        lib.lva_traceback_launch.argtypes = [p] * 11 + [i] * 10 + [p]
        lib.lva_traceback_launch.restype = i
        # L, Mw, and where registers, local bytes, threads per SM and the
        # starts' shared-memory limit go
        lib.lva_traceback_info.argtypes = [i, i, ctypes.POINTER(i)]
        lib.lva_traceback_info.restype = i
        # the hop table, the hops, where the chase ends, the CUDA stream
        lib.lva_traceback_round_trip.argtypes = [p, ctypes.c_int64, p, p]
        lib.lva_traceback_round_trip.restype = i
        lib.lva_traceback_error_string.argtypes = [i]
        lib.lva_traceback_error_string.restype = ctypes.c_char_p
        _LIBS["lva_traceback"] = lib
    return _LIBS["lva_traceback"]


def load_probes() -> ctypes.CDLL:
    """The merge-family probe kernels (``csrc/probes.cu``), built on first
    call."""
    if "probes" not in _LIBS:
        lib = ctypes.CDLL(str(build("probes", ["probes.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.probe_merge_launch, lib.probe_stream_launch):
            # x, h1, h2, out, then nc, ncol, rounds, copies and the stream
            fn.argtypes = [p] * 4 + [i] * 4 + [p]
        # where registers, local bytes and threads per SM go (the stream's
        # after whether its rounds are unrolled)
        lib.probe_merge_info.argtypes = [ctypes.POINTER(i)]
        lib.probe_stream_info.argtypes = [i, ctypes.POINTER(i)]
        # kind, in, out, blocks, iterations and the stream
        lib.probe_issue_launch.argtypes = [i, p, p, i, i, p]
        for fn in (lib.probe_merge_launch, lib.probe_stream_launch,
                   lib.probe_merge_info, lib.probe_stream_info,
                   lib.probe_issue_launch):
            fn.restype = i
        # x, h, out, out_h, then nc, ncol, variant, guarded, lanes and the
        # stream
        lib.probe_treepop_launch.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.probe_treepop_lanes.argtypes = [i]  # ncol
        # variant, lanes, and where registers, local bytes and threads per
        # SM go
        lib.probe_treepop_info.argtypes = [i, i, ctypes.POINTER(i)]
        for fn in (lib.probe_treepop_launch, lib.probe_treepop_lanes,
                   lib.probe_treepop_info):
            fn.restype = i
        lib.probe_error_string.argtypes = [i]
        lib.probe_error_string.restype = ctypes.c_char_p
        _LIBS["probes"] = lib
    return _LIBS["probes"]


def load_expand() -> ctypes.CDLL:
    """The lane-map and transpose probe kernels (``csrc/expand.cu``), built
    on first call."""
    if "expand" not in _LIBS:
        lib = ctypes.CDLL(str(build("expand", ["expand.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, y, then form, map, p, cin, rout, cout, copies, then masks, the
        # host shift array, nst, tile_start and the stream
        lib.expand_lane_map_launch.argtypes = (
            [p, p] + [i] * 7 + [p, ctypes.POINTER(i), i, i, p])
        lib.expand_lane_map_launch.restype = i
        # x, y, then R, C, copies, the tile's rows, 16-byte accesses (0 or
        # 1) and the stream
        lib.expand_transpose_launch.argtypes = [p, p, i, i, i, i, i, p]
        lib.expand_transpose_launch.restype = i
        lib.expand_error_string.argtypes = [i]
        lib.expand_error_string.restype = ctypes.c_char_p
        _LIBS["expand"] = lib
    return _LIBS["expand"]


def load_mxu_expand() -> ctypes.CDLL:
    """The one-hot tensor-core product (``csrc/mxu_expand.cu``), built on
    first call."""
    if "mxu_expand" not in _LIBS:
        lib = ctypes.CDLL(str(build("mxu_expand", ["mxu_expand.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, e, y, then mode, M, K, N, copies and the stream
        lib.mxu_onehot_launch.argtypes = [p, p, p] + [i] * 5 + [p]
        lib.mxu_onehot_launch.restype = i
        lib.mxu_error_string.argtypes = [i]
        lib.mxu_error_string.restype = ctypes.c_char_p
        _LIBS["mxu_expand"] = lib
    return _LIBS["mxu_expand"]


def load_lowering() -> ctypes.CDLL:
    """The lowering probe kernels (``csrc/lowering.cu``), built on first
    call."""
    if "lowering" not in _LIBS:
        lib = ctypes.CDLL(str(build("lowering", ["lowering.cu"])))
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # x, idx, y, then P, C and the stream
        lib.lowering_dynrow_launch.argtypes = [p, p, p, i, i, p]
        # x, y, n and the stream (int16 and the reshape's copy)
        for fn in (lib.lowering_int16_launch, lib.lowering_copy_launch):
            fn.argtypes = [p, p, n, p]
        # x, h, out, then placement, nq, ncol, rounds, copies, lanes (0:
        # the launcher's), the threads per SM (0: one per item), the zero
        # and the stream
        lib.lowering_fori_launch.argtypes = (
            [p, p, p] + [i] * 7 + [ctypes.c_float, p])
        lib.lowering_fori_lanes.argtypes = [n]  # items
        # placement, nq, lanes, and where registers, local bytes and
        # resident threads per SM go
        lib.lowering_fori_info.argtypes = [i, i, i, ctypes.POINTER(i)]
        # stale, x, s, then P, W, row and the stream
        lib.lowering_alias_launch.argtypes = [p, p, p, i, i, i, p]
        # blocks, threads a block and the stream
        lib.lowering_empty_launch.argtypes = [i, i, p]
        for fn in (lib.lowering_dynrow_launch, lib.lowering_int16_launch,
                   lib.lowering_copy_launch, lib.lowering_fori_launch,
                   lib.lowering_fori_lanes, lib.lowering_fori_info,
                   lib.lowering_alias_launch, lib.lowering_empty_launch):
            fn.restype = i
        lib.lowering_error_string.argtypes = [i]
        lib.lowering_error_string.restype = ctypes.c_char_p
        _LIBS["lowering"] = lib
    return _LIBS["lowering"]
