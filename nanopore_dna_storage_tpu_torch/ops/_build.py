"""Build the port's CUDA kernels with nvcc at first use and bind them with
ctypes.

The sources in ``csrc/`` have a plain C interface, so one ``nvcc`` call per
library builds them in seconds without PyTorch's headers. The output goes to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
or, for an installed package, to ``~/.cache/nanopore_dna_storage_tpu_torch/
kernels``. Libraries are named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the library already built.
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


def build(name: str, sources) -> pathlib.Path:
    """Compile ``sources`` (names in ``csrc/``) into ``lib<name>-<hash>.so``;
    the compiler's output is kept beside it as ``.log``."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)],
            capture_output=True, text=True, check=False)
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
        os.replace(tmp, out)  # atomic: two processes building at once both succeed
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_lva_acs() -> ctypes.CDLL:
    """The ACS kernel library (``csrc/lva_acs.cu``), built on first call."""
    if "lva_acs" not in _LIBS:
        lib = ctypes.CDLL(str(build("lva_acs", ["lva_acs.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        # 16 pointers (buffers, selections, transitions, start1, active,
        # tables), then B, P, L, C, W and the CUDA stream
        lib.lva_acs_launch.argtypes = [p] * 16 + [i] * 5 + [p]
        lib.lva_acs_launch.restype = i
        lib.lva_acs_error_string.argtypes = [i]
        lib.lva_acs_error_string.restype = ctypes.c_char_p
        _LIBS["lva_acs"] = lib
    return _LIBS["lva_acs"]
