"""Basecaller weight loading: flappie ``.mdl`` model-header parser.

The reference ships pretrained guppy flip-flop weights as generated C headers
(git-LFS blobs symlinked to flappie/src/models/*.h; format produced by
flappie/misc/parse_flipflop_guppy.py: ``float __NAME[] = {hex floats};``
followed by a ``_Mat _NAME`` struct with nr/nrq/nc/stride). This module
parses that format into the jnp parameter dict used by models/flipflop.py —
so a user who obtains the real .mdl files (they are LFS pointers in this
mount) can run the actual production basecaller. A synthetic round-trip test
covers the parser.

flappie matrices are column-major with rows padded to nrq*4; a parsed matrix
[nc, nrq*4] trims to [nc, nr] and transposes to the (nr, nc) math layout,
which matches this package's ``x @ W`` convention directly
(affine_map computes W^T x, flappie_matrix.c:361-441).

The port's own copy of ``nanopore_dna_storage_tpu/models/weights.py`` (numpy only,
unchanged), so that the port imports nothing of the JAX package. Here the
parameter dict holds numpy arrays, which ``models/flipflop.py``
``params_from_numpy`` carries into a ``FlipflopNet``.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

_ARRAY_RE = re.compile(
    r"float\s+__(\w+)\s*\[\]\s*=\s*\{(.*?)\};", re.DOTALL)
_MAT_RE = re.compile(
    r"_Mat\s+_(\w+)\s*=\s*\{\s*\.nr\s*=\s*(\d+)\s*,\s*\.nrq\s*=\s*(\d+)\s*,"
    r"\s*\.nc\s*=\s*(\d+)", re.DOTALL)
# the generator emits `#define conv_<tag>_stride N`
# (parse_flipflop_guppy.py:93); accept an `int ... = N;` form too
_STRIDE_CONST_RE = re.compile(
    r"(?:#define\s+(\w+_stride)\s+(\d+)|int\s+(\w+_stride)\s*=\s*(\d+))")


def parse_model_header(text: str) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Parse a flappie model header into {name: (nr, nc) float32}, plus any
    integer constants (e.g. conv stride)."""
    arrays: Dict[str, np.ndarray] = {}
    for m in _ARRAY_RE.finditer(text):
        vals = [float.fromhex(v.strip()) if "p" in v or "x" in v
                else float(v.strip())
                for v in m.group(2).replace("\n", " ").split(",")
                if v.strip()]
        arrays[m.group(1)] = np.asarray(vals, dtype=np.float32)
    mats: Dict[str, np.ndarray] = {}
    for m in _MAT_RE.finditer(text):
        name, nr, nrq, nc = m.group(1), *map(int, m.groups()[1:])
        flat = arrays[name]
        padded = nrq * 4
        mat = flat.reshape(nc, padded)[:, :nr].T  # column-major -> (nr, nc)
        mats[name] = np.ascontiguousarray(mat)
    consts = {}
    for m in _STRIDE_CONST_RE.finditer(text):
        name = m.group(1) or m.group(3)
        consts[name] = int(m.group(2) or m.group(4))
    return mats, consts


def params_from_header(path: str, model_id: str = "r941native"):
    """Load a flappie .h/.mdl model into the flipflop param dict.

    Layer order B1 F2 B3 F4 B5 maps to gru0..gru4 (networks.c:158-187).
    """
    with open(path) as f:
        mats, consts = parse_model_header(f.read())
    tag = f"rnnrf_flipflop_{model_id}"
    p = {}
    # conv W is stored tap-padded: each tap's `insize` input rows are padded
    # to the input matrix's SSE stride ldX = 4*ceil(insize/4), so
    # nr = (winlen-1)*ldX + insize (parse_flipflop_guppy.py:91 emits
    # nr = winlen*4 - 3 for insize=1; convolution() indexes taps by
    # ldFeature = ldX, layers.c:204-208).
    conv_raw = mats[f"conv_{tag}_W"]  # (nr, nfilter)
    insize = consts.get(f"conv_{tag}_insize", 1)
    ldx = 4 * (-(-insize // 4))
    winlen = (conv_raw.shape[0] - insize) // ldx + 1
    nf = conv_raw.shape[1]
    padded = np.zeros((winlen * ldx, nf), conv_raw.dtype)
    padded[: conv_raw.shape[0]] = conv_raw
    p["conv_w"] = np.ascontiguousarray(
        padded.reshape(winlen, ldx, nf)[:, :insize, :])
    p["conv_b"] = mats[f"conv_{tag}_b"].reshape(-1)
    for i, lname in enumerate(["gruB1", "gruF2", "gruB3", "gruF4", "gruB5"]):
        p[f"gru{i}_iw"] = mats[f"{lname}_{tag}_iW"]
        p[f"gru{i}_sw"] = mats[f"{lname}_{tag}_sW"]
        p[f"gru{i}_b"] = mats[f"{lname}_{tag}_b"].reshape(-1)
    p["ff_w"] = mats[f"FF_{tag}_W"]
    p["ff_b"] = mats[f"FF_{tag}_b"].reshape(-1)
    stride = consts.get(f"conv_{tag}_stride", 2)
    return p, stride


def write_model_header(path: str, params: Dict[str, np.ndarray],
                       model_id: str = "r941native", stride: int = 2) -> None:
    """Emit a flappie-format model header (for round-trip tests and for
    exporting weights back to the reference toolchain)."""
    tag = f"rnnrf_flipflop_{model_id}"

    def fmt_mat(f, name: str, x: np.ndarray) -> None:
        # x: (nr, nc) math layout -> column-major padded text
        nr, nc = x.shape
        nrq = -(-nr // 4)
        pad = nrq * 4 - nr
        cols = []
        for c in range(nc):
            vals = [float(v).hex() for v in x[:, c]] + ["0x0p+0"] * pad
            cols.append(", ".join(vals))
        f.write(f"float __{name}[] = {{\n\t" + ",\n\t".join(cols) + "};\n")
        f.write(f"_Mat _{name} = {{\n\t.nr = {nr},\n\t.nrq = {nrq},"
                f"\n\t.nc = {nc},\n\t.stride = {nrq * 4},"
                f"\n\t.data.f = __{name}\n}};\n\n")

    with open(path, "w") as f:
        f.write(f"#define conv_{tag}_stride {stride}\n")
        conv_w = np.asarray(params["conv_w"])  # (winlen, insize, nf)
        winlen, insize, nf = conv_w.shape
        ldx = 4 * (-(-insize // 4))
        padded = np.zeros((winlen, ldx, nf), conv_w.dtype)
        padded[:, :insize, :] = conv_w
        nr = (winlen - 1) * ldx + insize
        fmt_mat(f, f"conv_{tag}_W",
                padded.reshape(winlen * ldx, nf)[:nr])
        fmt_mat(f, f"conv_{tag}_b", np.asarray(params["conv_b"])[:, None])
        names = ["gruB1", "gruF2", "gruB3", "gruF4", "gruB5"]
        for i, lname in enumerate(names):
            fmt_mat(f, f"{lname}_{tag}_iW", np.asarray(params[f"gru{i}_iw"]))
            fmt_mat(f, f"{lname}_{tag}_sW", np.asarray(params[f"gru{i}_sw"]))
            fmt_mat(f, f"{lname}_{tag}_b",
                    np.asarray(params[f"gru{i}_b"])[:, None])
        fmt_mat(f, f"FF_{tag}_W", np.asarray(params["ff_w"]))
        fmt_mat(f, f"FF_{tag}_b", np.asarray(params["ff_b"])[:, None])
