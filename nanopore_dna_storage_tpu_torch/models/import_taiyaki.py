"""Import an R9.4.1 flip-flop basecaller from taiyaki/guppy JSON.

The reference's pretrained weights are git-LFS blobs absent from this
mount (flappie/src/models/*.h -> *.mdl, networks.c:10-12), so real-signal
decode is blocked on obtaining a model. Openly licensed R9.4.1 flip-flop
models exist in taiyaki's JSON dump format (guppy `.jsn`, produced by
taiyaki's json dump of a flip-flop network; the reference's own converter
consumes the equivalent sloika pickle, flappie/misc/parse_flipflop_guppy.py).
This module converts that JSON tree into the parameter dict used by
models/flipflop.py, so the day a real model file is available the whole
pipeline (fast5 -> basecall -> posteriors -> list-Viterbi) runs real reads
unchanged.

Expected tree (taiyaki json dump of the guppy flip-flop architecture,
mirroring parse_flipflop_guppy.py's sublayer order):

    {"sublayers": [
        {"type": "convolution", "params": {"W": ..., "b": ...},
         "stride": 2, "winlen": 19, "insize": 1, "size": 256},
        {"type": "reverse", "sublayers": [{"type": "GruMod",
         "params": {"iW": ..., "sW": ..., "b": ...}}]},
        {"type": "GruMod", "params": {...}},          # forward
        ... (B/F/B/F/B, 5 GRU layers total) ...,
        {"type": "GlobalNormTwoState", "params": {"W": ..., "b": ...}}]}

Orientation notes (validated by the round-trip tests; real files may use
either convention, so matrices are auto-oriented by shape):

* conv W: (nfilter, insize, winlen) as in the sloika pickle
  (parse_flipflop_guppy.py:88-90) -> ours (winlen, insize, nfilter).
* GruMod iW: (3h, insize) -> ours (insize, 3h); sW: (3h, h) -> (h, 3h).
  Gate order within 3h must be guppy's z|r|h (grumod_step,
  layers.c:648-699) — no reordering is applied.
* FF W: (40, insize) -> (insize, 40).

The port's own copy of ``nanopore_dna_storage_tpu/models/import_taiyaki.py`` (numpy only,
unchanged), so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

NSTATE_OUT = 40


def _arr(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _orient(w: np.ndarray, in_dim: int, out_dim: int) -> np.ndarray:
    """Return w as (in_dim, out_dim), transposing if it arrives
    (out_dim, in_dim). Ambiguous square case: assume already ours."""
    if w.shape == (in_dim, out_dim):
        return w
    if w.shape == (out_dim, in_dim):
        return np.ascontiguousarray(w.T)
    raise ValueError(f"matrix shape {w.shape} matches neither "
                     f"({in_dim},{out_dim}) nor ({out_dim},{in_dim})")


def _flatten_layers(tree) -> list:
    """Depth-first layer list with reverse-wrapping recorded."""
    out = []

    def walk(node, reverse=False):
        t = node.get("type", "").lower()
        if t in ("serial", "sequential"):
            for sub in node["sublayers"]:
                walk(sub, reverse)
        elif t == "reverse":
            subs = node.get("sublayers") or [node["sublayer"]]
            for sub in subs:
                walk(sub, True)
        else:
            out.append((t, reverse, node))

    walk(tree)
    return out


def params_from_taiyaki_json(path: str
                             ) -> Tuple[Dict[str, np.ndarray], int, tuple]:
    """Parse a taiyaki/guppy JSON flip-flop model.

    Returns (params, stride, layer_dirs) for models/flipflop.py:
    params holds conv_w (winlen, insize, nf), conv_b, gru{i}_iw/_sw/_b
    and ff_w/ff_b; layer_dirs is the "b"/"f" tuple in network order.
    """
    with open(path) as f:
        tree = json.load(f)
    layers = _flatten_layers(tree)

    conv = next(x for x in layers if x[0] == "convolution")
    grus = [x for x in layers if x[0] in ("grumod", "gru_mod", "gru")]
    ff = next(x for x in layers if "norm" in x[0] or x[0] in
              ("globalnormtwostate", "globalnormflipflop", "feedforward"))
    if len(grus) != 5:
        raise ValueError(f"expected 5 GRU layers, found {len(grus)}")

    p: Dict[str, np.ndarray] = {}
    cp = conv[2]["params"]
    w = _arr(cp["W"])
    if w.ndim != 3:
        raise ValueError(f"conv W must be 3-D, got {w.shape}")
    nf = len(_arr(cp["b"]).reshape(-1))
    # (nfilter, insize, winlen) -> (winlen, insize, nfilter)
    if w.shape[0] == nf:
        w = np.transpose(w, (2, 1, 0))
    elif w.shape[2] != nf:
        raise ValueError(f"conv W {w.shape} inconsistent with {nf} filters")
    p["conv_w"] = np.ascontiguousarray(w)
    p["conv_b"] = _arr(cp["b"]).reshape(-1)

    h = None
    dirs = []
    for i, (_, rev, node) in enumerate(grus):
        gp = node["params"]
        b = _arr(gp["b"]).reshape(-1)
        if h is None:
            h = b.size // 3
        if b.size != 3 * h:
            raise ValueError(f"gru{i} bias size {b.size} != 3h")
        insize = w.shape[2] if i == 0 else h
        p[f"gru{i}_iw"] = _orient(_arr(gp["iW"]), insize, 3 * h)
        p[f"gru{i}_sw"] = _orient(_arr(gp["sW"]), h, 3 * h)
        p[f"gru{i}_b"] = b
        dirs.append("b" if rev else "f")

    fp = ff[2]["params"]
    p["ff_w"] = _orient(_arr(fp["W"]), h, NSTATE_OUT)
    p["ff_b"] = _arr(fp["b"]).reshape(-1)
    stride = int(conv[2].get("stride", 2))
    return p, stride, tuple(dirs)


def write_taiyaki_json(path: str, params: Dict[str, np.ndarray],
                       stride: int = 2,
                       layer_dirs=("b", "f", "b", "f", "b")) -> None:
    """Emit the taiyaki-style JSON tree for ``params`` (round-trip
    testing, and exporting trained hermetic models in an interchange
    format)."""
    conv_w = np.asarray(params["conv_w"])  # (winlen, insize, nf)
    tree = {"type": "serial", "sublayers": []}
    tree["sublayers"].append({
        "type": "convolution", "stride": stride,
        "winlen": int(conv_w.shape[0]), "insize": int(conv_w.shape[1]),
        "size": int(conv_w.shape[2]),
        "params": {"W": np.transpose(conv_w, (2, 1, 0)).tolist(),
                   "b": np.asarray(params["conv_b"]).tolist()}})
    for i, d in enumerate(layer_dirs):
        layer = {"type": "GruMod", "params": {
            "iW": np.asarray(params[f"gru{i}_iw"]).T.tolist(),
            "sW": np.asarray(params[f"gru{i}_sw"]).T.tolist(),
            "b": np.asarray(params[f"gru{i}_b"]).tolist()}}
        if d == "b":
            layer = {"type": "reverse", "sublayers": [layer]}
        tree["sublayers"].append(layer)
    tree["sublayers"].append({
        "type": "GlobalNormTwoState", "params": {
            "W": np.asarray(params["ff_w"]).T.tolist(),
            "b": np.asarray(params["ff_b"]).tolist()}})
    with open(path, "w") as f:
        json.dump(tree, f)
