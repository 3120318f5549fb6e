"""The selection traceback, ``ops/lva_decode.py`` ``traceback``: one launch of
``csrc/lva_traceback.cu`` for CUDA tensors, ``traceback_ref``'s loop over
the blocks for CPU tensors.

On the CPU: a numpy model of the kernel's walk (each chain on its own,
jumping from each block where it acts straight to the next) bit-equal to
``traceback`` on the cases of ``tests/test_lva_traceback.py`` (and, in
``tests/test_torch_lva_golden.py``, on the fast m=6 goldens); a CPU decode
through the plain loop with no launch counted; the wrapper's checks. On the
card (marker ``card``, skipped without one): the kernel bit-equal to the
plain loop on forward outputs at L in {1, 2, 4, 8, 16, 64} and m in {6, 8,
11}, both orientations, reads of different block counts in each batch,
messages in each word bucket, block counts just under and just over where
the beam starts stop fitting in shared memory, one forward under logsumexp
combining, and three goldens through ``LVADecoder(device="cuda")``, one
launch a decode.
The file imports no JAX, so the card runs it without the suite's
conftest:

    python3 -m pytest tests/test_torch_traceback.py --noconftest -m card -n 0
"""
import ast
import ctypes
import json
import pathlib

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu_torch.coding.conv import (conv_encode_bases,
                                                        make_conv_code)
from nanopore_dna_storage_tpu_torch.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage_tpu_torch.io.post import pack_posts
from nanopore_dna_storage_tpu_torch.ops import lva_decode
from nanopore_dna_storage_tpu_torch.ops._build import load_lva_traceback
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from nanopore_dna_storage_tpu_torch.ops.lva_consts import (NCRF, NQ_MAX,
                                                           DecodeSpec,
                                                           LVAConsts)
from nanopore_dna_storage_tpu_torch.ops.synthetic import synthetic_post
from nanopore_dna_storage_tpu_torch.utils import profiling

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
GOLDEN = HERE / "golden" / "decode"
LAUNCHES = "traceback.launches"


def _literal(path: pathlib.Path, name: str):
    """The literal assigned to ``name`` at the top of ``path``, read from
    its source (``test_lva_traceback.py`` imports the JAX package, which
    this file does not)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError(f"{name} not in {path}")


CASES = _literal(HERE / "test_lva_traceback.py", "CASES")
MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())
CARD_GOLDENS = ["m11_r5_rc0_l8", "m11_r5_rc1_l8", "m8_r1_rc0_l64"]
# (mem, rate, msg_len) a card case decodes at; both orientations at each m
CODES = {6: (1, 30), 8: (1, 48), 11: (5, 60)}
CARD_CASES = [(m, L, i % 2 == 1) for m in CODES
              for i, L in enumerate((1, 2, 4, 8, 16, 64))]
# (msg_len, L) at m=6 r=1/2: messages whose words fill the kernel's 8, 16
# and 32 word buckets (Mw 6, 10 and 19); the last, ~2,100 blocks at 8 chains
# a read, has more beam starts than a block stages in shared memory, so its
# chains read them through the cache
WORD_CASES = ((160, 4), (300, 4), (600, 1))


def _posts(code_cfg, n, rng, rc=False, noise=0.9):
    """``test_lva_traceback._posts`` through the port's copies of the host
    modules: (messages, packed posts, block counts)."""
    code = make_conv_code(code_cfg)
    msgs = rng.integers(0, 2, (n, code_cfg.msg_len), dtype=np.uint8)
    bases = conv_encode_bases(code, msgs)
    if rc:
        bases = [(3 - b)[::-1] for b in bases]
    posts = [synthetic_post(b, rng, noise=noise) for b in bases]
    return msgs, *pack_posts(posts)


def _golden(name):
    """(DecodeConfig, post [T, 5, 8], the reference binary's lists)."""
    case = next(c for c in MANIFEST if c["name"] == name)
    cfg = DecodeConfig(
        code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                            msg_len=case["msg_len"], rc=case["rc"]),
        list_size=case["list_size"], max_deviation=case["max_deviation"])
    post = np.fromfile(GOLDEN / f"{name}.post", dtype="<f4").reshape(-1, 5, 8)
    return cfg, post, (GOLDEN / f"{name}.lists").read_text().split()


def spy_traceback(monkeypatch):
    """``lva_decode.traceback`` replaced by a spy; returns the list it
    appends each call's (arguments, result) to."""
    seen = []
    real = lva_decode.traceback

    def spy(*args):
        out = real(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(lva_decode, "traceback", spy)
    return seen


def _decode_seen(dec, posts, nblks, monkeypatch):
    """Decode with ``dec`` and return its lists and the (arguments, result)
    of its one ``lva_decode.traceback`` call."""
    seen = spy_traceback(monkeypatch)
    lists = dec.decode(posts, nblks)
    assert len(seen) == 1
    return lists, seen[0]


def walk(spec, consts, tabs, sels, starts, nblks, tlo, thi):
    """Numpy model of ``csrc/lva_traceback.cu``: each chain on its own,
    visiting only the blocks where it acts. Arguments and returns as in
    ``lva_decode.traceback``."""
    sels, starts, nblks, tlo, thi = (x.cpu().numpy() for x in
                                     (sels, starts, nblks, tlo, thi))
    qmap, pattern, nbits, cstar = (tabs[k].cpu().numpy() for k in
                                   ("qmap", "pattern", "nbits", "cstar"))
    T, B, W, nch, C = sels.shape
    L, Mw = spec.list_size, spec.n_msg_words
    log2 = 4 if sels.dtype == np.int8 else 6

    def clamp(x, lo, hi):
        return min(max(int(x), lo), hi)

    def lastwrite(b, row, tmax, par):
        x = min(tmax, int(thi[b, row]))
        x -= (x - par) & 1
        return x if x >= tlo[b, row] else -1

    words = np.zeros((B, nch, Mw), np.int64)
    okend = np.zeros((B, nch), bool)
    for b in range(B):
        for ch in range(nch):
            pos, conv = spec.code.nstate_pos, consts.final_state
            f, slot = ch // L, ch % L
            n1 = int(nblks[b]) - 1
            tw = lastwrite(b, pos, n1, n1 & 1)
            tw = -1 if tw >= T else tw
            bitcnt = 0
            while tw >= 0:
                t = tw
                wi = clamp(pos - starts[b, t] - 1, 0, W - 1)
                code = int(sels[t, b, wi, f * L + slot, conv])
                q = clamp(code >> log2, 0, NQ_MAX - 1)
                lsrc = clamp(code & ((1 << log2) - 1), 0, L - 1)
                pat = int(pattern[pos])
                kvar = int(pat != 0)
                if q != 0:
                    nb = int(nbits[kvar, conv])
                    c = clamp(cstar[clamp(pat, 0, 3), f & 3, conv], 0, 3)
                    off, widx = bitcnt & 31, bitcnt >> 5
                    hi = 0 if off == 0 else (nb >> 1) >> (31 - off)
                    for k, v in ((widx, (nb << off) & 0xFFFFFFFF),
                                 (widx + 1, hi)):
                        if k < Mw:
                            words[b, ch, k] |= v
                    bitcnt += 1 + kvar
                    pos, conv, f = pos - 1, ((2 << kvar) * conv + c) % C, \
                        int(qmap[f, q])
                slot = lsrc
                par = (t - 1) & 1
                tw = lastwrite(b, pos, t - 1, par)
                if tw < 0:
                    okend[b, ch] = (par == 1 and pos == 1
                                    and conv == consts.init_state
                                    and lsrc == 0)
    return torch.from_numpy(words), torch.from_numpy(okend)


def same(got, want):
    assert got[0].dtype == want[0].dtype == torch.int64
    assert got[1].dtype == want[1].dtype == torch.bool
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu(), want[1].cpu())


def model_matches(seen):
    """The walk model bit-equal to the one traceback call in ``seen``
    (``spy_traceback``'s), in which some chain ends at the initial state."""
    (args, out), = seen
    assert bool(out[1].any())
    same(walk(*args), out)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_walk_model_matches_traceback(case, monkeypatch):
    rate, rc, L, dev = CASES[case]
    rng = np.random.default_rng(rate * 10 + rc)
    _, packed, nblks = _posts(ConvCodeConfig(mem=6, rate=rate, msg_len=30), 2,
                              rng, rc=rc)
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=6, rate=rate, msg_len=30, rc=rc),
        list_size=L, max_deviation=dev), device="cpu")
    seen = spy_traceback(monkeypatch)
    dec.decode(packed, nblks)
    model_matches(seen)


def test_cpu_decode_takes_the_plain_loop(monkeypatch):
    """A CPU decode runs ``traceback_ref`` once and launches nothing."""
    calls = []
    real = lva_decode.traceback_ref

    def spy(*args):
        calls.append(args[3].device)
        return real(*args)

    monkeypatch.setattr(lva_decode, "traceback_ref", spy)
    before = profiling.counter(LAUNCHES)
    rate, rc, L, dev = CASES[0]
    _, packed, nblks = _posts(ConvCodeConfig(mem=6, rate=rate, msg_len=30), 2,
                              np.random.default_rng(rate * 10 + rc), rc=rc)
    _, _, valid = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=6, rate=rate, msg_len=30, rc=rc),
        list_size=L, max_deviation=dev), device="cpu").decode(packed, nblks)
    assert calls == [torch.device("cpu")]
    assert profiling.counter(LAUNCHES) == before
    assert valid[:, 0].all()


def _meta_args(fault):
    """The traceback's arguments at m=6 L=2 on the meta device, with one
    ``fault``: a wrong dtype, a wrong shape, a tensor on another device
    than the selections, or none (every tensor right, on meta)."""
    cfg = DecodeConfig(code=ConvCodeConfig(mem=6, rate=1, msg_len=30),
                       list_size=2, max_deviation=8)
    spec, tables = DecodeSpec.build(cfg)
    consts = LVAConsts.build(spec, tables)
    tabs = consts.to("meta")
    T, B, P, L = 40, 2, spec.npos_pad, spec.list_size
    meta = dict(device="meta")
    args = {
        "sels": torch.empty((T, B, spec.window, NCRF * L,
                             spec.code.nstate_conv), dtype=torch.int8,
                            **meta),
        "starts": torch.empty((B, T), dtype=torch.int64, **meta),
        "nblks": torch.empty((B,), dtype=torch.int64, **meta),
        "tlo": torch.empty((B, P), dtype=torch.int64, **meta),
        "thi": torch.empty((B, P), dtype=torch.int64, **meta)}
    if fault == "dtype":
        args["starts"] = args["starts"].int()
    elif fault == "shape":
        args["tlo"] = torch.empty((B, P + 1), dtype=torch.int64, **meta)
    elif fault == "device":
        args["nblks"] = torch.full((B,), T, dtype=torch.int64)
    elif fault == "table":
        tabs["qmap"] = tabs["qmap"].long()
    return spec, consts, tabs, args


@pytest.mark.parametrize("fault,match", [
    ("dtype", "starts has dtype"), ("shape", "tlo has shape"),
    ("device", "nblks is on cpu"), ("table", "qmap has dtype"),
    (None, "runs on cpu or cuda, not meta")])
def test_wrapper_raises_before_any_launch(fault, match, monkeypatch):
    def no_launch():
        pytest.fail("the kernel library was loaded")

    monkeypatch.setattr(lva_decode, "load_lva_traceback", no_launch)
    spec, consts, tabs, a = _meta_args(fault)
    before = profiling.counter(LAUNCHES)
    with pytest.raises(ValueError, match=match):
        lva_decode.traceback(spec, consts, tabs, a["sels"], a["starts"],
                             a["nblks"], a["tlo"], a["thi"])
    assert profiling.counter(LAUNCHES) == before


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _kernel_matches_plain(dec, posts, nblks, monkeypatch):
    """Decode on the card; the kernel's result bit-equal to the plain loop
    on the same forward outputs, with one launch counted. Returns the
    decode's lists."""
    before = profiling.counter(LAUNCHES)
    lists, (args, out) = _decode_seen(dec, posts, nblks, monkeypatch)
    assert profiling.counter(LAUNCHES) == before + 1
    assert args[3].is_cuda
    same(out, lva_decode.traceback_ref(*args))
    assert bool(out[1].any())
    return lists


@pytest.mark.card
@pytest.mark.parametrize("m,L,rc", CARD_CASES)
def test_kernel_matches_plain_loop(m, L, rc, monkeypatch):
    need_card()
    rate, msg_len = CODES[m]
    rng = np.random.default_rng(1000 * m + 10 * L + rc)
    _, packed, nblks = _posts(ConvCodeConfig(mem=m, rate=rate,
                                             msg_len=msg_len), 3, rng, rc=rc)
    assert len(set(nblks.tolist())) > 1  # some blocks inactive for some
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=m, rate=rate, msg_len=msg_len, rc=rc),
        list_size=L, max_deviation=8), device="cuda")
    _kernel_matches_plain(dec, packed, nblks, monkeypatch)


@pytest.mark.card
@pytest.mark.parametrize("msg_len,L", WORD_CASES)
def test_kernel_matches_plain_loop_word_buckets(msg_len, L, monkeypatch):
    need_card()
    code = ConvCodeConfig(mem=6, rate=1, msg_len=msg_len)
    _, packed, nblks = _posts(code, 2, np.random.default_rng(msg_len))
    _kernel_matches_plain(LVADecoder(DecodeConfig(
        code=code, list_size=L, max_deviation=8), device="cuda"), packed,
        nblks, monkeypatch)


def _posts_of_length(T, rng_seed):
    """Two reads at m=6 r=1/2 whose longer one has exactly T blocks: the
    first message length, from above, and seed whose longer read falls
    fewer than 10 blocks short of T, its last dwell (a stay) lengthened by
    the blocks left. Returns (the code's config, posts [2, T, 5, 8], block
    counts)."""
    # ~3.5 blocks a base, one base a message bit at rate 1/2
    tries = ((msg_len, seed) for msg_len in range(int(T / 3.5) + 10, 0, -1)
             for seed in range(rng_seed, rng_seed + 4))
    for msg_len, seed in tries:
        code = ConvCodeConfig(mem=6, rate=1, msg_len=msg_len)
        _, packed, nblks = _posts(code, 2, np.random.default_rng(seed))
        if 0 <= T - nblks.max() < 10:
            break
    else:
        pytest.fail(f"no message length gives reads just under {T} blocks")
    i = int(nblks.argmax())
    n = int(nblks[i])
    posts = np.zeros((2, T, 5, 8), np.float32)
    posts[:, :n] = packed[:, :n]
    posts[i, n:] = packed[i, n - 1]
    nblks[i] = T
    return code, posts, nblks


@pytest.mark.card
@pytest.mark.parametrize("over", [0, 1])
def test_kernel_matches_plain_loop_at_the_staging_limit(over, monkeypatch):
    """At L = 1 a block of 64 threads spans at most 9 reads, whose beam
    starts take 36 B a block step in shared memory: the largest T whose
    starts fit beside the kernel's static shared memory (staged), and one
    more (read through the cache)."""
    need_card()
    L, threads = 1, 64
    reads = (threads - 1) // (NCRF * L) + 2
    info = (ctypes.c_int * 4)()
    assert load_lva_traceback().lva_traceback_info(L, 16, info) == 0
    T = info[3] // (4 * reads) + over
    code, posts, nblks = _posts_of_length(T, 4000 + over)
    assert nblks.max() == T and len(set(nblks.tolist())) > 1
    _kernel_matches_plain(LVADecoder(DecodeConfig(
        code=code, list_size=L, max_deviation=16), device="cuda"), posts,
        nblks, monkeypatch)


@pytest.mark.card
def test_kernel_matches_plain_loop_logsumexp(monkeypatch):
    """Selections of ``acs_block_lse`` (int16 codes at L = 64)."""
    need_card()
    rate, msg_len = CODES[8]
    _, packed, nblks = _posts(ConvCodeConfig(mem=8, rate=rate,
                                             msg_len=msg_len), 3,
                              np.random.default_rng(23))
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=8, rate=rate, msg_len=msg_len),
        list_size=64, max_deviation=8, path_combine="logsumexp"),
        device="cuda")
    before = profiling.counter("acs.lse_launches")
    _kernel_matches_plain(dec, packed, nblks, monkeypatch)
    assert profiling.counter("acs.lse_launches") > before


@pytest.mark.card
@pytest.mark.parametrize("name", CARD_GOLDENS)
def test_kernel_on_goldens(name, monkeypatch):
    need_card()
    cfg, post, want = _golden(name)
    msgs, _, valid = _kernel_matches_plain(
        LVADecoder(cfg, device="cuda"), post[None], None, monkeypatch)
    got = ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]
    assert got == want
