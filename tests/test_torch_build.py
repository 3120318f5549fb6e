"""The kernel build's naming: a library is named by a hash of its flags,
its sources and the headers they include, so that editing a header that two
kernels share rebuilds both (``ops/_build.py`` ``compiled``). Runs on the
CPU with ``true`` in place of the compiler."""
from __future__ import annotations

import shutil

import pytest

from nanopore_dna_storage_tpu_torch.ops import _build

TRUE = shutil.which("true")


@pytest.mark.skipif(TRUE is None, reason="no `true` executable")
@pytest.mark.parametrize("edit", ["source", "header", "flags", "nothing"])
def test_library_name_follows_sources_headers_and_flags(tmp_path, edit):
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    hdr.write_text("// shared\n")
    out = tmp_path / "out"
    first = _build.compiled(TRUE, ("-O3",), [src], out, "libk", [hdr])
    assert first.exists() and first.with_suffix(".log").exists()
    flags = ("-O3",)
    if edit == "source":
        src.write_text('#include "k.cuh"\n// edited\n')
    elif edit == "header":
        hdr.write_text("// shared, edited\n")
    elif edit == "flags":
        flags = ("-O2",)
    second = _build.compiled(TRUE, flags, [src], out, "libk", [hdr])
    assert (second == first) == (edit == "nothing")
    assert second.exists()


def test_build_hashes_the_csrc_headers():
    """Both ACS kernels include the one shared header, which lies in
    ``csrc/`` where ``build`` looks for the headers it hashes."""
    headers = sorted(_build.CSRC.glob("*.cuh"))
    assert [h.name for h in headers] == ["lva_common.cuh"]
    for name in ("lva_acs.cu", "lva_lse.cu"):
        assert '#include "lva_common.cuh"' in (_build.CSRC / name).read_text()
