"""PyTorch port: ``ops/cuda_build.py`` names each kernel library by a
digest of what goes into it, so that a stale library is never loaded: the
source, every header beside it and the compiler's flags.

Nothing here runs ``nvcc``: the library's path is computed from the files.
"""

from __future__ import annotations

import os

import pytest

from bikg_graph_explainability_public_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source and a header it includes in a temporary ``csrc/``, and a
    temporary build directory."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "walk.cuh").write_text("// the shared walk\n")
    (src / "a.cu").write_text('#include "walk.cuh"\nextern "C" int a() { return 0; }\n')
    (src / "b.cu").write_text('extern "C" int b() { return 0; }\n')
    monkeypatch.setattr(cuda_build, "CSRC", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    return src


@pytest.mark.parametrize("edited,changes", [
    ("walk.cuh", True),   # a header alone: every library of csrc/ builds anew
    ("a.cu", True),
    ("b.cu", False),      # another source: this library stays
    (None, False),
])
def test_library_path_follows_its_source_and_headers(csrc, edited, changes):
    lib = cuda_build.Library("a.cu")
    before = lib._so_path()
    assert os.path.dirname(before) == cuda_build.BUILD_DIR
    assert os.path.basename(before).startswith("liba_") and before.endswith(".so")
    if edited is not None:
        with open(csrc / edited, "a") as f:
            f.write("// edited\n")
    assert (lib._so_path() != before) is changes


def test_a_new_header_changes_the_path(csrc):
    lib = cuda_build.Library("b.cu")
    before = lib._so_path()
    (csrc / "other.cuh").write_text("// another header\n")
    assert lib._so_path() != before


def test_flags_change_the_path(csrc, monkeypatch):
    lib = cuda_build.Library("a.cu")
    before = lib._so_path()
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ["-lineinfo"])
    assert lib._so_path() != before
