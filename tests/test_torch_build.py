"""The kernels' build tag (``kernels/build.py``): a library is named by a
hash of its source, of every header the source includes from its own
directory, and of the flags, so that an edited header rebuilds it instead
of loading a stale library.  Nothing is compiled here."""
import pathlib

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ops as sops

CSRC = pathlib.Path(sops.SOURCE).parent


def test_both_ssd_sources_include_the_shared_tf32_header():
    for source in (sops.SOURCE, sops.BWD_SOURCE):
        assert build.local_headers(source) == [CSRC / "tf32x3.cuh"], source


def test_the_tag_follows_a_local_header(tmp_path):
    """Editing a header the source includes (directly or through another
    local header) changes the tag; a file it does not include, a system
    header's name or the same text again do not."""
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda.h>\n#include "a.cuh"\n'
                   '  #  include "missing.cuh"\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define A 1\n")
    (tmp_path / "other.cuh").write_text("#define B 1\n")
    assert build.local_headers(src) == [tmp_path / "a.cuh",
                                        tmp_path / "b.cuh"]
    tag = build.source_tag(src)
    assert build.source_tag(src) == tag
    (tmp_path / "other.cuh").write_text("#define B 2\n")
    assert build.source_tag(src) == tag
    (tmp_path / "b.cuh").write_text("#define A 2\n")
    changed = build.source_tag(src)
    assert changed != tag
    (tmp_path / "a.cuh").write_text('#pragma once  \n#include "b.cuh"\n')
    assert build.source_tag(src) not in (tag, changed)


def test_the_library_file_follows_a_local_header(tmp_path):
    """CudaLibrary names its shared library by the tag: an edited header
    gives another file, so a stale library is never loaded (nothing is
    built here: the name alone)."""
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("#define A 1\n")
    lib = build.CudaLibrary(src, "k", lambda lib: None)
    before = lib.path
    assert before.parent == build.BUILD_DIR
    assert before.name == f"libk_{build.source_tag(src)}.so"
    (tmp_path / "h.cuh").write_text("#define A 2\n")
    assert lib.path != before
