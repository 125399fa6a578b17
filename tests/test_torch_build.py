"""The kernel builder's cache key (kernels/_build.py): a library is named
by a hash of its flags, its source and every local header the source
includes, directly or through another header, so a changed header
rebuilds its includers and an unchanged tree loads the built library.
Nothing here compiles: the names are computed on the CPU."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "h.cuh"\nint k;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  #  include "g.cuh"\nint h;\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    (tmp_path / "other.cuh").write_text("int other;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setitem(_build.EXTRA_FLAGS, "k", [])
    return tmp_path


def test_sources_follow_local_includes(tree):
    assert [p.name for p in _build.sources("k")] == ["k.cu", "h.cuh", "g.cuh"]


@pytest.mark.parametrize("changed,rebuilds", [("k.cu", True), ("h.cuh", True),
                                              ("g.cuh", True), ("other.cuh", False)])
def test_a_changed_source_or_header_changes_the_library_name(tree, changed, rebuilds):
    before = _build._target("k")[0].name
    assert _build._target("k")[0].name == before  # stable
    path = tree / changed
    path.write_text(path.read_text() + "// edited\n")
    assert (_build._target("k")[0].name != before) == rebuilds


def test_flags_change_the_library_name(tree, monkeypatch):
    before = _build._target("k")[0].name
    monkeypatch.setitem(_build.EXTRA_FLAGS, "k", ["-fmad=false"])
    assert _build._target("k")[0].name != before


@pytest.mark.parametrize("name", sorted(_build.EXTRA_FLAGS))
def test_the_kernels_headers(name):
    """The attention kernels share wgmma.cuh; every other source stands alone."""
    got = [p.name for p in _build.sources(name)]
    shared = ["wgmma.cuh"] if name in ("flash_attention", "flash_attention_bwd") else []
    assert got == [f"{name}.cu"] + shared
