"""The port's kernel build (`repro_torch.kernels._build`) on the CPU: what
names the cached library. nvcc is not needed: only the digest and the
source list are exercised."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "a.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "tile.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("v1\n")
    return tmp_path


def test_digest_changes_with_a_header(csrc):
    before = _build._digest(csrc)
    (csrc / "tile.cuh").write_text("// v2\n")
    assert _build._digest(csrc) != before


def test_digest_changes_with_a_source(csrc):
    before = _build._digest(csrc)
    (csrc / "a.cu").write_text('#include "tile.cuh"\n// edited\n')
    assert _build._digest(csrc) != before


def test_digest_ignores_unrelated_files(csrc):
    before = _build._digest(csrc)
    (csrc / "notes.txt").write_text("v2\n")
    (csrc / "b.py").write_text("x = 1\n")
    assert _build._digest(csrc) == before


def test_the_tree_compiles_sources_and_hashes_headers():
    """Headers are hashed, never compiled as units of their own."""
    names = [p.name for p in _build._sources()]
    assert "bitset_intersections.cu" in names
    assert "pairwise_intersections.cu" in names
    assert all(n.endswith(".cu") for n in names)
    assert (_build.CSRC_DIR / "popc_gram.cuh").is_file()
    assert _build._digest() == _build._digest(_build.CSRC_DIR)
