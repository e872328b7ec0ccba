"""Slice E4 of the port: the dataset registry and the download cache
(`repro_torch.graphs.datasets`), against the JAX package.

The first eleven cases are `tests/test_datasets_cache.py`'s, with the same
mock opener, run on the port's module: checksum verification, bounded
retries with seeded jitter and the offline behaviour — no network in
tests. Then both packages read the same bytes into equal graphs, the
injected ``datasets.fetch`` fault leaves nothing cached, and every
offline stand-in equals the reference's.
"""
import gzip
import io
import urllib.error

import numpy as np
import pytest

from repro.graphs import datasets as ref_datasets
from repro_torch import faults
from repro_torch.graphs import datasets


EDGE_TEXT = b"""\
# Undirected graph: mock
# FromNodeId\tToNodeId
0\t1
1\t2
2\t0
2\t3
"""


class _MockOpener:
    """urlopen stand-in serving fixed bytes and counting calls.

    ``fail`` raises on every call; ``fail_first`` raises on only the first
    N calls and then serves — the transient-outage fixture for the bounded
    retry loop."""

    def __init__(self, payload: bytes, fail: Exception | None = None,
                 fail_first: int = 0):
        self.payload = payload
        self.fail = fail
        self.fail_first = fail_first
        self.calls = 0

    def __call__(self, url):
        self.calls += 1
        if self.fail is not None:
            raise self.fail
        if self.calls <= self.fail_first:
            raise urllib.error.URLError(f"transient outage {self.calls}")
        return io.BytesIO(self.payload)


def _gz_payload() -> bytes:
    return gzip.compress(EDGE_TEXT)


def test_load_remote_parses_and_caches(tmp_path):
    opener = _MockOpener(_gz_payload())
    g = datasets.load_remote("ca-GrQc", cache=str(tmp_path), opener=opener)
    assert opener.calls == 1
    assert g.n == 4 and g.m == 4
    assert g.has_edge(0, 1) and g.has_edge(2, 3)
    # second load: served from disk, the network is never touched
    g2 = datasets.load_remote("ca-GrQc", cache=str(tmp_path), opener=opener)
    assert opener.calls == 1
    assert g2 == g
    # sha256 sidecar was recorded (trust-on-first-use)
    sidecars = list(tmp_path.glob("*.sha256"))
    assert len(sidecars) == 1


def test_offline_error_is_actionable(tmp_path):
    opener = _MockOpener(b"", fail=urllib.error.URLError("no route to host"))
    with pytest.raises(datasets.DatasetFetchError) as ei:
        datasets.load_remote("ca-GrQc", cache=str(tmp_path), opener=opener)
    msg = str(ei.value)
    # the message must say where to put a manually fetched file
    assert str(tmp_path) in msg
    assert "offline" in msg
    assert datasets._CACHE_ENV in msg


def test_corrupt_cache_detected(tmp_path):
    opener = _MockOpener(_gz_payload())
    path = datasets.fetch("ca-GrQc", cache=str(tmp_path), opener=opener)
    with open(path, "ab") as f:
        f.write(b"corruption")
    with pytest.raises(datasets.DatasetFetchError) as ei:
        datasets.fetch("ca-GrQc", cache=str(tmp_path), opener=opener)
    assert "checksum mismatch" in str(ei.value)
    assert path in str(ei.value)


def test_pinned_digest_rejects_tampered_download(tmp_path, monkeypatch):
    url, _ = datasets.REMOTE["ca-GrQc"]
    monkeypatch.setitem(datasets.REMOTE, "ca-GrQc", (url, "0" * 64))
    opener = _MockOpener(_gz_payload())
    with pytest.raises(datasets.DatasetFetchError) as ei:
        datasets.fetch("ca-GrQc", cache=str(tmp_path), opener=opener)
    assert "refusing to cache" in str(ei.value)
    assert not list(tmp_path.glob("*.txt.gz"))


def test_transient_failure_retries_then_succeeds(tmp_path):
    opener = _MockOpener(_gz_payload(), fail_first=2)
    slept = []
    path = datasets.fetch("ca-GrQc", cache=str(tmp_path), opener=opener,
                          retries=3, backoff=0.5, sleep=slept.append)
    assert opener.calls == 3  # 2 failures + the success
    assert len(slept) == 2  # one backoff before each retry
    # exponential schedule with deterministic jitter in [0.5, 1.5)
    assert 0.5 * 0.5 <= slept[0] < 0.5 * 1.5
    assert 1.0 * 0.5 <= slept[1] < 1.0 * 1.5
    # the jitter is seeded: the same retry_seed reproduces the schedule
    opener2 = _MockOpener(_gz_payload(), fail_first=2)
    slept2 = []
    datasets.fetch("ca-GrQc", cache=str(tmp_path / "b"), opener=opener2,
                   retries=3, backoff=0.5, sleep=slept2.append)
    assert slept == slept2
    with open(path, "rb") as f:
        assert f.read() == _gz_payload()


def test_distinct_retry_seeds_decorrelate_jitter(tmp_path):
    schedules = []
    for seed in (0, 1):
        opener = _MockOpener(_gz_payload(), fail_first=1)
        slept = []
        datasets.fetch("ca-GrQc", cache=str(tmp_path / str(seed)),
                       opener=opener, retry_seed=seed, sleep=slept.append)
        schedules.append(tuple(slept))
    assert schedules[0] != schedules[1]


def test_permanent_failure_exhausts_bounded_retries(tmp_path):
    opener = _MockOpener(b"", fail=urllib.error.URLError("down for good"))
    slept = []
    with pytest.raises(datasets.DatasetFetchError) as ei:
        datasets.fetch("ca-GrQc", cache=str(tmp_path), opener=opener,
                       retries=3, sleep=slept.append)
    assert opener.calls == 4  # initial attempt + 3 retries, then give up
    assert len(slept) == 3
    assert "after 4 attempts" in str(ei.value)


def test_checksum_mismatch_never_retries(tmp_path, monkeypatch):
    """A pinned-digest failure is corruption, not weather — re-downloading
    would fetch the same bad bytes, so the loop must not spin."""
    url, _ = datasets.REMOTE["ca-GrQc"]
    monkeypatch.setitem(datasets.REMOTE, "ca-GrQc", (url, "0" * 64))
    opener = _MockOpener(_gz_payload())
    slept = []
    with pytest.raises(datasets.DatasetFetchError):
        datasets.fetch("ca-GrQc", cache=str(tmp_path), opener=opener,
                       retries=3, sleep=slept.append)
    assert opener.calls == 1
    assert slept == []


def test_unknown_remote_name():
    with pytest.raises(KeyError):
        datasets.fetch("definitely-not-a-dataset")


def test_cache_dir_env_override(monkeypatch, tmp_path):
    monkeypatch.setenv(datasets._CACHE_ENV, str(tmp_path / "alt"))
    assert datasets.cache_dir() == str(tmp_path / "alt")


def test_parse_edge_text_skips_comments_and_blanks():
    arr = datasets._parse_edge_text(b"# c\n\n% x\n5 7\n7 5\n")
    assert np.array_equal(arr, np.array([[5, 7], [7, 5]]))


# ------------------------------------------------------ against the reference
def _random_edge_text(seed):
    """SNAP-style text with comments, blanks, sparse ids, duplicates and
    self-loops."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(10_000, size=300, replace=False)
    e = ids[rng.integers(0, ids.size, size=(1500, 2))]
    lines = ["# Directed graph: mock", "# Nodes: 300", ""]
    lines += [f"{u}\t{v}" if k % 3 else f"{u} {v}  " for k, (u, v) in
              enumerate(e)]
    lines.insert(700, "% a comment")
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("seed", [0, 1])
def test_both_packages_read_the_same_bytes_into_equal_graphs(tmp_path, seed):
    raw = _random_edge_text(seed)
    np.testing.assert_array_equal(datasets._parse_edge_text(raw),
                                  ref_datasets._parse_edge_text(raw))
    payload = gzip.compress(raw)
    got = datasets.load_remote("email-Enron", cache=str(tmp_path / "p"),
                               opener=_MockOpener(payload))
    want = ref_datasets.load_remote("email-Enron", cache=str(tmp_path / "r"),
                                    opener=_MockOpener(payload))
    assert (got.n, got.m) == (want.n, want.m) and got.m > 0
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    # the two caches hold the same bytes and the same digest
    for suffix in ("email-Enron.txt.gz", "email-Enron.txt.gz.sha256"):
        assert ((tmp_path / "p" / suffix).read_bytes()
                == (tmp_path / "r" / suffix).read_bytes())


def test_injected_fetch_fault_caches_nothing(tmp_path):
    opener = _MockOpener(_gz_payload())
    with pytest.raises(faults.InjectedFault) as ei:
        with faults.inject("datasets.fetch"):
            datasets.load_remote("ca-GrQc", cache=str(tmp_path),
                                 opener=opener)
    assert ei.value.site == "datasets.fetch"
    assert opener.calls == 0
    assert list(tmp_path.iterdir()) == []
    # disarmed, the next load downloads and caches as usual
    assert datasets.load_remote("ca-GrQc", cache=str(tmp_path),
                                opener=opener).m == 4


def test_registry_matches_the_reference():
    assert datasets.names() == ref_datasets.names()
    assert datasets.names(full=True) == ref_datasets.names(full=True)
    assert len(datasets.names(full=True)) == 16
    assert datasets.REMOTE == ref_datasets.REMOTE
    assert datasets._CACHE_ENV == ref_datasets._CACHE_ENV
    for name in datasets.names(full=True):
        assert datasets.info(name) == ref_datasets.info(name)


@pytest.mark.parametrize("name", ref_datasets.names(full=True))
def test_load_equals_the_reference(name):
    got, want = datasets.load(name), ref_datasets.load(name)
    assert (got.n, got.m) == (want.n, want.m)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
