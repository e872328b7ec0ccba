"""Offline stand-ins for the paper's 16 datasets (Table II) + real downloads.

Every stand-in is a seeded synthetic graph in the same *regime* (domain,
density, structure) at a size that runs on one CPU core; the registry is
the JAX package's, so ``load(name)`` gives the same graph in both packages.
The mapping is recorded so benchmark tables carry the paper's dataset
mnemonics.

`load_remote` additionally reads the real SNAP edge lists the paper uses,
through a disk cache under ``$REPRO_DATA_DIR`` (default
``~/.cache/repro-slugger``, shared with the JAX package): a download is
verified against a sha256 sidecar (trust on first use when the registry
pins no digest), a cache hit never touches the network, and network or
corruption failures raise `DatasetFetchError` with the exact path to drop a
manually obtained file into — never a raw ``URLError``. ``opener``
replaces ``urllib.request.urlopen``: tests and the card's smoke run serve
the bytes from a local file, so nothing there fetches.
"""
from __future__ import annotations

import gzip
import hashlib
import os
import time
import urllib.error
import urllib.request

import numpy as np

from repro_torch import faults
from repro_torch.graphs import generators as G
from repro_torch.graphs.csr import Graph

# name -> (paper dataset, domain, builder)
_REGISTRY = {
    # Internet topology: hubs and spokes
    "CA": ("Caida", "Internet", lambda: G.star_of_cliques(400, 12, seed=1)),
    # Dense social ego-nets: overlapping dense communities
    "FA": ("Ego-Facebook", "Social", lambda: G.planted_hierarchy((4, 4), 24, (0.004, 0.35, 0.92), seed=2)),
    # PPI: strong hierarchical module structure (SLUGGER's best dataset)
    "PR": ("Protein", "PPI", lambda: G.planted_hierarchy((4, 4, 4), 12, (0.001, 0.10, 0.85, 0.99), seed=3)),
    # Email: heavy-tailed
    "EM": ("Email-Enron", "Email", lambda: G.barabasi_albert(4000, 5, seed=4)),
    # Collaboration: caveman cliques
    "DB": ("DBLP", "Collaboration", lambda: G.caveman(700, 6, rewire=0.08, seed=5)),
    # Co-purchase: sparse scale-free with communities
    "AM": ("Amazon0601", "Co-purchase", lambda: G.rmat(12, 5, seed=6)),
    # Hyperlinks: highly compressible rmat
    "CN": ("CNR-2000", "Hyperlinks", lambda: G.planted_hierarchy((6, 5, 4), 10, (0.0006, 0.02, 0.9, 1.0), seed=7)),
    # Social video: sparse heavy-tail (hardest to compress in the paper)
    "YO": ("Youtube", "Social", lambda: G.barabasi_albert(6000, 3, seed=8)),
    # Internet: rmat larger
    "SK": ("Skitter", "Internet", lambda: G.rmat(13, 6, seed=9)),
    # Hyperlinks dense: nested bipartite + hierarchy (very compressible)
    "EU": ("EU-05", "Hyperlinks", lambda: G.planted_hierarchy((5, 5, 5), 10, (0.001, 0.05, 0.9, 0.995), seed=10)),
}

_LARGE = {
    # Larger stand-ins used by scalability/speed runs when --full is given.
    "ES": ("Eswiki-13", "Social", lambda: G.rmat(14, 6, seed=11)),
    "LJ": ("LiveJournal", "Social", lambda: G.barabasi_albert(20000, 6, seed=12)),
    "HO": ("Hollywood", "Collaboration", lambda: G.caveman(2500, 8, rewire=0.05, seed=13)),
    "IC": ("IC-04", "Hyperlinks", lambda: G.planted_hierarchy((6, 6, 5), 12, (0.0004, 0.02, 0.85, 0.99), seed=14)),
    "U2": ("UK-02", "Hyperlinks", lambda: G.rmat(15, 6, seed=15)),
    "U5": ("UK-05", "Hyperlinks", lambda: G.rmat(16, 6, seed=16)),
}


def names(full: bool = False):
    return list(_REGISTRY) + (list(_LARGE) if full else [])


def info(name: str):
    reg = {**_REGISTRY, **_LARGE}
    paper_name, domain, _ = reg[name]
    return {"paper_dataset": paper_name, "domain": domain}


def load(name: str) -> Graph:
    reg = {**_REGISTRY, **_LARGE}
    return reg[name][2]()


# ---------------------------------------------------------------------------
# Real datasets: cached, checksummed downloads
# ---------------------------------------------------------------------------
_CACHE_ENV = "REPRO_DATA_DIR"

# name -> (url, pinned sha256 or None = trust-on-first-use via sidecar)
REMOTE = {
    "ca-GrQc": ("https://snap.stanford.edu/data/ca-GrQc.txt.gz", None),
    "ca-HepTh": ("https://snap.stanford.edu/data/ca-HepTh.txt.gz", None),
    "email-Enron": ("https://snap.stanford.edu/data/email-Enron.txt.gz", None),
}


class DatasetFetchError(RuntimeError):
    """Download/cache failure with an actionable recovery hint."""


def cache_dir() -> str:
    return os.environ.get(
        _CACHE_ENV, os.path.join(os.path.expanduser("~"), ".cache",
                                 "repro-slugger"))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def fetch(name: str, cache: str | None = None, opener=None,
          retries: int = 3, backoff: float = 0.5, retry_seed: int = 0,
          sleep=time.sleep) -> str:
    """Return the local path of dataset ``name``, downloading on miss.

    Cache layout: ``<cache>/<name><ext>`` plus a ``.sha256`` sidecar. A hit
    is served only if its digest matches the pinned (or recorded) one; a
    corrupt file raises instead of silently re-parsing. ``opener`` overrides
    ``urllib.request.urlopen``.

    Transient network errors retry up to ``retries`` times with exponential
    backoff (``backoff * 2**attempt`` seconds) scaled by a DETERMINISTIC
    jitter in [0.5, 1.5) drawn from ``SeedSequence((retry_seed, attempt))``
    — reproducible like every other randomness in the repo, but still
    decorrelating parallel fetchers that pass distinct seeds. Checksum
    mismatches never retry: a pinned-digest failure means a corrupt or
    tampered payload, and re-downloading it would fetch the same bytes.
    ``sleep`` is injectable so tests assert the schedule without waiting it
    out. Each attempt checks the fault site ``datasets.fetch`` first; an
    injected fault propagates and caches nothing.
    """
    if name not in REMOTE:
        raise KeyError(f"unknown remote dataset {name!r}; "
                       f"known: {sorted(REMOTE)}")
    url, pinned = REMOTE[name]
    cache = cache or cache_dir()
    os.makedirs(cache, exist_ok=True)
    ext = ".txt.gz" if url.endswith(".gz") else ".txt"
    path = os.path.join(cache, name + ext)
    sidecar = path + ".sha256"
    if os.path.exists(path):
        want = pinned
        if want is None and os.path.exists(sidecar):
            with open(sidecar) as f:
                want = f.read().strip()
        got = _sha256(path)
        if want is None or got == want:
            return path
        raise DatasetFetchError(
            f"checksum mismatch for cached {path}: expected {want}, got "
            f"{got}. Delete the file to re-download, or replace it with a "
            f"correct copy from {url}.")
    opener = opener or urllib.request.urlopen
    last_err = None
    for attempt in range(max(0, int(retries)) + 1):
        if attempt:
            jitter = 0.5 + np.random.default_rng(
                np.random.SeedSequence((int(retry_seed), attempt))).random()
            sleep(backoff * 2 ** (attempt - 1) * jitter)
        faults.check("datasets.fetch")
        try:
            with opener(url) as resp:
                data = resp.read()
            break
        except (urllib.error.URLError, OSError, ValueError) as e:
            last_err = e
    else:
        raise DatasetFetchError(
            f"could not download {name} from {url} after "
            f"{max(0, int(retries)) + 1} attempts: {last_err}. If this "
            f"host is offline, fetch the file elsewhere and place it at "
            f"{path} (cache dir overridable via ${_CACHE_ENV}).") \
            from last_err
    got = hashlib.sha256(data).hexdigest()
    if pinned is not None and got != pinned:
        raise DatasetFetchError(
            f"downloaded {name} has sha256 {got}, registry pins {pinned}; "
            f"refusing to cache a corrupt/tampered file.")
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    tmp_sc = sidecar + ".part"
    with open(tmp_sc, "w") as f:
        f.write(got + "\n")
    os.replace(tmp_sc, sidecar)
    return path


def _parse_edge_text(raw: bytes) -> np.ndarray:
    """SNAP edge-list text: '#' comments, one 'u<ws>v' pair per line."""
    rows = []
    for line in raw.decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "%")):
            continue
        parts = line.split()
        if len(parts) >= 2:
            rows.append((int(parts[0]), int(parts[1])))
    return (np.array(rows, dtype=np.int64) if rows
            else np.zeros((0, 2), dtype=np.int64))


def load_remote(name: str, cache: str | None = None, opener=None) -> Graph:
    """Fetch (or reuse) a remote dataset and parse it into a `Graph`.

    Node ids are compacted to ``0..n-1`` in ascending original-id order, so
    the result is deterministic for a fixed file.
    """
    path = fetch(name, cache=cache, opener=opener)
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".gz"):
        raw = gzip.decompress(raw)
    edges = _parse_edge_text(raw)
    if edges.size == 0:
        return Graph.from_edges(0, edges)
    uniq, inv = np.unique(edges, return_inverse=True)
    return Graph.from_edges(int(uniq.size), inv.reshape(-1, 2))
