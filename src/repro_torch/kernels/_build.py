"""Build and load the port's CUDA kernels: nvcc → one shared library →
ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) with its own nvcc
process, all started together, and the objects are linked into ONE shared
library with a plain C interface (``extern "C"`` launchers taking raw
pointers, sizes and a ``cudaStream_t``, returning ``cudaGetLastError()``).
No PyTorch header is included, so a cold build takes seconds, not minutes.

The library is built at first use into ``build/repro_torch/`` at the root
of the checkout, named by a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged tree loads the cached file. Nothing here
runs at import time: the CPU-only test suite imports every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
# launcher name -> argtypes (every pointer and the stream as c_void_p, so
# ctypes never truncates them to 32 bits)
LAUNCHERS = {
    "bitset_intersections_launch": (_P, _P, _I64, _I64, _I64, _I64, _P),
    "segment_histogram_launch": (_P, _P, _I64, _I64, _I64, _P),
    "jaccard_topj_launch": (_P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "bitset_fold_launch": (_P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "interval_count_launch": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    # the same with the probe split given (`rank_count_bench.py --split`)
    "interval_count_split_launch": (_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                    _I64, _P),
    "rowmin_hash_launch": (_P, _P, _I64, _I64, _I64, _I64, _P),
    "pairwise_intersections_launch": (_P, _P, _I64, _I64, _I64, _P),
    "flash_attention_launch": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                               _I64, _I64, _I64, _I64, _F32, _I64, _P, _P),
    # not a launcher: the flash kernels' dynamic shared memory, for reports
    "flash_attention_smem_bytes": (_I64, _I64),
}

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO: dict = {}
_LAUNCHERS: dict = {}  # launcher name -> the library's ctypes function
_SMS: dict = {}  # device index -> its SM count


def pow2(x: int, floor: int = 8) -> int:
    """Round up to a power of two (≥ floor) so padded shapes stay few."""
    return max(floor, 1 << (max(1, x) - 1).bit_length())


def _sources() -> list:
    """The translation units: every ``*.cu``, each compiled by its own
    nvcc."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").is_file() else None)
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of repro_torch are built from source at first use")
    return found


def _digest(csrc: Path = CSRC_DIR) -> str:
    """Hash of the flags and of every source and header (``*.cuh``) in
    ``csrc``: an edit to either names a new library, so nothing stale
    loads."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list, lib_path: Path) -> list:
    """One nvcc per source, all in flight at once, then one link. Returns
    the ptxas resource lines (registers, shared memory, spills)."""
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        ptxas, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
            ptxas += [ln.strip() for ln in out.splitlines()
                      if "ptxas" in ln or "spill" in ln]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = tmp / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(staged),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, lib_path)  # atomic: no reader sees half a file
        (lib_path.with_suffix(".ptxas.txt")).write_text("\n".join(ptxas))
        return ptxas
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library(rebuild: bool = False):
    """The kernels' ctypes library, built on first call (thread-safe).
    ``rebuild=True`` compiles even when a library for these sources is
    cached (a smoke run proves the build, not the cache)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        sources = _sources()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
        t0 = time.perf_counter()
        if lib_path.is_file() and not rebuild:
            ptxas_file = lib_path.with_suffix(".ptxas.txt")
            ptxas = (ptxas_file.read_text().splitlines()
                     if ptxas_file.is_file() else [])
            built = False
        else:
            ptxas = _compile(sources, lib_path)
            built = True
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in LAUNCHERS.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_torch_error_string.argtypes = [ctypes.c_int]
        lib.repro_torch_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(path=str(lib_path), built=built,
                          seconds=time.perf_counter() - t0,
                          sources=[s.name for s in sources], ptxas=ptxas)
        _LIB = lib
        return lib


def check_status(name: str, status: int):
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        what = _LIB.repro_torch_error_string(status).decode()
        raise RuntimeError(f"{name} failed to launch: cudaError_t {status} "
                           f"({what})")


def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once (launchers that
    size their grid by it take it as an argument)."""
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def launch(name: str, index: int, *args) -> None:
    """Launch ``name`` with ``args`` on the current stream of CUDA device
    ``index``; raises on a non-zero ``cudaError_t``. The wrappers' hot
    path: the launcher is looked up once, the stream is read as a raw
    handle, and the device is switched only when ``index`` is not the
    current one."""
    fn = _LAUNCHERS.get(name)
    if fn is None:
        fn = _LAUNCHERS[name] = getattr(load_library(), name)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        status = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            status = fn(*args, stream)
    check_status(name.removesuffix("_launch"), status)
