"""Run one cell of the benchmark of the PyTorch/CUDA port.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `chipbench/` and
the port under `src/`. Prints one JSON line last on standard output; the
numbers that decide `correct`, each beside its limit, last on standard
error. Exits non-zero, printing no result, without the CUDA cards the
cell asks for.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# build and kernel caches at fixed places inside the checkout, and the
# bytecode of every module the run imports (torch's alone takes seconds
# to compile from source where the installation holds none)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")

from chipbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
