"""Run one benchmark cell once on the card and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, driver and metrics are found by name under
``benchmark/`` (see ``harness.py``).  Exits non-zero, printing no result,
without enough CUDA devices or the program under test.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "bench_cache")
# the bytecode of every module imported from here on, torch's too, kept in
# the checkout: where the interpreter writes none beside the sources
# (PYTHONDONTWRITEBYTECODE, a read-only install), each run would compile
# torch's modules again, some 8 s of set-up that varies with the host's load
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False
# build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[0] = ROOT

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
