"""Runs one cell of the port's benchmark and prints its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port
(mmoe_multimodal_rec_tpu_torch) on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, [breakdown], checks); the numbers
compared with the plain reference are also the last lines of standard
error.  Exits non-zero, with no result line, without a CUDA card.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
# kernel caches at fixed paths inside the checkout (the port builds its own
# kernels into its package's build/ directory)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
