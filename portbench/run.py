"""Run one benchmark cell on the CUDA card this process sees:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds `BENCHMARK.json`, `portbench/` and
the port (`crvqa_tpu_torch/`). Exits 2 without enough cards, 3 if the run
loaded JAX or the JAX package; prints one JSON line last on success."""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
