"""The benchmark's command: run one cell of BENCHMARK.json on this machine.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout (see harness.py).
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# load from one process with few threads: the calls' host work is one
# Python thread launching kernels, and idle CPU worker pools of torch or
# numpy only take cores from it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_port.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(root=ROOT, t_process=T_PROCESS))
