"""Run one cell of ``BENCHMARK.json`` on this machine's card:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error).  Exits 2 without a
result when the card, the program or the cell is missing, and 3 when the
process holds JAX or the JAX package.
"""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the package is imported as ``portbench``; its modules never as top-level
# names (``trace`` would shadow the standard library's)
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != HERE]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS, root=ROOT))
