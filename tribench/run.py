"""Run one tribench cell once.

    python3 tribench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the program (``src/``) beside
this folder.  The last line of standard output is the result's JSON
object; set-up parts, plans and the compared numbers go to standard
error.  Exits with 2, printing no result, without the CUDA devices the
cell needs, and with 3 if JAX or the JAX package is loaded once the
window has closed.  The kernels' build directory stays the program's
(inside the checkout); the PyTorch extension, Triton and Python bytecode
caches are fixed directories inside the checkout too
(:mod:`tribench.caches`).
"""
import time

T_START = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

if __name__ == "__main__":
    # this folder's modules are imported as ``tribench.*``, never bare (its
    # ``trace`` would shadow the standard library's)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    from tribench.caches import use_checkout_caches
    use_checkout_caches(ROOT)           # before torch is imported
    from tribench.harness import main
    sys.exit(main(sys.argv[1:], t_start=T_START))
