"""Run one cell of the benchmark from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The CPU thread pools and every build and kernel cache are fixed here,
before numpy or torch is imported: one thread each, and the caches in
`benchmark/.cache/` inside the checkout.  The program's CUDA kernels
build into `ouroboros_tpu_torch/build/` of the checkout on its first run.

So that two runs of one cell differ only in what the host does to them,
a run also fixes what a fresh interpreter would otherwise draw anew: the
hash seed (the layout and order of every dict and set of bytes and
strings), by starting itself again, as the same process, with
PYTHONHASHSEED=0; and the cores it runs on: all that it may use but
core 0, which takes most of the machine's interrupts.
"""
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(BENCH, ".cache")
HASH_SEED = "0"

for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
            "NUMEXPR_NUM_THREADS"):
    os.environ[var] = "1"
for var, sub in (("CUDA_CACHE_PATH", "nv"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(CACHE, sub)

sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def fix_process() -> None:
    """Pin the cores and, where the hash seed is not yet fixed, start
    this interpreter again with it (os.execv: the same process)."""
    if hasattr(os, "sched_setaffinity"):
        cores = os.sched_getaffinity(0)
        if 0 in cores and len(cores) >= 4:
            os.sched_setaffinity(0, cores - {0})
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.environ["PYTHONHASHSEED"] = HASH_SEED
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(sys.executable, sys.orig_argv)


if __name__ == "__main__":
    fix_process()
    import harness
    raise SystemExit(harness.main())
