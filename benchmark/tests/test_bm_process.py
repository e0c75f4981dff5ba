"""run.py fixes the hash seed and the cores, once, in the same process."""
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRINT = ("import os, sys; sys.path.insert(0, {bench!r}); import run; "
         "print(os.getpid(), os.environ.get('PYTHONHASHSEED'), "
         "sorted(os.sched_getaffinity(0)), flush=True); run.fix_process()")


def test_fix_process_execs_once_with_the_hash_seed():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    out = subprocess.run([sys.executable, "-c", PRINT.format(bench=BENCH)],
                         env=env, capture_output=True, text=True,
                         timeout=60, check=True).stdout.split("\n")
    first, second = [line.split(" ", 2) for line in out if line]
    assert first[0] == second[0]                  # the same process
    assert (first[1], second[1]) == ("None", "0")
    before, after = eval(first[2]), eval(second[2])
    if 0 in before and len(before) >= 4:
        assert after == [c for c in before if c != 0]
    else:
        assert after == before
