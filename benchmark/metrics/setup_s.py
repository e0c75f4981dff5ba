"""The program's set-up: its import, the rules, decoding the chain, the
kernel library's load (its build on a checkout's first run) and the
warm-up passes at the cell's own shapes.  Forging is the benchmark's
data and is timed apart."""


def read(run: dict):
    return run["setup_s"]
