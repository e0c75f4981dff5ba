"""The benchmark's harness: one run of one cell.

A cell (`workloads` in BENCHMARK.json) names a configuration and a
traffic mix; both are data files that the harness finds by name, as it
finds the reader of each metric (metrics/<name>.py).  A run:

1. forges the cell's chain from the seed, or reads it back from the
   cache (forge.py), and prints the seconds on a line of its own;
2. sets the program up (program.py): its rules, the chain decoded, the
   kernel library, the traffic's warm-up passes; `setup_s`;
3. freezes what the collector has seen (the decoded chain stays out of
   its scans) and replays the chain from genesis in whole passes until
   `seconds` have passed, finishing the pass in flight.  Passes
   alternate between the chain with one of its tampered blocks in
   place, in turn, and the valid chain; a tampered pass stops at its
   bad block.  The traffic's `backend` is "per_pass"
   (a new TorchBackend each pass: every key new, as on a fresh node) or
   "per_run" (one backend for the run: its keys cached);
4. reads the device's peak memory, lets go of the backends, and holds
   every pass against the reference (check.py);
5. prints the counters, each compared number beside its limit (on
   standard error too), and the result line, last.

With `trace` the window runs under devtrace.Tracer and the result holds
the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import check
import devtrace
import forge
from reference import cbor

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
THREADS = 1                    # torch's intra- and inter-op pools
FORBIDDEN = ("jax", "jaxlib", "flax", "ouroboros_tpu")


class NoChip(RuntimeError):
    """The cell asks for cards that this machine does not have."""


class Forbidden(RuntimeError):
    """A module the benchmark must not load is loaded."""


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_of(manifest: dict, workload: str, root: str = ROOT) -> tuple:
    """(cell entry, configuration, traffic) of a workload, by name."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = dict(_json(os.path.join(root, entry["file"])),
                  name=entry["name"])
    traffic = dict(_json(os.path.join(BENCH, "traffic",
                                      cell["traffic"] + ".json")),
                   name=cell["traffic"])
    return cell, config, traffic


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    return [m for m in manifest["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """metrics/<name>.py's `read`."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sizes(raw: bytes) -> tuple:
    """Encoded sizes of a block's header and body (its transaction list)."""
    _n, pos = cbor.array_head(raw, 0)
    _header, body_start = cbor.decode(raw, pos)
    return body_start - pos, len(raw) - body_start


class _Tally:
    """The program's counters over the passes of the window."""

    KEYS = ("device_fills", "filled_keys", "hits", "misses", "evictions")

    def __init__(self):
        self.cache = dict.fromkeys(self.KEYS, 0)
        self.lanes = 0
        self.padded = 0
        self.windows = 0

    def add(self, before: tuple, after: tuple) -> None:
        (c0, p0), (c1, p1) = before, after
        for k in self.KEYS:
            self.cache[k] += c1[k] - c0[k]
        self.lanes += p1["lanes_used"] - p0["lanes_used"]
        self.padded += p1["lanes_padded"] - p0["lanes_padded"]
        self.windows += p1["windows"] - p0["windows"]


def _snap(backend) -> tuple:
    return backend.cache.stats(), backend.padding_stats()


def _power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def host() -> dict:
    """The host CPU that paces the replay: its make (a virtual machine
    may name no model, so its family, model and stepping numbers too),
    the cores this process may use of those online, and their clocks now
    as the kernel reports them."""
    make, mhz = {}, []
    keys = {"model name": "cpu", "vendor_id": "vendor",
            "cpu family": "family", "model": "model", "stepping": "stepping"}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _sep, value = line.partition(":")
                key, value = key.strip(), value.strip()
                if key in keys:
                    make.setdefault(keys[key], value)
                elif key == "cpu MHz":
                    mhz.append(float(value))
    except OSError:
        pass
    cores = sorted(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else []
    return dict(make, online=os.cpu_count(), affinity=len(cores),
                mhz_min=min(mhz) if mhz else None,
                mhz_median=sorted(mhz)[len(mhz) // 2] if mhz else None,
                mhz_max=max(mhz) if mhz else None)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device=None, root: str = ROOT, min_bucket=None, wrap_backend=None,
        workers=None, say=print) -> dict:
    """One run of a cell; returns the result line's object.  `device`
    None asks for the cell's CUDA cards; a test may pass "cpu" and a
    `wrap_backend(backend)` that breaks the timed path underneath."""
    import torch
    torch.set_num_threads(THREADS)
    if torch.get_num_interop_threads() != THREADS:
        torch.set_num_interop_threads(THREADS)
    manifest = load_manifest(root)
    cell, config, traffic = cell_of(manifest, workload, root)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            raise NoChip(f"{workload} needs {cell['chips']} CUDA card(s); "
                         f"this machine has "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    if importlib.util.find_spec("ouroboros_tpu_torch") is None:
        raise ModuleNotFoundError("the program, ouroboros_tpu_torch, is not "
                                  "in this checkout")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    chain, forge_s, cached = forge.load_or_forge(
        config, traffic, seed, workers or os.cpu_count() or 1)
    raw, variants = chain["blocks"], chain["variants"]
    max_header, max_body = map(max, zip(*(sizes(b) for b in raw)))
    limits = config["protocolParams"]
    if max_body > limits["maxBlockBodySize"] \
            or max_header > limits["maxBlockHeaderSize"]:
        raise ValueError(f"a block of {max_header} header and {max_body} "
                         f"body bytes exceeds the protocol's limits")
    # one witness a transaction (forge.py); the certificate and the KES
    # leaf are two more Ed25519 lanes a block, the two proofs two VRF lanes
    ed_pass = len(raw) * (2 + config["txsPerBlock"])
    vrf_pass = 2 * len(raw)
    full, proofs = check.samples(raw, config["check"], seed)
    say("forge " + json.dumps({
        "seconds": forge_s, "from_cache": cached, "blocks": len(raw),
        "max_header_bytes": max_header, "max_body_bytes": max_body,
        "tampered": [[v[0], v[1]] for v in variants],
        "ed25519_lanes_a_pass": ed_pass, "vrf_lanes_a_pass": vrf_pass}))

    from program import Program, digest
    t_setup = time.perf_counter()
    prog = Program(chain["genesis"], dev, config["window"], min_bucket)
    blocks = prog.decode(raw)
    forms = {-1: blocks}
    checked = check.checked(len(raw), variants)
    for v, ((_k, i, _raw, headers), b) in enumerate(zip(
            variants, prog.decode([v[2] for v in variants]))):
        end = checked[v]
        forms[v] = (blocks[:i] + [b] + prog.rechain(blocks[i + 1:end],
                                                     headers)
                    + blocks[end:])
    # the decoded chain is the harness's to hold: the collector's later
    # scans, in set-up and in the window, leave it out
    gc.collect()
    gc.freeze()
    t_decoded = time.perf_counter()
    prog.load_kernels()
    t_kernels = time.perf_counter()
    per_pass = traffic["backend"] == "per_pass"
    shared = None if per_pass else prog.backend()

    def one_pass(v: int, tally=None):
        be = shared if shared is not None else prog.backend()
        before = _snap(be)
        rec = prog.replay(forms[v], wrap_backend(be) if wrap_backend else be,
                          v, [pi for _i, pi in proofs])
        if tally is not None:
            tally.add(before, _snap(be))
        return rec

    # warm-up passes: the valid chain, then the first tampered form;
    # window passes: tampered forms in turn, each followed by the valid
    # chain, so that every window starts on a tampered pass and its
    # first passes reach every window of the chain and both halves
    for w in range(traffic["warmup_passes"]):
        one_pass(-1 if w % 2 == 0 else 0)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    say("setup " + json.dumps({
        "seconds": setup_s, "rules_and_decode_s": t_decoded - t_setup,
        "kernels_s": t_kernels - t_decoded,
        "warmup_s": t_setup + setup_s - t_kernels,
        "warmup_passes": traffic["warmup_passes"]}))

    gc.collect()
    gc.freeze()
    tally = _Tally()
    launches0 = prog.launches()
    records = []
    with devtrace.Tracer(trace, cuda) as tracer:
        t0 = time.perf_counter()
        ends = []
        while True:
            j = len(records)
            records.append(one_pass(
                (j // 2) % len(variants) if j % 2 == 0 else -1, tally))
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    window_s = t1 - t0
    launches = {k: v - launches0.get(k, 0)
                for k, v in prog.launches().items() if v - launches0.get(k, 0)}
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    t_read = time.perf_counter()
    summary = tracer.summary(t0, t1) if trace else None
    trace_read_s = time.perf_counter() - t_read
    del shared
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded after the window: {', '.join(found)}")

    passes = len(records)
    # a pass checks the whole chain, or a tampered form's blocks to the
    # end of its tampered block's window
    validated = sum(checked[r.variant] for r in records)
    per_block = ed_pass / len(raw), vrf_pass / len(raw)
    run_ = {
        "setup_s": setup_s, "window_s": window_s, "passes": passes,
        "blocks": validated, "windows": tally.windows,
        "lanes": tally.lanes,
        "ed_lanes": round(validated * per_block[0]),
        "vrf_lanes": round(validated * per_block[1]), "trace": summary,
    }
    say("window " + json.dumps({
        "passes": passes, "valid_passes": sum(r.variant < 0 for r in records),
        "blocks_validated": validated, "windows": tally.windows,
        "window_s": window_s,
        "pass_s": [b - a for a, b in zip([t0] + ends, ends)],
        "cache": tally.cache, "lanes_used": tally.lanes,
        "lanes_padded": tally.padded, "launches": launches,
        "torch_threads": [torch.get_num_threads(),
                          torch.get_num_interop_threads()],
        "omp_threads": os.environ.get("OMP_NUM_THREADS"),
        "trace_read_s": trace_read_s,
        "gc_frozen": gc.get_freeze_count()}))
    say("host " + json.dumps(host()))
    if cuda:
        say("card " + _power())

    t_ref = time.perf_counter()
    expect = check.Expectation(chain["genesis"], raw, variants,
                               config["window"], full, proofs)
    checks = check.compare(expect, records, digest)
    say("reference " + json.dumps({
        "seconds": time.perf_counter() - t_ref, "full_blocks": len(full),
        "vrf_outputs": len(proofs)}))

    metrics = {}
    for m in metrics_of(manifest, workload, trace):
        value = reader(m["name"])(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": check.passed(checks), "attempted": validated,
           "failed": 0, "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = summary["busy_s"] or 0.0
        dev_info["window_s"] = window_s
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded: {', '.join(found)}")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoChip as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except Forbidden as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
