"""Replay a forged Shelley chain through the port on the card.

    python -m ouroboros_tpu_torch.replay [--blocks 2304] [--window 1024]
        [--device cuda|cpu] [--runs 1] [--kes-depth 6]

The counterpart of `bench.py`'s `synth_chain` + `replay`: forge a chain
in memory (chainsynth.py: 2 pools, f = 4/5, epoch length 600, two
transactions a block, k = 2160), then replay it with
`replay_blocks_pipelined(ext, blocks, ext.initial_state(),
backend=TorchBackend(device), window=W)`: the producer thread runs the
sequential header/ledger pass and submits each window with `fold=True`,
and the caller drains two windows in flight (consensus/pipeline.py).

Each run starts from a fresh `TorchBackend` and a cleared
`GLOBAL_BETA_CACHE`, so every run launches the same kernels.  A run
prints blocks/s and proofs/s (4 + the witnesses of each block, as
`bench.py` counts them), whether the final ledger `state_hash` equals
the forger's `tick_then_reapply` state, and where its time went, from
the spans (observe/spans.py): the producer's `window.host_seq` and
`window.submit`, the consumer's `pipeline.drain`, and inside each submit
the seam's parts (`submit.split`, `submit.pack`, `precompute.assemble`,
`submit.launch`, `submit.attach`), the per-key fill (`precompute.fill`
and its wait for the card, `precompute.fill_wait`) and the verdict fold
(`window.fold`).  It also prints the share of `window.host_seq` that the
producer thread spent off the CPU: its wall time less its thread CPU
time, waiting for the interpreter lock or descheduled.  The forging
seconds are printed on their own line, outside every timed region.
The run is on the CUDA card unless `--device cpu` is given; without a
card it raises before forging.
"""
from __future__ import annotations

import argparse
import json
import time

from . import chainsynth
from . import device as device_mod
from .consensus.batch import replay_blocks_pipelined
from .crypto.backend import GLOBAL_BETA_CACHE
from .crypto.torch_backend import TorchBackend
from .observe import spans as _spans

# the spans a run reports, in the order of a window's life
SPANS = ("window.host_seq", "window.submit", "submit.split", "submit.pack",
         "precompute.assemble", "precompute.fill", "precompute.fill_wait",
         "submit.launch", "submit.attach", "window.fold", "pipeline.drain")
# those that open inside a `window.submit`: one sum a submit
IN_SUBMIT = SPANS[2:-1]


def n_proofs(blocks) -> int:
    """Proofs a replay verifies: 2 VRF, the OCert and the KES signature
    of each header, and each transaction witness (bench.py's count)."""
    return sum(4 + sum(len(tx.witnesses) for tx in b.body) for b in blocks)


# the streaming replay's own spans, on its prefetch thread
# (storage/stream.py): one chunk's read, and the CBOR decoding of its blocks
DISK_SPANS = ("stream.read", "stream.decode")


def _span_seconds(roots, names=SPANS) -> dict:
    """Per name in `names`, one duration a root span in order: the root
    spans of the producer (host_seq, submit), of the consumer (drain)
    and of the prefetch thread (read, decode), and the seconds of each
    span of IN_SUBMIT inside each submit (never one outside a submit,
    such as the beta prefetch's packer)."""
    out = {name: [] for name in names}
    for root in sorted(roots, key=lambda r: r.t0):
        if root.name not in out or root.name in IN_SUBMIT:
            continue
        out[root.name].append(root.duration)
        if root.name == "window.submit":
            for name in IN_SUBMIT:
                if name in out:
                    out[name].append(sum(s.duration for s in root.walk()
                                         if s.name == name))
    return out


def offcpu_pct(roots, name: str = "window.host_seq"):
    """100 x (wall - CPU) / wall over the root spans called `name`: the
    share of their time that their thread spent off the CPU.  None where
    there is none, or their CPU time was not read (under a runtime)."""
    sps = [r for r in roots if r.name == name and r.t1 is not None]
    wall = sum(r.duration for r in sps)
    if not wall or any(r.cpu is None for r in sps):
        return None
    return 100.0 * (wall - sum(r.cpu for r in sps)) / wall


def _recorded(fn) -> tuple:
    """fn() with span recording on: (its result, its seconds, the root
    spans it closed)."""
    rec = _spans.RECORDER
    was_on = rec.enabled
    rec.drain()
    rec.enable()
    try:
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
    finally:
        if not was_on:
            rec.disable()
    return out, seconds, rec.drain()


def recording(fn, names=SPANS) -> tuple:
    """fn() with span recording on: (its result, its seconds, the span
    seconds of `names`, as `_span_seconds` gives them)."""
    out, seconds, roots = _recorded(fn)
    return out, seconds, _span_seconds(roots, names)


def replay_once(ext, blocks, backend, window: int) -> dict:
    """One replay of `blocks` from genesis through `backend`, with a
    cleared beta cache and span recording on.  Returns the ReplayResult
    (`result`), the seconds, blocks/s, proofs/s, the per-window span
    seconds (`spans`: name -> list) and the sequential pass's off-CPU
    share (`host_seq_offcpu_pct`, offcpu_pct's)."""
    GLOBAL_BETA_CACHE.clear()
    res, seconds, roots = _recorded(
        lambda: replay_blocks_pipelined(ext, blocks, ext.initial_state(),
                                        backend=backend, window=window))
    return {"result": res, "seconds": seconds,
            "blocks_per_s": res.n_valid / seconds,
            "proofs_per_s": n_proofs(blocks[:res.n_valid]) / seconds,
            "spans": _span_seconds(roots),
            "host_seq_offcpu_pct": offcpu_pct(roots)}


def run(blocks: int = 2304, window: int = 1024, device=None, runs: int = 1,
        kes_depth: int = 6, seed: bytes = b"db-synth", log=None) -> dict:
    """Forge, then replay `runs` times on fresh backends.  Returns the
    forging seconds, the chain, the device's name and one dict per run
    (replay_once's, plus `state_hash_match`)."""
    dev = device_mod.resolve(device)
    t0 = time.perf_counter()
    ext, chain, state = chainsynth.forge_shelley(
        blocks, kes_depth=kes_depth, seed=seed,
        log=(lambda n: log(f"forged {n}/{blocks}")) if log else None)
    forge_s = time.perf_counter() - t0
    want = state.ledger.state_hash()
    out = []
    for _ in range(runs):
        r = replay_once(ext, chain, TorchBackend(dev), window)
        fin = r["result"].final_state
        r["state_hash_match"] = (fin is not None
                                 and fin.ledger.state_hash() == want)
        out.append(r)
    return {"forge_s": forge_s, "blocks": chain, "runs": out,
            "device": device_mod.device_kind(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=2304)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--device", default=None)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--kes-depth", type=int, default=6)
    a = ap.parse_args(argv)
    out = run(a.blocks, a.window, a.device, a.runs, a.kes_depth,
              log=print)
    print(f"forging: {out['forge_s']:.3f} s ({a.blocks} blocks, KES depth "
          f"{a.kes_depth})")
    ok = True
    for i, r in enumerate(out["runs"]):
        res, sp = r["result"], r["spans"]
        ok = ok and res.all_valid and r["state_hash_match"]
        print(f"run {i}: {r['blocks_per_s']:.1f} blocks/s, "
              f"{r['proofs_per_s']:.1f} proofs/s ({r['seconds']:.3f} s), "
              f"n_valid {res.n_valid}, state_hash matches the forger's: "
              f"{r['state_hash_match']}"
              + ("" if res.error is None else f", error {res.error!r}"))
        print("  " + ", ".join(f"{name} {sum(v):.4f} s" for name, v
                               in sp.items()))
        off = r["host_seq_offcpu_pct"]
        print("  window.host_seq off the CPU: "
              + ("not read" if off is None else f"{off:.1f} %"))
    print(json.dumps({
        "device": out["device"], "blocks": a.blocks, "window": a.window,
        "forge_s": out["forge_s"],
        "blocks_per_s": [r["blocks_per_s"] for r in out["runs"]],
        "proofs_per_s": [r["proofs_per_s"] for r in out["runs"]],
        "state_hash_match": [r["state_hash_match"] for r in out["runs"]],
        "spans_s": [{k: sum(v) for k, v in r["spans"].items()}
                    for r in out["runs"]],
        "host_seq_offcpu_pct": [r["host_seq_offcpu_pct"]
                                for r in out["runs"]]}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
