"""multichip — the sharded replay's dryrun and scaling report on a mesh.

    python -m ouroboros_tpu_torch.multichip N [--devices cuda:0,cuda:0]

Ported from `__graft_entry__.py` (`dryrun_multichip`,
`mesh_scaling_report`, `_MultichipBudget`, `_embed_metrics_snapshot`).
The mesh is `parallel.make_mesh(N, devices)`: by default the first N
CUDA cards; a list may repeat a card (`cuda:0,cuda:0`: two shards, each
on a stream of the mesh's, on one card) or name the CPU (`cpu,cpu`: the
plain PyTorch versions).

`dryrun_multichip` forges a 24-block TPraos chain, then on a
`ShardedTorchBackend` (min_bucket max(16, 2N), window 4): a prewarm
window, a sharded validate held to the CPU reference, the beta prefetch
of the whole chain, the pipelined replay to the CPU reference's
`state_hash`, the same replay on a single-device `TorchBackend` (budget
permitting) and a tampered KES signature caught at block 2.  It prints
`MULTICHIP_OBS {...}`, then runs `mesh_scaling_report`, which submits
the same window at mesh sizes 1 and N and checks that each window
launched each kernel it carries exactly once a shard (the reference
counts one fused program a window, which the port does not have); it
prints `MESH_SCALING {...}`.  The budget (`OURO_MULTICHIP_BUDGET_SECS`,
default 480, 0 disables) stops the run with exit code 3 and the
observations so far when a step ends past it.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from fractions import Fraction

from .consensus.batch import replay_blocks_pipelined, validate_blocks_batched
from .consensus.headers import ProtocolBlock, make_header
from .consensus.ledger import ExtLedgerRules
from .crypto import ed25519_ref, vrf_ref
from .crypto.backend import (GLOBAL_BETA_CACHE, Ed25519Req, OpensslBackend,
                             VrfReq)
from .crypto.torch_backend import TorchBackend
from .eras.shelley import (KES_FIELD, TPraosConfig, forge_tpraos_fields,
                           shelley_genesis_setup)
from .observe import metrics as _metrics
from .parallel import ShardedTorchBackend, log_compile_time, make_mesh

WINDOW = 4          # 4 headers -> 8 Ed25519 + 8 VRF lanes, inside the
#                     min_bucket-16 bucket
BLOCKS = 24         # 6 pipelined windows


class _MultichipBudget:
    """Self-imposed deadline for the dryrun, checked between steps: on
    overrun it prints the MULTICHIP_OBS line with every build second
    attributed so far plus the step that passed the budget, then exits
    with code 3.  OURO_MULTICHIP_BUDGET_SECS overrides the default (0
    disables)."""

    def __init__(self, obs: dict):
        self.t0 = time.monotonic()
        self.obs = obs
        self.budget = float(
            os.environ.get("OURO_MULTICHIP_BUDGET_SECS", "480"))

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def remaining(self) -> float:
        return self.budget - self.elapsed() if self.budget else float("inf")

    def check(self, just_finished: str) -> None:
        if self.budget and self.elapsed() > self.budget:
            self.obs.update(over_budget_after=just_finished,
                            elapsed_secs=round(self.elapsed(), 1),
                            budget_secs=self.budget)
            _embed_metrics_snapshot(self.obs)
            print("MULTICHIP_OBS " + json.dumps(self.obs, sort_keys=True),
                  flush=True)
            print(f"multichip dryrun over budget after '{just_finished}' "
                  f"({self.elapsed():.0f}s > {self.budget:.0f}s)",
                  file=sys.stderr, flush=True)
            raise SystemExit(3)


def _embed_metrics_snapshot(obs: dict) -> None:
    """The full metrics snapshot (unstable instruments included: build
    seconds, precompute and pipeline counters) into the observations."""
    obs["metrics"] = _metrics.registry().snapshot(include_unstable=True)


def _forge(backend):
    """The dryrun's chain: 24 TPraos blocks of 2 pools, KES depth 3, each
    applied with full crypto on `backend` as it is forged.  Returns (ext,
    blocks, proofs in the chain, the final state)."""
    cfg = TPraosConfig(k=4, f=Fraction(9, 10), epoch_length=50,
                       slots_per_kes_period=10, kes_depth=3,
                       max_kes_evolutions=6)
    protocol, ledger, pools = shelley_genesis_setup(2, cfg, seed=b"dryrun")
    ext = ExtLedgerRules(protocol, ledger)
    state = ext.initial_state()
    blocks, prev, n_proofs, slot = [], None, 0, 0
    while len(blocks) < BLOCKS:
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        for p in pools:
            lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                            ticked, view)
            if lead is None:
                continue
            h = make_header(prev, slot, (), issuer=0)
            h = forge_tpraos_fields(protocol, p["hot_key"],
                                    p["can_be_leader"], lead, h)
            blk = ProtocolBlock(h, ())
            n_proofs += len(protocol.extract_proofs(ticked, h, view))
            state = ext.tick_then_apply(state, blk, backend=backend)
            blocks.append(blk)
            prev = h
            break
        slot += 1
    return ext, blocks, n_proofs, state


def dryrun_multichip(n_devices: int, devices=None) -> tuple[dict, dict]:
    """The sharded pipelined replay over an n-device mesh, held to the
    CPU reference's state_hash, with the validate, beta-prefetch,
    single-device and tamper legs; the build (the kernel library's, at
    the first launch) is attributed outside the timed regions.  Prints
    MULTICHIP_OBS, runs mesh_scaling_report; returns (observations,
    the scaling report)."""
    obs: dict = {"n_devices": n_devices}
    budget = _MultichipBudget(obs)
    mesh = make_mesh(n_devices, devices=devices)
    obs["devices"] = [str(d) for d in mesh.devices]
    backend = ShardedTorchBackend(mesh, min_bucket=max(16, 2 * n_devices))
    cpu = OpensslBackend()
    ext, blocks, n_proofs, state = _forge(cpu)
    protocol, ledger = ext.protocol, ext.ledger
    ref_hash = state.ledger.state_hash()   # CPU reference, block by block
    budget.check("forge + cpu reference")

    # a prewarm window (the first two blocks' proofs) outside every timed
    # region: the kernel library builds or loads at its first launch
    probe = []
    st0 = ext.initial_state()
    for b in blocks[:2]:
        hdr = b.header
        view = ledger.forecast_view(st0.ledger, hdr.slot)
        ticked = protocol.tick_chain_dep_state(
            st0.header.chain_dep_state, view, hdr.slot)
        probe.extend(protocol.extract_proofs(ticked, hdr, view))
        st0 = ext.tick_then_apply(st0, b, backend=cpu)
    with log_compile_time(
            f"sharded window prewarm (mesh={n_devices})") as ct_pw:
        _pw_secs, pw_ok = backend.prewarm_window(probe, fold=True)
    obs["prewarm_compile_secs"] = ct_pw["secs"]
    assert pw_ok.all_ok, "prewarm window verdicts wrong"
    budget.check("prewarm")

    with log_compile_time(
            f"sharded validation step (mesh={n_devices})") as ct_val:
        res = validate_blocks_batched(ext, blocks[:WINDOW],
                                      ext.initial_state(), backend=backend)
    obs["sharded_validate_compile_secs"] = ct_val["secs"]
    assert res.all_valid, f"sharded validation failed: {res.error}"
    ref = validate_blocks_batched(ext, blocks[:WINDOW], ext.initial_state(),
                                  backend=cpu)
    assert (res.final_state.ledger.state_hash()
            == ref.final_state.ledger.state_hash()), "mesh/host mismatch"
    budget.check("sharded validate")

    # the beta cache for the whole chain through the sharded gamma8, in
    # bucket-sized chunks: every replay window then ships no beta slot
    all_proofs = protocol.vrf_proofs_of([b.header for b in blocks])
    with log_compile_time(
            f"beta prefetch ({len(all_proofs)} proofs, chunked)") as ct_b:
        for off in range(0, len(all_proofs), 8):
            GLOBAL_BETA_CACHE.prefetch(all_proofs[off:off + 8], backend)
    obs["beta_prefetch_secs"] = ct_b["secs"]
    budget.check("beta prefetch")

    # the sharded pipelined replay: producer/consumer, sharded windows,
    # the fold over the gathered buffer, state_hash parity
    pad0 = backend.padding_stats()     # delta: the replay's windows only
    with log_compile_time(
            f"sharded pipelined replay (mesh={n_devices})") as ct_pipe:
        t0 = time.perf_counter()
        piped = replay_blocks_pipelined(ext, blocks, ext.initial_state(),
                                        backend=backend, window=WINDOW)
        replay_secs = time.perf_counter() - t0
    obs["pipelined_replay_compile_secs"] = ct_pipe["secs"]
    assert piped.all_valid, f"pipelined mesh replay failed: {piped.error}"
    parity = piped.final_state.ledger.state_hash() == ref_hash
    assert parity, "pipelined mesh/host state hash mismatch"
    obs["state_hash_parity"] = True
    obs["sharded_replay"] = {
        "blocks": len(blocks),
        "window": WINDOW,
        "proofs": n_proofs,
        "secs": round(replay_secs, 3),
        "proofs_per_sec": round(n_proofs / replay_secs, 1),
        "state_hash_parity": bool(parity),
        "padding": backend.padding_stats(since=pad0),
    }
    budget.check("sharded pipelined replay")

    # the single-device comparison leg, budget-gated as the reference's
    if budget.remaining() > 300:
        single_be = TorchBackend(mesh.devices[0])
        with log_compile_time("single-device pipelined replay") as ct_sd:
            t0 = time.perf_counter()
            single = replay_blocks_pipelined(
                ext, blocks, ext.initial_state(), backend=single_be,
                window=WINDOW)
            sd_secs = time.perf_counter() - t0
        assert single.all_valid and \
            single.final_state.ledger.state_hash() == ref_hash, \
            "single-device pipelined replay parity violated"
        obs["single_device_replay"] = {
            "secs": round(sd_secs, 3),
            "proofs_per_sec": round(n_proofs / sd_secs, 1),
            "compile_secs": ct_sd["secs"],
        }
        budget.check("single-device replay")
    else:
        obs["single_device_replay_skipped"] = (
            f"budget-gated ({budget.remaining():.0f}s remaining)")

    # a tampered KES signature must be caught by the sharded path too
    bad = blocks[2]
    sig = bytearray(bad.header.get(KES_FIELD))
    sig[3] ^= 1
    tampered = list(blocks[:WINDOW])
    tampered[2] = ProtocolBlock(
        bad.header.with_fields(**{KES_FIELD: bytes(sig)}), bad.body)
    res2 = validate_blocks_batched(ext, tampered, ext.initial_state(),
                                   backend=backend)
    assert not res2.all_valid and res2.n_valid == 2, \
        f"tamper not caught: {res2.n_valid}"
    budget.check("tamper check")
    obs["elapsed_secs"] = round(budget.elapsed(), 1)
    _embed_metrics_snapshot(obs)
    print("MULTICHIP_OBS " + json.dumps(obs, sort_keys=True), flush=True)
    return obs, mesh_scaling_report(n_devices, budget=budget,
                                    devices=devices)


def mesh_scaling_report(n_devices: int, window: int = 16,
                        n_windows: int = 4, budget=None,
                        devices=None) -> dict:
    """The same window submitted `n_windows` times at mesh sizes 1 and
    n_devices (the first devices of `devices`): relative wall time, and
    a check that each window launched each kernel it carries exactly once
    a shard (`ShardLauncher.counts`: `kernels.LAUNCHES` on the card).
    Prints one JSON line and returns the dict."""
    sk = hashlib.sha256(b"mesh-scale").digest()
    vk = ed25519_ref.public_key(sk)
    vsk = hashlib.sha256(b"mesh-scale-vrf").digest()
    vvk = vrf_ref.public_key(vsk)
    reqs = []
    for i in range(window):
        m = b"m%03d" % i
        reqs.append(Ed25519Req(vk, m, ed25519_ref.sign(sk, m)))
        if i % 4 == 0:
            a = b"a%03d" % i
            reqs.append(VrfReq(vvk, a, vrf_ref.prove(vsk, a)))
    # the kernels a window of these requests launches (no betas, no KES)
    present = ("ed25519_split", "vrf_verify")

    out = {"window_reqs": len(reqs), "n_windows": n_windows,
           "dispatches_per_window": {}, "wall_secs": {},
           "compile_secs": {}}
    # largest mesh (the headline) first: with a budget, a smaller leg is
    # skipped rather than the whole report lost
    for d in sorted({1, n_devices}, reverse=True):
        floor = 180 if d != n_devices else 120
        if budget is not None and budget.remaining() < floor:
            out["skipped_mesh_sizes"] = out.get("skipped_mesh_sizes",
                                                []) + [d]
            continue
        backend = ShardedTorchBackend(make_mesh(d, devices=devices),
                                      min_bucket=max(16, 2 * d))
        # prewarm outside the timed region; its verdicts gate correctness
        with log_compile_time(f"mesh={d} window"):
            compile_secs, ok = backend.prewarm_window(reqs)
        out["compile_secs"][str(d)] = round(compile_secs, 3)
        assert all(ok), f"mesh={d}: prewarm window failed"
        counts = backend._shards.counts
        calls0 = dict(counts)
        t0 = time.perf_counter()
        pend = [backend.submit_window(reqs) for _ in range(n_windows)]
        for p in pend:
            ok, _ = backend.finish_window(p)
            assert all(ok)
        dt = time.perf_counter() - t0
        per_win = {k: (v - calls0[k]) / n_windows
                   for k, v in counts.items() if v != calls0[k]}
        want = {k: float(d) for k in present}
        assert per_win == want, \
            f"mesh={d}: shard launches per window {per_win} (want {want})"
        out["dispatches_per_window"][str(d)] = per_win
        out["wall_secs"][str(d)] = round(dt, 3)
        if budget is not None:
            budget.check(f"mesh={d} scaling leg")
    base = out["wall_secs"].get("1")
    worst = out["wall_secs"].get(str(n_devices))
    out["relative_wall_n_vs_1"] = (round(worst / base, 3)
                                   if base and worst is not None else None)
    print("MESH_SCALING " + json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--devices", default=None,
                    help="comma-separated torch devices (default: the "
                         "first N CUDA cards)")
    a = ap.parse_args(argv)
    devices = a.devices.split(",") if a.devices else None
    dryrun_multichip(a.n_devices, devices=devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
