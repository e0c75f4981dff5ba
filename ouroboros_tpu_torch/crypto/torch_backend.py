"""TorchBackend — the port's CryptoBackend for the validation window.

Ported from `ouroboros_tpu/crypto/jax_backend.py`.  A replay window's
whole device workload (the mixed Ed25519 / VRF / KES verification of its
requests plus the VRF betas the NEXT window's sequential pass needs) is
submitted at once: the four CUDA kernels (kernels.py) and, with
`fold=True`, the verdict fold (the `window_fold` kernel) are enqueued on
the backend's own stream into one packed uint8 buffer with the JAX
layout, copied without blocking into pinned host memory, and an event is
recorded.  `finish_window`
waits on that event.  Two windows can be in flight: the producer packs
and submits window w+1 while the consumer drains window w.

Packed layout: [ed ok (ne) | vrf rows (nv x 130) | beta rows (nb x 33) |
kes ok (nk)], and after the fold [first-bad index, uint32 LE | kes ok |
beta rows].  Batches are padded to power-of-two buckets with a floor of
128 lanes.

On a CUDA device the kernels always run; on the CPU (`device="cpu"`) the
wrappers run their plain PyTorch versions.  There is no autotuner.
Host inputs are staged through pinned memory so that submitting a window
does not wait for the previous window's kernels.

Each backend keeps its own `PrecomputeCache` (per-key Ed25519 / VRF
entries and KES hash-path outcomes), where every JAX backend shares
`GLOBAL_PRECOMPUTE_CACHE`: a fresh backend starts KES-cold and fills
every key again, so each replay on a fresh backend launches the same
kernels and runs on the card compare.  Verdicts do not depend on the
choice, only which windows are KES-cold.

Every kernel launch goes through `_launch_lanes` (host arrays, lane axis
last, staged and launched once); the sharded backend
(parallel/sharded_verify.py) overrides it to split the lanes over its
shards, and inherits the rest.

Spans (observe/spans.py, recorded only when enabled): `window.submit`
around a submit's host work, and `window.drain` around finish_window's
wait and parse.  Inside `window.submit`, in a window's order:
`submit.split` (the request split and the cold KES path walks),
`submit.pack` (each host packer: Ed25519, VRF, betas, KES jobs),
`precompute.assemble` (the key cache's lookups and column copies, with
`precompute.fill` and its `precompute.fill_wait` inside it on missing
keys), `submit.launch` (each kernel's staging and launch),
`submit.attach` (the fold's host-known failures and lane owners) and
then `window.fold` (the verdict fold's one staging copy and its
launch).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..observe import spans as _spans
from . import blake2b as B2
from . import ed25519 as E
from . import kernels as K
from . import kes as kes_mod
from . import vrf as V
from .backend import (CryptoBackend, Ed25519Req, KesReq, VrfReq,
                      WindowVerdict)
from .fold import FOLD_SENT, fold_window  # noqa: F401  (a re-export)
from .precompute import PrecomputeCache

MIN_BUCKET = 128


def _bucket(n: int, floor: int) -> int:
    m = floor
    while m < n:
        m *= 2
    return m


def _pad_words(w: np.ndarray, m: int) -> np.ndarray:
    """Pad the lane axis of a words/sign array out to m columns."""
    n = w.shape[-1]
    if n == m:
        return w
    pad = [(0, 0)] * (w.ndim - 1) + [(0, m - n)]
    return np.pad(w, pad)


def stage(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`.  On CUDA the array is copied into
    pinned memory and then to the card without blocking, on the current
    stream, so staging does not wait for the kernels queued before it."""
    t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class TorchBackend(CryptoBackend):
    name = "torch"
    supports_window_fold = True
    # largest single gamma8 batch in vrf_betas_batch
    BETA_CHUNK = 2048
    # the floor of the padding ladder (_bucket), which VerifyService reads
    # to count a flush's padded lanes
    min_bucket = MIN_BUCKET

    def __init__(self, device=None, min_bucket: Optional[int] = None):
        """`min_bucket` lowers (or raises) this backend's padding floor,
        as the JAX backend's `min_bucket` does; None keeps MIN_BUCKET."""
        self.device = device_mod.resolve(device)
        if min_bucket is not None:
            self.min_bucket = min_bucket
        self.cache = PrecomputeCache(self.device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._lanes_used = 0
        self._lanes_padded = 0
        self._windows_padded = 0

    @property
    def device_kind(self) -> str:
        return device_mod.device_kind(self.device)

    @property
    def n_shards(self) -> int:
        return 1

    def _pad(self, n: int) -> int:
        return _bucket(n, self.min_bucket)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor (pinned staging on CUDA, so the copy
        is queued on the stream instead of waiting for it)."""
        return stage(a, self.device)

    def _launch_lanes(self, kernel: str, arrays) -> torch.Tensor:
        """Launch `kernel` (a wrapper of kernels.py) once on host arrays
        whose last axis is the lane axis, staged onto the device on the
        current stream; returns its device output (lanes on axis 0).  The
        sharded backend (parallel/sharded_verify.py) splits the lanes over
        its shards here."""
        return getattr(K, kernel)(*(self._dev(a) for a in arrays))

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._cuda
                else contextlib.nullcontext())

    # -- lane occupancy ------------------------------------------------------
    def _note_padding(self, used: int, padded: int) -> None:
        self._lanes_used += used
        self._lanes_padded += padded
        self._windows_padded += 1

    def padding_stats(self, since: Optional[dict] = None) -> dict:
        """Lane occupancy over every window this instance submitted
        (`since`: a previously returned dict, for the delta)."""
        used, padded = self._lanes_used, self._lanes_padded
        windows = self._windows_padded
        if since is not None:
            used -= since["lanes_used"]
            padded -= since["lanes_padded"]
            windows -= since["windows"]
        return {
            "windows": windows,
            "lanes_used": used,
            "lanes_padded": padded,
            "waste_frac": round(1.0 - used / padded, 4) if padded else 0.0,
            "shards": self.n_shards,
            "lanes_per_shard_per_window":
                padded // (self.n_shards * max(windows, 1)),
        }

    def prewarm_window(self, reqs, next_beta_proofs=(), fold: bool = False):
        """Run one full window now; returns (wall seconds, verdicts)."""
        t0 = time.perf_counter()
        ok, _ = self.finish_window(
            self.submit_window(reqs, next_beta_proofs, fold=fold))
        return time.perf_counter() - t0, ok

    # -- host prep -------------------------------------------------------------
    def _prep_ed(self, reqs, m: int):
        """Packed-words host arrays (`ed25519_split`'s arguments) + per-key
        entries for an Ed25519 batch padded to m; keys the cache could not
        decompress are masked out of parse_ok."""
        pad = m - len(reqs)
        with _spans.span("submit.pack", cat="dispatch"):
            vks = [r.vk for r in reqs] + [b"\x00" * 32] * pad
            arrays, parse_ok = E.prepare_words_batch(
                vks, [r.msg for r in reqs] + [b""] * pad,
                [r.sig for r in reqs] + [b"\x00" * 64] * pad)
        Aw, _signA, Rw, signR, sw, kw = arrays
        xa, xw, yw, known = self.cache.assemble(vks)
        return (Aw, xa, xw, yw, Rw, signR, sw, kw), parse_ok & known

    def _prep_vrf(self, reqs, m: int):
        pad = m - len(reqs)
        with _spans.span("submit.pack", cat="dispatch"):
            vks = [r.vk for r in reqs] + [b"\x00" * 32] * pad
            args, parse_ok, gamma_ok, s_ok, pf_arr = V._prepare_words(
                vks, [r.alpha for r in reqs] + [b""] * pad,
                [r.proof for r in reqs] + [b"\x00" * 80] * pad)
        Yw, _signY, Gw, signG, rw, cw, sw = args
        xa, _x128, _y128, known = self.cache.assemble(vks)
        return ((Yw, xa, Gw, signG, rw, cw, sw),
                (parse_ok & known, gamma_ok, s_ok, pf_arr))

    def _prep_betas(self, proofs, m: int):
        padded = list(proofs) + [b"\x00" * 80] * (m - len(proofs))
        (Gw, signG), decode_ok = V._prepare_betas_words(padded)
        return (Gw, signG), decode_ok

    def _prep_kes_hash(self, kes_msgs, kes_expects, m: int):
        with _spans.span("submit.pack", cat="dispatch"):
            msgs = np.frombuffer(b"".join(kes_msgs), dtype=np.uint8)
            exps = np.frombuffer(b"".join(kes_expects), dtype=np.uint8)
            mw = _pad_words(B2.msg_words(msgs.reshape(-1, 64)), m)
            ew = _pad_words(B2.digest_words(exps.reshape(-1, 32)), m)
        return mw, ew

    # -- simple batches ----------------------------------------------------------
    def verify_ed25519_batch(self, reqs):
        if not reqs:
            return []
        n = len(reqs)
        with self._on_stream():
            args, parse_ok = self._prep_ed(reqs, self._pad(n))
            ok = self._launch_lanes("ed25519_split", args).cpu().numpy()
        return [bool(o) and bool(p) for o, p in zip(ok[:n], parse_ok[:n])]

    def verify_vrf_batch(self, reqs):
        """The `vrf_verify` kernel, then the challenge checked on the host
        from its rows (`vrf._finish`, as `vrf.batch_verify_vrf` does): at
        a service flush's 128-256 lanes the torch-op SHA-512 of
        `challenge_ok_device` is a fixed cost of some thousand launches
        that outweighs 128 CPU verifies (PERF.md §6)."""
        if not reqs:
            return []
        n = len(reqs)
        with self._on_stream():
            args, (parse_ok, gamma_ok, s_ok, pf_arr) = self._prep_vrf(
                reqs, self._pad(n))
            rows = self._launch_lanes("vrf_verify", args).cpu().numpy()
        oks, _betas = V._finish(rows, parse_ok, gamma_ok, s_ok, pf_arr, n)
        return oks

    def vrf_betas_batch(self, proofs):
        n = len(proofs)
        if n == 0:
            return []
        if n > self.BETA_CHUNK:
            out = []
            for off in range(0, n, self.BETA_CHUNK):
                out.extend(self.vrf_betas_batch(
                    proofs[off:off + self.BETA_CHUNK]))
            return out
        with self._on_stream():
            args, decode_ok = self._prep_betas(proofs, self._pad(n))
            rows = self._launch_lanes("gamma8", args).cpu().numpy()
        return V._finish_betas(rows, decode_ok, n)

    def verify_kes_batch(self, reqs):
        return self.verify_mixed(reqs)

    def verify_mixed(self, reqs):
        ok, _betas = self.finish_window(self.submit_window(reqs))
        return ok

    # -- mixed windows -------------------------------------------------------
    def _split_mixed_device(self, reqs):
        """Like CryptoBackend.split_mixed but hash-free: cold KES hash
        paths become Blake2b jobs for the `kes_hash` kernel, warm ones are
        served from the cache, and identical cold paths within the window
        collapse to one job slice.  Returns (ed_reqs, ed_owner, vrf_reqs,
        vrf_owner, kes_msgs, kes_expects, kes_checks, n); kes_checks lists
        (key, job_start, n_jobs, owners, leaf_vk) for finish_window."""
        cache = self.cache
        ed_reqs: list = []
        ed_owner: list[int] = []
        vrf_reqs: list = []
        vrf_owner: list[int] = []
        kes_msgs: list[bytes] = []
        kes_expects: list[bytes] = []
        pending: dict = {}     # key -> [start, n_jobs, owners, leaf_vk]
        for i, r in enumerate(reqs):
            if isinstance(r, Ed25519Req):
                ed_reqs.append(r)
                ed_owner.append(i)
            elif isinstance(r, VrfReq):
                vrf_reqs.append(r)
                vrf_owner.append(i)
            elif isinstance(r, KesReq):
                key = kes_mod.hash_path_key(r.depth, r.vk, r.period,
                                            r.sig_bytes)
                if key is None:
                    continue          # structurally invalid: stays False
                ent = cache.kes_get(key)
                if ent is not None:                     # warm path
                    leaf_vk, path_ok = ent
                    if not path_ok:
                        continue      # known-bad hash path: stays False
                elif key in pending:  # cold, already scheduled here
                    pend = pending[key]
                    pend[2].append(i)
                    leaf_vk = pend[3]
                else:                                   # cold path
                    sig = kes_mod.KesSig.from_bytes(r.depth, r.sig_bytes)
                    leaf_vk, _leaf_sig, jobs = kes_mod.verify_walk(
                        r.depth, r.vk, r.period, sig)
                    start = len(kes_msgs)
                    for msg, expect in jobs:
                        kes_msgs.append(msg)
                        kes_expects.append(expect)
                    pending[key] = [start, len(jobs), [i], leaf_vk]
                ed_reqs.append(Ed25519Req(leaf_vk, r.msg, r.sig_bytes[:64]))
                ed_owner.append(i)
            else:
                raise TypeError(f"unknown proof request type {type(r)}")
        kes_checks = [(key, start, nj, owners, leaf_vk)
                      for key, (start, nj, owners, leaf_vk)
                      in pending.items()]
        return (ed_reqs, ed_owner, vrf_reqs, vrf_owner,
                kes_msgs, kes_expects, kes_checks, len(reqs))

    def submit_window(self, reqs, next_beta_proofs=(), fold: bool = False):
        """Enqueue one window's device workload and return an opaque state
        for finish_window.  With fold=True the per-proof verdicts never
        leave the device: finish_window returns a WindowVerdict."""
        with self._on_stream(), _spans.span("window.submit",
                                            cat="dispatch"):
            return self._submit_window(reqs, next_beta_proofs, fold)

    def _submit_window(self, reqs, next_beta_proofs, fold):
        with _spans.span("submit.split", cat="dispatch"):
            (ed_reqs, ed_owner, vrf_reqs, vrf_owner,
             kes_msgs, kes_expects, kes_checks, n) = \
                self._split_mixed_device(reqs)
        beta_proofs = list(dict.fromkeys(next_beta_proofs))
        ne = nv = nb = nk = 0
        parts = []
        state = {"n": n, "ed": None, "ed_owner": ed_owner,
                 "vrf": None, "vrf_owner": vrf_owner,
                 "vrf_n": len(vrf_reqs), "beta": None,
                 "beta_proofs": beta_proofs, "kes_checks": kes_checks}
        if ed_reqs:
            ne = self._pad(len(ed_reqs))
            args, parse_ok = self._prep_ed(ed_reqs, ne)
            state["ed"] = parse_ok
            with _spans.span("submit.launch", cat="dispatch"):
                parts.append(self._launch_lanes("ed25519_split", args)
                             .to(torch.uint8))
        if vrf_reqs:
            nv = self._pad(len(vrf_reqs))
            args, masks = self._prep_vrf(vrf_reqs, nv)
            state["vrf"] = masks
            with _spans.span("submit.launch", cat="dispatch"):
                parts.append(self._launch_lanes("vrf_verify", args)
                             .reshape(-1))
        if beta_proofs:
            nb = self._pad(len(beta_proofs))
            # spanned here, not in _prep_betas: a replay's beta prefetch
            # (vrf_betas_batch) packs outside any window's seam
            with _spans.span("submit.pack", cat="dispatch"):
                args, decode_ok = self._prep_betas(beta_proofs, nb)
            state["beta"] = decode_ok
            with _spans.span("submit.launch", cat="dispatch"):
                parts.append(self._launch_lanes("gamma8", args).reshape(-1))
        if kes_msgs:
            nk = self._pad(len(kes_msgs))
            args = self._prep_kes_hash(kes_msgs, kes_expects, nk)
            with _spans.span("submit.launch", cat="dispatch"):
                parts.append(self._launch_lanes("kes_hash", args)
                             .to(torch.uint8))
        state.update(ne=ne, nv=nv, nb=nb, nk=nk)
        self._note_padding(
            len(ed_reqs) + len(vrf_reqs) + len(beta_proofs) + len(kes_msgs),
            ne + nv + nb + nk)
        packed = torch.cat(parts) if parts else None
        if fold:
            packed = self._attach_fold(state, packed)
        state["host"], state["event"] = self._to_host(packed)
        return state

    def _to_host(self, packed):
        """Start the result's copy to the host; (host tensor, event)."""
        if packed is None or not self._cuda:
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self._stream)
        return host, event

    def _attach_fold(self, state, packed):
        """Merge host-known failures (undecodable keys and signatures,
        structurally invalid or known-bad KES paths) into
        `host_first_bad` and fold the packed buffer on device."""
        with _spans.span("submit.attach", cat="dispatch"):
            ed_own, vrf_own, gamma_b, c_b = self._fold_owners(state)
        if packed is None:
            return None
        with _spans.span("window.fold", cat="dispatch"):
            return self._fold(packed, state["ne"], state["nv"], state["nb"],
                              state["nk"], ed_own, vrf_own, gamma_b, c_b)

    def _fold(self, packed, ne: int, nv: int, nb: int, nk: int, ed_own,
              vrf_own, gamma_b, c_b) -> torch.Tensor:
        """The `window_fold` kernel over `packed` (on this device) with the
        host arrays of `_fold_owners`, staged as one buffer (one pinned
        copy on CUDA) of which the kernel's four inputs are views."""
        parts = [np.ascontiguousarray(a).view(np.uint8).reshape(-1)
                 for a in (ed_own, vrf_own, gamma_b, c_b)]
        host = np.concatenate(parts)
        # a window of betas and KES jobs alone has no lanes to stage (and
        # an empty array comes in with stride 0, which no dtype view takes)
        buf = (self._dev(host) if host.size else
               torch.empty(0, dtype=torch.uint8, device=self.device))
        ed_t, vrf_t, gamma_t, c_t = torch.split(buf, [p.size for p in parts])
        return K.window_fold(packed, ne, nv, nb, nk, ed_t.view(torch.int32),
                             vrf_t.view(torch.int32), gamma_t.view(nv, 32),
                             c_t.view(nv, 16))

    def _fold_owners(self, state):
        """The fold's host side: sets `host_first_bad` in `state` and
        returns the lane-to-request maps and the VRF proofs' gamma and c
        bytes that `_fold` stages for the `window_fold` kernel."""
        n = state["n"]
        ne, nv = state["ne"], state["nv"]
        covered = np.zeros(max(n, 1), dtype=bool)
        host_bad = FOLD_SENT
        ed_own = np.full(ne, FOLD_SENT, np.int32)
        if state["ed"] is not None:
            po = np.asarray(state["ed"], dtype=bool)
            for k, i in enumerate(state["ed_owner"]):
                covered[i] = True
                if po[k]:
                    ed_own[k] = i
                elif i < host_bad:
                    host_bad = i
        vrf_own = np.full(nv, FOLD_SENT, np.int32)
        gamma_b = np.zeros((nv, 32), np.uint8)
        c_b = np.zeros((nv, 16), np.uint8)
        if state["vrf"] is not None:
            parse_ok, _gok, _sok, pf_arr = state["vrf"]
            pv = np.asarray(parse_ok, dtype=bool)
            gamma_b = pf_arr[:, :32]
            c_b = pf_arr[:, 32:48]
            for k, i in enumerate(state["vrf_owner"]):
                covered[i] = True
                if pv[k]:
                    vrf_own[k] = i
                elif i < host_bad:
                    host_bad = i
        uncovered = np.flatnonzero(~covered[:n])
        if uncovered.size and uncovered[0] < host_bad:
            host_bad = int(uncovered[0])
        state["fold"] = True
        state["host_first_bad"] = host_bad
        return ed_own, vrf_own, gamma_b, c_b

    def finish_window(self, state):
        """Wait for a submit_window's result (one copy); returns (ok list
        aligned with the submitted reqs, {proof: beta} for the requested
        next-window proofs), or (WindowVerdict, betas) for fold=True."""
        with _spans.span("window.drain", cat="device"):
            return self._finish_window(state)

    def _finish_window(self, state):
        flat = None
        if state["host"] is not None:
            if state["event"] is not None:
                state["event"].synchronize()
            flat = state["host"].numpy()
        if state.get("fold"):
            return self._finish_window_fold(state, flat)
        out = [False] * state["n"]
        betas: dict = {}
        if flat is None:
            return out, betas
        off = 0
        if state["ed"] is not None:
            ed_ok = flat[off:off + state["ne"]]
            off += state["ne"]
            for k, i in enumerate(state["ed_owner"]):
                out[i] = bool(ed_ok[k]) and bool(state["ed"][k])
        if state["vrf"] is not None:
            rows = flat[off:off + state["nv"] * 130].reshape(-1, 130)
            off += state["nv"] * 130
            parse_ok, gamma_ok, s_ok, pf_arr = state["vrf"]
            oks, _b = V._finish(rows, parse_ok, gamma_ok, s_ok, pf_arr,
                                state["vrf_n"])
            for i, ok in zip(state["vrf_owner"], oks):
                out[i] = ok
        failed, betas = self._drain_kes_betas(
            state, flat, kes_off=off + state["nb"] * 33, beta_off=off)
        for i in failed:
            out[i] = False
        return out, betas

    def _drain_kes_betas(self, state, flat, kes_off: int, beta_off: int):
        """Record the cold KES paths' outcomes from the job flags at
        `kes_off` and parse the beta rows at `beta_off`: (owners of the
        paths that failed, {proof: beta})."""
        kes_ok = flat[kes_off:kes_off + state["nk"]]
        failed: list[int] = []
        for key, start, n_jobs, owners, leaf_vk in state["kes_checks"]:
            path_ok = bool(np.all(kes_ok[start:start + n_jobs]))
            self.cache.kes_put(key, leaf_vk, path_ok)
            if not path_ok:
                failed.extend(owners)
        betas: dict = {}
        if state["beta"] is not None:
            rows = flat[beta_off:beta_off + state["nb"] * 33].reshape(-1, 33)
            betas = dict(zip(state["beta_proofs"], V._finish_betas(
                rows, state["beta"], len(state["beta_proofs"]))))
        return failed, betas

    def _finish_window_fold(self, state, flat):
        n = state["n"]
        betas: dict = {}
        bad = state["host_first_bad"]
        if flat is not None:
            bad = min(bad, int.from_bytes(flat[:4].tobytes(), "little"))
            failed, betas = self._drain_kes_betas(
                state, flat, kes_off=4, beta_off=4 + state["nk"])
            bad = min([bad, *failed])
        return WindowVerdict(n, None if bad >= FOLD_SENT else bad), betas
