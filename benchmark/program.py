"""The system under test, driven as a node's replay drives it.

Everything here is `ouroboros_tpu_torch`: its Shelley rules built from
the forged genesis, its block decoder, `TorchBackend` and
`replay_blocks_pipelined` with the bench's window.  The harness hands it
the forged bytes and reads back what a replay returns (its verdict, the
states after each verified window, the VRF outputs it cached) and the
program's own counters.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PassRecord:
    """What one replay of the chain returned."""
    variant: int                  # index into the chain's variants, -1: valid
    n_valid: int
    accepted: bool                # no error
    windows: list = field(default_factory=list)   # [(n_done, ext state)]
    betas: dict = field(default_factory=dict)     # proof -> beta, sampled


class Program:
    def __init__(self, genesis, device, window: int, min_bucket=None):
        from ouroboros_tpu_torch.consensus.batch import (
            replay_blocks_pipelined)
        from ouroboros_tpu_torch.consensus.headers import ProtocolBlock
        from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
        from ouroboros_tpu_torch.crypto import kernels
        from ouroboros_tpu_torch.crypto.backend import GLOBAL_BETA_CACHE
        from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
        from ouroboros_tpu_torch.eras.shelley import (
            ShelleyLedger, ShelleyTx, TPraos, TPraosConfig, pool_id_of)
        g = genesis
        cfg = TPraosConfig(k=g.k, f=g.f, epoch_length=g.epoch_length,
                           slots_per_kes_period=g.slots_per_kes_period,
                           kes_depth=g.kes_depth,
                           max_kes_evolutions=g.max_kes_evolutions)
        ledger = ShelleyLedger(
            dict(g.utxo), cfg,
            {pool_id_of(cold): vrf_vk for cold, vrf_vk in g.pools},
            dict(g.delegs))
        self.rules = ExtLedgerRules(TPraos(cfg, genesis_seed=g.seed), ledger)
        self.device = device
        self.window = window
        self.min_bucket = min_bucket
        self.kernels = kernels
        self.betas = GLOBAL_BETA_CACHE
        self._replay = replay_blocks_pipelined
        self._backend_cls = TorchBackend
        self._decode = lambda raw: ProtocolBlock.from_bytes(
            raw, tx_decode=ShelleyTx.decode, tx_body_elems=6)

    def rechain(self, blocks: list, headers: list) -> list:
        """`blocks` with their headers replaced by `headers` (CBOR), each
        decoded by the program's decoder; the decoded bodies are kept."""
        return [type(b)(self._decode(b"\x82" + h + b"\x80").header, b.body)
                for b, h in zip(blocks, headers)]

    def load_kernels(self) -> None:
        if self.device.type == "cuda":
            self.kernels.library()

    def decode(self, raw_blocks: list) -> list:
        return [self._decode(raw) for raw in raw_blocks]

    def backend(self):
        return self._backend_cls(self.device, min_bucket=self.min_bucket)

    def replay(self, blocks: list, backend, variant: int,
               beta_sample=()) -> PassRecord:
        """One replay from genesis, the beta cache cleared first, so no
        block's VRF output is served from an earlier pass."""
        self.betas.clear()
        rec = PassRecord(variant, 0, False)
        res = self._replay(self.rules, blocks, self.rules.initial_state(),
                           backend=backend, window=self.window,
                           on_window=lambda st, n, _pt:
                           rec.windows.append((n, st)))
        rec.n_valid, rec.accepted = res.n_valid, res.error is None
        for pi in beta_sample:
            if pi in self.betas:
                try:
                    rec.betas[pi] = self.betas.get(pi)
                except ValueError:
                    rec.betas[pi] = None
        return rec

    def launches(self) -> dict:
        return dict(self.kernels.LAUNCHES)


def digest(ext_state) -> dict:
    """A program state as plain values, the form the reference gives."""
    led = ext_state.ledger
    dep = ext_state.header.chain_dep_state
    return {
        "utxo": frozenset((t, i, a, m) if not assets else
                          (t, i, a, m, assets)
                          for (t, i), (a, m, assets)
                          in led.utxo.to_dict().items()),
        "counters": tuple(dep.counters),
        "eta0": dep.eta0, "eta_v": dep.eta_v, "eta_c": dep.eta_c,
        "eta_ph": dep.eta_ph, "epoch": dep.epoch,
        "tip_slot": led.tip.slot, "tip_hash": led.tip.hash,
        "blocks_made": tuple(led.blocks_made),
    }
