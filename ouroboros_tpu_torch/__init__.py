"""ouroboros_tpu_torch — the PyTorch/CUDA port of ouroboros_tpu.

The JAX package (`ouroboros_tpu`) stays the reference; this package grows
beside it and imports none of it.  The first slice is the Shelley
validation window: the `CryptoBackend` seam that the full-crypto replay
drives once per window (Ed25519 split verify, ECVRF verify, the next
window's [8]Gamma betas and cold KES Blake2b hash paths), as hand-written
CUDA kernels for Hopper with plain PyTorch versions beside them.  The
in-memory Shelley replay drives that seam: the consensus core, the
Shelley era and the pipelined replay driver (consensus/, eras/), a forger
of the replayed chain (chainsynth.py) and its entry point (replay.py).  The
on-disk replay reads that chain, or a Byron->Shelley one, from an
ImmutableDB: the storage layer (storage/), the hard-fork combinator
(consensus/hardfork/), the Byron and Cardano eras, and the tools that
write and replay a DB (db_synth.py, db_analyser.py).

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`), which runs the plain PyTorch versions.
"""
