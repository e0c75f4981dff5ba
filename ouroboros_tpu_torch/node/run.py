"""Node orchestration — the `run` entry point with crash-recovery policy.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Node.hs:203-301
(`run`/`runWith`: checked DB open -> ChainDB -> blockchain time ->
NodeKernel -> applications), Node/DbMarker.hs (magic file guarding against
pointing a node at another network's DB), Node/Recovery.hs:6-50 (the
clean-shutdown marker: present -> fast open; absent -> the previous run
crashed, so deep-validate every chunk), Node/DbLock.hs (double-open
guard — utils/registry.FileLock, used by callers with on-disk DBs).

The assembly is sim-first: `run_node` builds markers + ChainDB + kernel
over any FsApi and returns a handle whose `stop()` records the clean
shutdown; `was_clean_shutdown` decides the validation depth the same way
stdWithCheckedDB does.

Ported from `ouroboros_tpu/node/run.py` (the port imports nothing of the JAX
package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from .. import simharness as sim
from ..storage.chaindb import ChainDB
from ..storage.fs import FsApi
from ..storage.ledgerdb import DiskPolicy
from ..consensus.mempool import Mempool
from .blockchain_time import BlockchainTime
from .kernel import NodeKernel

MARKER_FILE = ("dbmarker",)            # DbMarker.hs `protocolMagicId`
CLEAN_FILE = ("clean_shutdown",)       # Recovery.hs marker


class WrongNetworkError(Exception):
    """The DB belongs to a different network magic (DbMarker.hs)."""


def check_db_marker(fs: FsApi, network_magic: int) -> None:
    """Create-or-verify the magic marker (DbMarker.hs lockDbMarkerFile)."""
    if fs.exists(MARKER_FILE):
        raw = fs.read_file(MARKER_FILE)
        try:
            found = int(raw.decode().strip())
        except (UnicodeDecodeError, ValueError) as e:
            raise WrongNetworkError(
                f"DB marker is corrupt ({raw[:32]!r}); refusing to open "
                f"— remove it only if this DB really is for magic "
                f"{network_magic}") from e
        if found != network_magic:
            raise WrongNetworkError(
                f"DB marker has magic {found}, node runs {network_magic}")
    else:
        fs.write_file(MARKER_FILE, str(network_magic).encode())


def was_clean_shutdown(fs: FsApi) -> bool:
    """True when the previous run stopped cleanly (Recovery.hs:6-50);
    consumed by run_node — a crash means every chunk gets revalidated."""
    return fs.exists(CLEAN_FILE)


@dataclass
class RunNodeArgs:
    """The RunNodeArgs/ProtocolInfo bundle (Node.hs:130-170)."""
    fs: FsApi
    ext_rules: Any
    encode_state: Callable
    decode_state: Callable
    block_decode: Callable
    btime: BlockchainTime
    forgings: Sequence = ()
    label: str = "node"
    network_magic: int = 0
    backend: Any = None
    chain_sync_window: int = 32
    header_decode: Optional[Callable] = None
    block_decode_obj: Optional[Callable] = None
    tx_decode: Optional[Callable] = None
    with_mempool: bool = True
    chunk_size: int = 100
    max_blocks_per_file: int = 50
    disk_policy: DiskPolicy = field(default_factory=DiskPolicy)


@dataclass
class NodeHandle:
    kernel: NodeKernel
    fs: FsApi
    deep_validated: bool

    def stop(self) -> None:
        """Clean shutdown: stop threads, then record the marker — the next
        open skips deep validation (Recovery.hs)."""
        self.kernel.stop()
        self.fs.write_file(CLEAN_FILE, b"1")


def run_node(args: RunNodeArgs) -> NodeHandle:
    """The `run` assembly (Node.hs:203-301):

    1. DbMarker check (right network), clean-shutdown marker decides the
       validation depth, then the marker is REMOVED — only a clean stop()
       rewrites it, so a crash leaves it absent.
    2. ChainDB.open (snapshot + replay + initial chain selection).
    3. NodeKernel with mempool + forging + background pipeline, started.

    On-disk callers additionally hold utils.registry.FileLock around the
    DB directory (DbLock.hs); MockFS sims have no cross-process opens."""
    check_db_marker(args.fs, args.network_magic)
    clean = was_clean_shutdown(args.fs)
    if clean:
        args.fs.remove(CLEAN_FILE)
    db = ChainDB.open(
        args.fs, args.ext_rules, args.encode_state, args.decode_state,
        args.block_decode, chunk_size=args.chunk_size,
        max_blocks_per_file=args.max_blocks_per_file,
        backend=args.backend, disk_policy=args.disk_policy,
        validate_chunks=not clean)       # crash -> deep validation
    mempool = None
    if args.with_mempool:
        mempool = Mempool(args.ext_rules.ledger,
                          lambda db=db: (db.current_ledger.ledger,
                                         db.tip_point()),
                          backend=args.backend)
    kernel = NodeKernel(
        db, args.ext_rules.ledger, mempool, args.btime,
        list(args.forgings), label=args.label, backend=args.backend,
        chain_sync_window=args.chain_sync_window,
        header_decode=args.header_decode,
        block_decode_obj=args.block_decode_obj,
        tx_decode=args.tx_decode)
    kernel.network_magic = args.network_magic
    kernel.start()
    sim.trace_event(("node-run", args.label,
                     "fast-open" if clean else "deep-validation"))
    return NodeHandle(kernel, args.fs, deep_validated=not clean)
