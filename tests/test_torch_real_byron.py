"""Real-bytes Byron header/block conformance on the port
(`ouroboros_tpu_torch/eras/byron_cbor.py`): the cases of
tests/test_real_byron.py.  Every case reads the reference checkout and
skips without it, as the reference's do; no Byron golden bytes are
vendored.

Parses the reference's golden Byron bytes in every shipped encoding
(byron-test node-to-node + disk dialects, cardano-test HFC wrappers),
re-encodes byte-identically, and pins the header-hash construction
against the reference's own golden `disk/HeaderHash`.
"""
import os

import pytest

from ouroboros_tpu_torch.eras import byron_cbor as BC

BYRON = "/root/reference/ouroboros-consensus-byron-test/test/golden"
CARDANO = ("/root/reference/ouroboros-consensus-cardano-test/test/golden/"
           "CardanoNodeToNodeVersion3")


def _load(path):
    if not os.path.exists(path):
        pytest.skip("reference not mounted")
    return open(path, "rb").read()


class TestByronHeaders:
    def test_regular_header_fields(self):
        hdr = BC.parse_header(_load(f"{BYRON}/ByronNodeToNodeVersion1/"
                                    "Header_regular"))
        assert not hdr.is_ebb
        assert hdr.magic == 55550001
        assert (hdr.epoch, hdr.slot) == (0, 1)
        assert len(hdr.issuer_xpub) == 64
        assert len(hdr.prev_hash) == 32

    def test_ebb_header_fields(self):
        hdr = BC.parse_header(_load(f"{BYRON}/ByronNodeToNodeVersion1/"
                                    "Header_EBB"))
        assert hdr.is_ebb
        assert hdr.slot is None and hdr.issuer_xpub is None
        assert hdr.epoch == 0

    def test_hfc_wrapped_forms_agree_on_fields(self):
        plain = BC.parse_header(_load(f"{BYRON}/ByronNodeToNodeVersion1/"
                                      "Header_regular"))
        hfc = BC.parse_header(_load(f"{CARDANO}/Header_Byron_regular"))
        assert hfc == plain
        assert BC.parse_header(_load(f"{CARDANO}/Header_Byron_EBB")).is_ebb

    def test_header_hash_matches_reference_golden(self):
        """blake2b(cbor([1, header])) == the reference's own HeaderHash
        golden — byte-exact external conformance of the hash scheme."""
        from ouroboros_tpu_torch.utils import cbor
        golden = cbor.loads(_load(f"{BYRON}/disk/HeaderHash"))
        for path in (f"{CARDANO}/Header_Byron_regular",
                     f"{BYRON}/ByronNodeToNodeVersion1/Header_regular"):
            assert BC.parse_header(_load(path)).header_hash == golden


class TestByronBlocks:
    def test_regular_block(self):
        raw = _load(f"{BYRON}/ByronNodeToNodeVersion1/Block_regular")
        blk = BC.parse_block(raw)
        assert not blk.header.is_ebb
        assert blk.n_txs >= 1
        assert blk.to_wrapped_cbor() == raw

    def test_ebb_block(self):
        raw = _load(f"{BYRON}/ByronNodeToNodeVersion1/Block_EBB")
        blk = BC.parse_block(raw)
        assert blk.header.is_ebb and blk.n_txs == 0
        assert blk.to_wrapped_cbor() == raw

    def test_block_header_slice_hashes_to_the_golden_hash(self):
        from ouroboros_tpu_torch.utils import cbor
        blk = BC.parse_block(_load(f"{BYRON}/ByronNodeToNodeVersion1/"
                                   "Block_regular"))
        golden = cbor.loads(_load(f"{BYRON}/disk/HeaderHash"))
        assert blk.header.header_hash == golden

    def test_disk_dialect(self):
        blk = BC.parse_block(_load(f"{BYRON}/disk/Block_regular"))
        assert not blk.header.is_ebb
        ebb = BC.parse_block(_load(f"{BYRON}/disk/Block_EBB"))
        assert ebb.header.is_ebb


def test_bare_pretagged_pair_roundtrips():
    """parse_header(cbor([1, header])) — the bare pre-tagged pair outside
    any tag-24 envelope — slices to the inner header and hashes right
    (regression: the HFC-wrapper check used to swallow this shape)."""
    from ouroboros_tpu_torch.utils import cbor
    raw = _load(f"{CARDANO}/Header_Byron_regular")
    full = BC.parse_header(raw)
    pair = b"\x82\x01" + full.raw
    reparsed = BC.parse_header(pair)
    assert reparsed.raw == full.raw
    assert reparsed.header_hash == full.header_hash
    ebb_raw = BC.parse_header(_load(f"{CARDANO}/Header_Byron_EBB")).raw
    assert BC.parse_header(b"\x82\x00" + ebb_raw).is_ebb
