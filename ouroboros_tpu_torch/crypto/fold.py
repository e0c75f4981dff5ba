"""The verdict fold over a validation window's packed buffer, in PyTorch
ops: the plain version of the `window_fold` kernel (csrc/window_fold.cu).

Ported from `ouroboros_tpu/crypto/jax_backend.py` (`_fold_program`).
The packed buffer is [ed ok (ne) | vrf rows (nv x 130) | beta rows (nb x
33) | kes ok (nk)]; the fold returns the first failing request index
(FOLD_SENT for none) as 4 little-endian bytes, then the KES job flags and
the beta rows, so only those leave the device (torch_backend).
"""
from __future__ import annotations

import torch

from . import vrf as V

# fold sentinel: "no failing request" (int32 max beats every real index)
FOLD_SENT = 0x7FFFFFFF

# 32-bit instructions one VRF lane needs at the fewest, the kernel's bound
# (as blake2b.INT_OPS): a SHA-512 round is Sigma0 and Sigma1 (three 64-bit
# rotations, two funnel shifts each, and one three-input xor a half: 8
# each), Ch and Maj (one three-input logic instruction a half: 2 each) and
# five 64-bit adds of at most three operands (2 each); a schedule word is
# sigma0 and sigma1 (two rotations, a shift and a three-input xor: 8 each)
# and two three-operand adds; a compression is 80 rounds, 64 schedule words
# and the state's eight adds.  Two compressions, one instruction for each
# of the 146 bytes a lane assembles into words, and the compare.
INT_OPS = 2 * (80 * (8 + 8 + 2 + 2 + 5 * 2) + 64 * (8 + 8 + 2 * 2)
               + 8 * 2) + 146 + 4


def fold_window(packed, ne: int, nv: int, nb: int, nk: int,
                ed_own, vrf_own, gamma_b, c_b):
    """Verdict fold over one window's packed buffer (jax_backend
    _fold_program): the first failing request index (FOLD_SENT = none) as
    4 little-endian bytes, then the KES job flags and the beta rows.
    `ed_own` / `vrf_own` map lanes to request indices (FOLD_SENT for
    host-known failures and padding)."""
    mins = []
    off = 0
    sent = torch.full((), FOLD_SENT, dtype=torch.int64, device=packed.device)
    if ne:
        ed_ok = packed[:ne]
        mins.append(torch.where(ed_ok != 0, sent, ed_own.long()).min())
        off += ne
    if nv:
        rows = packed[off:off + nv * 130].view(nv, 130)
        ok = V.challenge_ok_device(rows, gamma_b, c_b)
        mins.append(torch.where(ok, sent, vrf_own.long()).min())
        off += nv * 130
    beta_part = packed[off:off + nb * 33]
    off += nb * 33
    kes_part = packed[off:off + nk]
    m = torch.stack(mins).min() if mins else sent
    shifts = torch.tensor([0, 8, 16, 24], device=packed.device)
    idx4 = ((m >> shifts) & 0xFF).to(torch.uint8)
    return torch.cat([idx4, kes_part, beta_part])
