"""The yardstick of the kernels' rooflines, frozen here.

The work of one verification, whatever later implements it: 32-bit
multiply-adds (the port's count of its split Ed25519 verification and of
a VRF verification, PERF.md §6) and the bytes its inputs and its verdict
need, read once and written once.  The card's peak: 132 SMs x 64
multiply-adds a clock x 1980 MHz, the H100 SXM's published boost clock
(not the clock the card ran at), and 3.35 TB/s of HBM3.  The least time
of a lane is the larger of its operations over the first and its bytes
over the second; a kernel's share is the least time of the real, unpadded
lanes the window verified over the kernel's device time in the trace.
"""

PEAK_OPS = 132 * 64 * 1980e6          # 32-bit multiply-adds a second
PEAK_BYTES = 3.35e12                  # bytes a second

# kernel -> (name in the trace, lanes key of the run, operations a lane,
# bytes a lane)
KERNELS = {
    # A, R, s and the hash scalar k in; one verdict byte out
    "ed25519_split": ("ed25519_split_kernel", "ed_lanes", 208_330, 129),
    # Y, Gamma, c, s and the hash-to-curve input in; a 130-byte row out
    "vrf_verify": ("vrf_verify_kernel", "vrf_lanes", 565_140, 274),
}


def least_seconds(kernel: str, lanes: int) -> float:
    _name, _key, ops, nbytes = KERNELS[kernel]
    return lanes * max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


def share(run: dict, kernel: str):
    """Percent of the roofline, or None where the trace holds no launch."""
    tr = run["trace"]
    if not tr:
        return None
    name, key, _ops, _bytes = KERNELS[kernel]
    device_s = sum(s for n, s in tr["kernel_s"].items() if name in n)
    if not device_s or not run[key]:
        return None
    return 100.0 * least_seconds(kernel, run[key]) / device_s
