"""The `ed25519_split` kernel's share of its roofline: the least time the
card could take for the Ed25519 lanes the window verified (roofline.py)
over the kernel's device time in the trace."""

import roofline


def read(run: dict):
    return roofline.share(run, "ed25519_split")
