"""The `vrf_verify` kernel's share of its roofline: the least time the card
could take for the VRF lanes the window verified (roofline.py) over the
kernel's device time in the trace."""

import roofline


def read(run: dict):
    return roofline.share(run, "vrf_verify")
