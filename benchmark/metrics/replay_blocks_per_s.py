"""Blocks checked a second: every block that each whole pass checked (the
whole chain, or a tampered form's blocks to the end of its tampered
block's window) over the time from the first pass's start to the last
pass's final drain."""


def read(run: dict):
    return run["blocks"] / run["window_s"]
