"""The device (one H100): 100 less the share of the traced window in
which some kernel or copy ran on the card (torch.profiler)."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / run["window_s"])
