"""The replay driver (consensus/pipeline.py): the share of the window the
consumer spent blocked in `window.drain`, waiting for the card's result."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "window.drain" not in spans:
        return None
    return 100.0 * spans["window.drain"] / run["window_s"]
