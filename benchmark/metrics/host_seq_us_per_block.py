"""The sequential pass (consensus/batch.py -> eras/shelley.py): seconds in
`window.host_seq` over the blocks of the window, in microseconds."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "window.host_seq" not in spans:
        return None
    return 1e6 * spans["window.host_seq"] / run["blocks"]
