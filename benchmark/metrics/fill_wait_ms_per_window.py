"""The per-key fill's wait for the card (crypto/precompute.py: the
read-back that blocks until the fill's torch ops have run):
`precompute.fill_wait` seconds over the windows of the window, in
milliseconds.  The fill less this is its host issue time.  Nothing to
read where no window met a new key."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if not spans.get("precompute.fill_wait") or not run["windows"]:
        return None
    return 1e3 * spans["precompute.fill_wait"] / run["windows"]
