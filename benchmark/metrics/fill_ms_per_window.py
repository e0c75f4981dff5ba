"""The per-key fill (crypto/precompute.py): `precompute.fill` seconds over
the windows of the window, in milliseconds.  Nothing to read where no
window met a new key."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if not spans.get("precompute.fill") or not run["windows"]:
        return None
    return 1e3 * spans["precompute.fill"] / run["windows"]
