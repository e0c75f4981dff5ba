"""The window seam's key cache (crypto/precompute.py, `assemble`: the
lookups, a fill's decode and inserts, the column copies):
`precompute.assemble` less the `precompute.fill` inside it, over the
lanes the windows really used, in microseconds."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "precompute.assemble" not in spans or not run["lanes"]:
        return None
    host = spans["precompute.assemble"] - spans.get("precompute.fill", 0.0)
    return 1e6 * host / run["lanes"]
