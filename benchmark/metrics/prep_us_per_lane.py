"""The window seam (crypto/torch_backend.py): `window.submit` less the
per-key fill and the verdict fold inside it, over the lanes the windows
really used (the backend's own count, before padding), in microseconds."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "window.submit" not in spans or not run["lanes"]:
        return None
    prep = (spans["window.submit"] - spans.get("precompute.fill", 0.0)
            - spans.get("window.fold", 0.0))
    return 1e6 * prep / run["lanes"]
