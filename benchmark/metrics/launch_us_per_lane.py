"""The window seam's launches (crypto/torch_backend.py, `_launch_lanes`
at each call site: pinned staging, the copies to the card and the kernel
launch): `submit.launch` seconds over the lanes the windows really used,
in microseconds."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "submit.launch" not in spans or not run["lanes"]:
        return None
    return 1e6 * spans["submit.launch"] / run["lanes"]
