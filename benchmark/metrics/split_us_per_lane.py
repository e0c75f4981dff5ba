"""The window seam's request split (crypto/torch_backend.py,
`_split_mixed_device`: requests sorted by kind, cold KES hash paths
walked into Blake2b jobs): `submit.split` seconds over the lanes the
windows really used, in microseconds."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "submit.split" not in spans or not run["lanes"]:
        return None
    return 1e6 * spans["submit.split"] / run["lanes"]
