"""The window seam's host packers (crypto/torch_backend.py: the Ed25519
parse and SHA-512 mod L, the VRF, beta and KES-job packing into kernel
words): `submit.pack` seconds over the lanes the windows really used, in
microseconds."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "submit.pack" not in spans or not run["lanes"]:
        return None
    return 1e6 * spans["submit.pack"] / run["lanes"]
