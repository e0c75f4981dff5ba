"""The window seam's fold attachment (crypto/torch_backend.py,
`_fold_owners`: host-known failures and each lane's request, before the
verdict fold opens): `submit.attach` seconds over the lanes the windows
really used, in microseconds."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "submit.attach" not in spans or not run["lanes"]:
        return None
    return 1e6 * spans["submit.attach"] / run["lanes"]
