"""The verdict fold (torch_backend.fold_window -> sha512.py): `window.fold`
seconds over the windows of the window, in milliseconds."""


def read(run: dict):
    spans = run["trace"]["spans"] if run["trace"] else {}
    if "window.fold" not in spans or not run["windows"]:
        return None
    return 1e3 * spans["window.fold"] / run["windows"]
