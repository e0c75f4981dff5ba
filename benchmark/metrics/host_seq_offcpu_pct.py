"""The sequential pass off the CPU (consensus/pipeline.py's producer
thread): 100 x (wall - CPU) / wall of `window.host_seq`, from the
program's span totals since the traced window's start
(`observe.spans.RECORDER.totals()`).  The pass is pure Python and calls
nothing on the card, so what its thread spent off the CPU is time it
waited for the interpreter lock or was descheduled.  Nothing to read
where the program keeps no such totals or read no CPU time."""


def read(run: dict):
    if not run["trace"]:
        return None
    from ouroboros_tpu_torch.observe import spans
    totals = getattr(spans.RECORDER, "totals", None)
    if totals is None:
        return None
    _n, wall, cpu = totals().get("window.host_seq", (0, 0.0, None))
    if cpu is None or not wall:
        return None
    return 100.0 * (wall - cpu) / wall
