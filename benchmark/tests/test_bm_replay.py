"""Whole runs of tiny cells on the CPU: the program's passes agree with
the reference, and each fault in the timed path turns `correct` false.
A `cuda` case runs the control on the card."""
import json

import pytest

import faults
import harness
from conftest import cpu_run


@pytest.mark.parametrize("traffic", ["fresh", "warm"])
def test_a_tiny_run_is_correct(tiny_root, traffic):
    # passes over several tampered forms, one stopping in the first of
    # the four windows, before the betas of the last are worked out
    out = cpu_run(f"tiny-{traffic}", tiny_root, seconds=10, trace=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1       # the first pass is a tampered one
    assert {"host_seq_us_per_block", "prep_us_per_lane",
            "fold_ms_per_window"} <= set(out["metrics"])
    json.dumps(out)


def test_hot_keys_are_data_alone(tiny_root):
    """A mix of 4 hot keys needs a traffic file and no code."""
    import forge
    import torch
    from program import Program
    manifest = harness.load_manifest(tiny_root)
    _cell, config, mix = harness.cell_of(manifest, "tiny-warm", tiny_root)
    chain = forge.forge(config, dict(mix, witness_keys=4), 2 ** 31 + 5,
                        workers=1)
    prog = Program(chain["genesis"], torch.device("cpu"), 4, 16)
    rec = prog.replay(prog.decode(chain["blocks"]), prog.backend(), -1)
    assert rec.accepted and rec.n_valid == 8


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_makes_a_run_incorrect(tiny_root, fault):
    # a window of several passes: the first two tampered forms lie in
    # opposite halves of their windows
    if fault == "unchanged_state":
        with faults.unchanged_state():
            out = cpu_run("tiny-fresh", tiny_root, seconds=10)
    else:
        out = cpu_run("tiny-fresh", tiny_root, seconds=10,
                      wrap_backend=faults.WRAPPERS[fault])
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.cuda
def test_the_control_fails_on_the_card(tiny_root, cuda_card):
    out = harness.run("tiny-fresh", 2 ** 31 + 3, 0.5, False, root=tiny_root,
                      workers=2, say=lambda line: None,
                      wrap_backend=faults.skip_witnesses)
    assert not out["correct"]
    sound = harness.run("tiny-fresh", 2 ** 31 + 3, 0.5, False,
                        root=tiny_root, workers=2, say=lambda line: None)
    assert sound["correct"], sound["checks"]
