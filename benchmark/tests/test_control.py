"""The control on the card, at each cell's own size: the reference put in
the program's place and computed with TF32 on (the precision below the
float32 with TF32 off that the program states) has to come out not
correct under the cell's limits, on three seeds, while the program's own
runs come out correct on a dozen. Each seed drives one lap, as a run's
window does first, and compares the same sampled frames; each departed
step of the program's runs is witnessed (compare.witness).

    python -m pytest benchmark/tests/test_control.py -q -s

prints each seed's readings, the program's and the control's: the lower
and upper readings that the cells' limits are set between."""

import json

import pytest

import harness
from benchlib import registry

# a dozen new seeds, and one on which both cells had a step depart before
SEEDS = tuple(2**31 + 1009 * k for k in range(1, 13)) + (2**31 + 303,)
CONTROL_SEEDS = SEEDS[:3]


@pytest.mark.cuda
@pytest.mark.parametrize("name", registry.workload_names())
def test_the_control_is_not_correct(card, name):
    cell = registry.workload(name)
    config = registry.config(cell["config"])
    limits = cell["limits"]
    p = cell["params"]
    program_ok, control_failed = [], []
    for seed in SEEDS:
        control = seed in CONTROL_SEEDS
        r = harness.run(cell, config, seed, 0.0, 0, card, [],
                        steps=p["lap_frames"] * p.get("sequences", 1), control=control,
                        witness=True)
        program = {k: c["value"] for k, c in r["compared"].items()}
        print(json.dumps({"cell": name, "seed": seed, "program": program,
                          "control": r.get("control"), "witness": r["witness"],
                          "steps": r.get("steps")}), flush=True)
        program_ok.append(r["correct"])
        if control:
            control_failed.append(not all(v <= limits[k] for k, v in r["control"].items()))
    assert all(program_ok), program_ok
    assert all(control_failed), control_failed
