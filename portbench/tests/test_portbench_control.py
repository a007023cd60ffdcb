"""The controls at a size a test run holds, on the CPU: a program in the
precision below the configuration's must read worse than the program on
every compared model, by the same numbers a run compares, and a whole
run with the control in the program's place must come out not correct.
(On the card the controls are read at the cells' own sizes, through the
same judgement, by ``portbench/tools/calibrate.py``.)"""

from __future__ import annotations

import pytest

from portbench.harness import lookup, runner
from test_portbench_harness import TRAFFIC, _run, tiny  # noqa: F401


def _ctx(tiny, cell):
    root, bench = tiny
    w = lookup.workload(bench, cell)
    return runner.Context(root, w, lookup.config_of(bench, root, w),
                          TRAFFIC[w["traffic"]], 17, 1.0, False,
                          __import__("torch").device("cpu"))


def test_the_recognizers_int8_path_reads_worse(tiny):
    ctx = _ctx(tiny, "asr")
    drv = lookup.driver("asr_encode")
    program = drv.prepare(ctx)
    ctrl = drv.control_program(ctx, program)
    got = {}
    for side, prog in (("program", program), ("control", ctrl)):
        drv.reseed(ctx, prog)
        records, _, _ = drv.window(ctx, prog, 1.0)
        served = drv.collect(ctx, prog, records)
        got[side] = drv.numbers(ctx, prog, served)
        if side == "program":
            got["lowered"] = drv.numbers(ctx, prog, served, control=True)
    assert got["program"]["token_gap"] < 1e-4
    for k in ("enc_rel", "kv_rel", "kv_first_rel", "token_gap",
              "token_gap_mean"):
        assert got["control"][k] > 30 * max(got["program"][k], 1e-6)
    # the front in bfloat16 in the program's place, a token altered; YIN's
    # minimum moves little under rounding (see PERF.md)
    for k in ("rms_rel", "token_gap", "token_gap_mean"):
        assert got["lowered"][k] > 30 * max(got["program"][k], 1e-6), k
    assert got["lowered"]["f0_rel"] > got["program"]["f0_rel"]


def test_a_run_with_the_int8_path_in_the_programs_place_is_not_correct(
        tiny, monkeypatch):
    drv = lookup.driver("asr_encode")
    real = drv.build_encoder
    monkeypatch.setattr(drv, "build_encoder",
                        lambda ctx, tree, quantized=False: real(ctx, tree,
                                                                True))
    res = _run(tiny, "asr")
    assert not res["correct"], res["checks"]
    assert res["checks"]["kv_first_rel"]["value"] > \
        res["checks"]["kv_first_rel"]["limit"]


@pytest.mark.parametrize("cell", ["stream", "synth"])
def test_the_receive_reference_in_int8_reads_worse(tiny, cell):
    ctx = _ctx(tiny, cell)
    drv = lookup.driver(TRAFFIC[cell]["driver"])
    program = drv.prepare(ctx)
    records, _, _ = drv.window(ctx, program, 1.0)
    served = drv.collect(ctx, program, records)
    mine = drv.numbers(ctx, program, served)
    ctrl = drv.numbers(ctx, program, served, control=True)
    for k in ("mel_gap", "pcm_gap"):
        assert ctrl[k] > 10 * mine[k], (k, mine, ctrl)
