"""a run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a tiny cell on the CPU (measure() skips
the harness's look for a card), with the limits of dt_r50.pairs, after
breaking the runner's timed call: an answer altered where it is
produced, a frame's detections dropped, all but one of a frame's
detections marked invalid, half of the batch left out (its slots filled
from the rest), the previous call's answer returned, or the program run
without its NMS or without its foreground gate (calibrate.FAULTS). The
unbroken run comes out correct.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, run, spec
from benchmark.tests import tiny


def _broken(real, fault):
    def call(state, i):
        confs, boxes, valid, tracks = (x.clone() for x in real(state, i))
        fault(state, i, confs, boxes, valid, tracks)
        return confs, boxes, valid, tracks

    return call


def _shift_box(state, i, confs, boxes, valid, tracks):
    boxes[0, 0, 0, :2] += 0.1 * boxes[0, 0, 0, 2:]


def _alter_conf(state, i, confs, boxes, valid, tracks):
    confs[0, 0, 0] = confs[0, 0, 0].roll(1)


def _drop_half(state, i, confs, boxes, valid, tracks):
    """the second half of the batch left out, its slots filled from the rest."""
    h = valid.shape[0] // 2
    for x in (confs, boxes, valid, tracks):
        x[h:] = x[:h]


def _drop_detections(state, i, confs, boxes, valid, tracks):
    valid[0, 1] = False


def _zero_tracks(state, i, confs, boxes, valid, tracks):
    tracks[0] = 0.0


STALE = {}


def _stale(state, i, confs, boxes, valid, tracks):
    """the previous call's answer (another batch) returned again."""
    prev = STALE.get(id(state))
    STALE[id(state)] = (confs.clone(), boxes.clone(), valid.clone(), tracks.clone())
    if prev is not None:
        for dst, src in zip((confs, boxes, valid, tracks), prev):
            dst.copy_(src)


def _all_but_one(state, i, confs, boxes, valid, tracks):
    valid.copy_(calibrate.all_but_one((confs, boxes, valid, tracks))[2])


FAULTS = {"box_shifted": _shift_box, "conf_altered": _alter_conf, "half_dropped": _drop_half,
          "detections_dropped": _drop_detections, "all_but_one": _all_but_one,
          "tracks_zeroed": _zero_tracks, "stale_answer": _stale}


def _in_program(real, fault):
    def call(state, i):
        with fault(state):
            return real(state, i)

    return call


def _run(cell, monkeypatch, fault=None, wrap=_broken):
    torch.manual_seed(0)
    runner = spec.runner(cell)
    if fault is not None:
        monkeypatch.setattr(runner, "call", wrap(runner.call, fault))
    return run.measure(cell, 2024, 2.0, False, device="cpu")  # a window of several calls


def test_unbroken_run_is_correct(monkeypatch):
    res = _run(tiny.cell("float32"), monkeypatch)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_broken_run_is_not_correct(name, monkeypatch):
    res = _run(tiny.cell("float32"), monkeypatch, FAULTS[name])
    assert not res["correct"], (name, res["checks"])


@pytest.mark.parametrize("name", sorted(calibrate.FAULTS))
def test_program_fault_is_not_correct(name, monkeypatch):
    res = _run(tiny.cell("float32"), monkeypatch, calibrate.FAULTS[name], _in_program)
    assert not res["correct"], (name, res["checks"])
