"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, once for each fault a cell can have (one card:
no exchange between chips to leave out)."""

import copy
import time

import pytest

from benchmark.manifest import Manifest
from benchmark.run import execute
from benchmark.tests.tiny import tiny_copy
from benchmark.train import half_batch


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    return Manifest(tiny_copy(tmp), root=tmp / "benchmark")


def run(mf, cell, alter=None):
    return execute(mf, cell, 2 ** 40 + 11, 0.01, False, "cpu",
                   time.perf_counter(), alter=alter)


def test_an_answer_altered_where_it_is_produced(manifest):
    def alter(rgb):
        out = rgb.clone()
        out[:, :8, :8] += 0.25
        return out
    res = run(manifest, "tiny-serve", alter)
    assert res["correct"] is False
    assert res["checked"]["rgb_mae"]["value"] > res["checked"]["rgb_mae"][
        "limit"]


def test_a_step_that_returns_its_state_unchanged(manifest):
    res = run(manifest, "tiny-train",
              lambda ts, batch, draws: (copy.deepcopy(ts), batch, draws))
    assert res["correct"] is False
    assert res["checked"]["change_gap_med"]["value"] >= 0.99


def test_half_of_the_batch_left_out(manifest):
    res = run(manifest, "tiny-train",
              lambda ts, batch, draws: (ts, batch, half_batch(draws)))
    assert res["correct"] is False
