"""On the card: each cell's output check passes the program and fails its
control, the reference computed with TF32 on (and, for training, the
half-batch fault), on one seed at the cell's own size.  Skips without a
CUDA card; run on the card with

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""

import pathlib

import pytest
import torch

from benchmark import calibrate
from benchmark.manifest import Manifest
from benchmark.run import check_lines

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve-1view-g16", "train-1view",
                                  "serve-2view-g16"])
def test_the_check_passes_the_program_and_fails_the_control(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mf = Manifest(ROOT / "BENCHMARK.json")
    if cell not in mf.cells:
        pytest.skip(f"{cell} is not a cell of this benchmark")
    cfg, traffic, limits = mf.config(cell), mf.traffic(cell), mf.limits(cell)
    seed = 2 ** 32 + 17
    fam = mf.family(cell)
    if traffic["kind"] == "serve":
        r = calibrate.readings(fam, cfg, traffic, seed, "cuda", 1)
    else:
        r = calibrate.train_readings(fam, cfg, traffic, seed, "cuda")
    assert check_lines(r["program"], limits)[0], r
    assert not check_lines(r["control"], limits)[0], r
    if "half_batch" in r:
        assert not check_lines(r["half_batch"], limits)[0], r
