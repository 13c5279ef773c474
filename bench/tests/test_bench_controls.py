"""Each cell's control, judged by the harness's own comparison in the
program's place (``run_cell(control=True)``, ``run.py --control 1``): the
plain reference computed in the precision below the configuration's
(float32 for the float64 cost model, TF32 for float32, emulated on the
CPU by rounding the products' operands) comes out not correct, while the
sound run of the same seed comes out correct."""

from __future__ import annotations

import pytest

from bench.tests.small import run_small

CELLS = ["search.effnetb0-4plat.pop16k", "oracle.effnetb0-4plat.distinct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    assert run_small(name, seed=424242)["correct"]
    r = run_small(name, seed=424242, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench.lib import harness
    for seed in (11, 12, 13):
        assert not harness.run_cell(name, seed, 3.0, False,
                                    control=True)["correct"]
