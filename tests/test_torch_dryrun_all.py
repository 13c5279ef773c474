"""Every row of ``python -m repro_torch.launch.dryrun --all``: the 10
published configs x the reference's 4 input shapes, single-pod, each step
built and counted on the ``meta`` device against the logical 16 x 16 pod
mesh (no card, no JAX).  The pairs take a few seconds each on one CPU
core, two minutes together, so they run here rather than on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.launch.dryrun import dryrun_one  # noqa: E402
from repro_torch.models.registry import (ARCH_IDS, get_config,  # noqa: E402
                                         supports_shape)

PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]


def test_all_pairs_are_the_reference_grid():
    assert len(PAIRS) == 40
    skipped = [(a, s) for a, s in PAIRS
               if not supports_shape(get_config(a), INPUT_SHAPES[s])]
    assert sorted(skipped) == sorted([("musicgen-large", "long_500k"),
                                      ("deepseek-v3-671b", "long_500k"),
                                      ("deepseek-moe-16b", "long_500k")])


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_dryrun_all_pairs(arch, shape_name):
    row = dryrun_one(arch, shape_name, verbose=False)
    assert "error" not in row, row
    if not supports_shape(get_config(arch), INPUT_SHAPES[shape_name]):
        assert row["skipped"], row
        return
    assert not row.get("skipped"), row
    assert row["n_devices"] == 256
    assert row["kind"] == INPUT_SHAPES[shape_name].kind
    assert row["step_flops"] > 0 and row["flops_per_device"] > 0
    assert row["memory"]["argument_bytes"] > 0
    assert row["memory"]["step_peak_bytes"] > 0
    assert row["bound_s"] == max(row["compute_s"], row["memory_s"]) > 0
