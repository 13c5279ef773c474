"""Cells at sizes a CPU test run holds: the same drivers, traffic and
checks, on a small population or on a narrow model and small images."""

OVERRIDES = {
    "search.effnetb0-4plat.pop16k": {
        "cell": {"traffic": {"name": "pop64", "pop_size": 64, "n_gen": 2,
                             "rank_block": 32}}},
    "oracle.effnetb0-4plat.distinct": {
        "config": {"image_size": 32, "width": 0.25, "num_classes": 10},
        "cell": {"traffic": {"name": "distinct", "images": 16,
                             "calibration_images": 8, "warmup_vectors": 1,
                             "traced_vectors": 2, "check_vectors": 4}}},
}

SECONDS = {"search.effnetb0-4plat.pop16k": 0.5,
           "oracle.effnetb0-4plat.distinct": 1.0}


def run_small(name, seed=20261017, trace=False, control=False):
    import torch

    from bench.lib import harness
    torch.set_num_threads(2)
    return harness.run_cell(name, seed, SECONDS[name], trace, "cpu",
                            overrides=OVERRIDES[name], control=control)
