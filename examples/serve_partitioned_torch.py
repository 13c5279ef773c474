"""End-to-end serving example on PyTorch:
warm-train a reduced smollm-360m, let the exploration engine
(``repro_torch.explore``) pick the partition, serve batched requests
through partitioned stages asynchronously and with the serial handoff,
and report Def.-4 pipelined throughput.

This is a thin wrapper over ``repro_torch.launch.serve`` (the real
launcher), with the reference example's arguments; everything runs on
``--device``, the card by default (it raises where there is none):

  PYTHONPATH=src python examples/serve_partitioned_torch.py [--device cpu]
"""

import argparse

from repro_torch.launch import serve


def main(device="cuda", warm_steps=40) -> int:
    """The serve launcher's exit code: 0 when no request was dropped."""
    return serve.main(["--arch", "smollm-360m", "--requests", "8",
                       "--prompt-len", "32", "--max-new", "16",
                       "--warm-steps", str(warm_steps), "--device", device])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train, search and serve on "
                         "(cpu for tests)")
    raise SystemExit(main(ap.parse_args().device))
