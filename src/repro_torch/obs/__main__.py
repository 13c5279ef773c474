"""``python -m repro_torch.obs`` — see :mod:`repro_torch.obs.cli`."""

import sys

from repro_torch.obs.cli import main

if __name__ == "__main__":
    sys.exit(main())
