"""CLI for the port's generated API reference and its docstring gate.

  PYTHONPATH=src python -m repro_torch.docs            # docs/api_torch.md
  PYTHONPATH=src python -m repro_torch.docs --check    # docstring gate
  PYTHONPATH=src python -m repro_torch.docs --out x.md # custom target
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.docs import PUBLIC_API, missing_docstrings, render_api_md
from repro_torch.utils.atomicio import atomic_write_text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.docs")
    ap.add_argument("--check", action="store_true",
                    help="verify docstring coverage of PUBLIC_API and that "
                         "the reference renders; write nothing")
    ap.add_argument("--out", default="docs/api_torch.md",
                    help="markdown target (default docs/api_torch.md)")
    args = ap.parse_args(argv)

    missing = missing_docstrings()
    md = render_api_md()            # also a smoke test: every entry imports
    if missing:
        print(f"docstring coverage: {len(missing)} public object(s) "
              "undocumented:", file=sys.stderr)
        for path in missing:
            print(f"  {path}", file=sys.stderr)
        return 1
    if args.check:
        n = sum(len(names) for _, names in PUBLIC_API)
        print(f"docstring coverage: ok ({n} public objects, "
              f"{len(md.splitlines())} rendered lines)")
        return 0
    atomic_write_text(args.out, md)
    print(f"wrote {args.out} ({len(md.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
