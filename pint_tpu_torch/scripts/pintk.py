"""Launch the interactive fitting GUI (reference: src/pint/scripts/
pintk.py; the JAX package's ``scripts/pintk.py``). Headless
environments get a pointer to the scriptable session layer instead of
a Tk traceback.

    python -m pint_tpu_torch.scripts.pintk <par> <tim> [--device cuda]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pintk",
        description="Interactive timing fit GUI (pint_tpu_torch)")
    p.add_argument("parfile")
    p.add_argument("timfile")
    p.add_argument("--device", default="cuda",
                   help="torch device of the session's fits (default cuda)")
    args = p.parse_args(argv)
    from ..pintk_gui import launch

    try:
        launch(args.parfile, args.timfile, device=args.device)
    except RuntimeError as e:
        print(f"pintk: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
