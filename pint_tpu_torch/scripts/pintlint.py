"""pintlint console entry point — the same CLI as
``python -m pint_tpu_torch.analysis`` (see
pint_tpu_torch/analysis/__main__.py): lint the tree against the
codebase-contract rules and exit nonzero on any unsuppressed finding.
The rule catalogue is in pint_tpu_torch/analysis/__init__.py."""

import os
import sys

try:
    from pint_tpu_torch.analysis.__main__ import main
except ModuleNotFoundError:
    # direct invocation (python pint_tpu_torch/scripts/pintlint.py) puts
    # scripts/ on sys.path instead of the repo root; fix that up
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    from pint_tpu_torch.analysis.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
