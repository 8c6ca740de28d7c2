"""``python -m repro_torch.analyze`` — the port's nglint entry point.

Thin shim over :mod:`repro_torch.analysis.cli` so the command reads like
the port's other CLIs (``python -m repro_torch.bench``).
"""

import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
