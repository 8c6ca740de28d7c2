"""``python -m repro_torch.analysis`` — alias for ``python -m repro_torch.analyze``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
