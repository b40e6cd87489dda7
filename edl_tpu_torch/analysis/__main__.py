"""Entry point for ``python -m edl_tpu_torch.analysis``."""

import sys

from edl_tpu_torch.analysis.cli import main

if __name__ == "__main__":  # importing the module (as the isolation test does) runs nothing
    sys.exit(main())
