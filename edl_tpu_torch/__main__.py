"""``python -m edl_tpu_torch``: the port's CLI (`cli`; ref: cmd/edl/edl.go:16-51).

Runs ``main`` only as a program, since the tests import every module."""

import sys

from edl_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
