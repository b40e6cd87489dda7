"""``python -m edl_tpu_torch.launcher`` — the pod entrypoint, as `paddle_k8s` was
the container entrypoint in the reference (`docker/paddle_k8s:238-263`)."""

import sys

from edl_tpu_torch.launcher.launch import main

if __name__ == "__main__":
    sys.exit(main())
