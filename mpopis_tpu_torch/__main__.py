import sys

from mpopis_tpu_torch.harness.cli import main

if __name__ == "__main__":
    sys.exit(main())
