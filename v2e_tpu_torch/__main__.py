"""python -m v2e_tpu_torch: the v2e conversion CLI on the port (cli.py)."""
import sys

from v2e_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
