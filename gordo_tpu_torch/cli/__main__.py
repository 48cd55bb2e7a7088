import sys

from gordo_tpu_torch.cli.cli import main

if __name__ == "__main__":
    sys.exit(main())
