"""`python -m bowtie2_tpu_torch`: the command-line interface (cli/main.py)."""

import sys

from bowtie2_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
