"""`python -m lightgbm_tpu_torch key=value ...`, the reference's lightgbm
binary (src/main.cpp); see cli.py."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
