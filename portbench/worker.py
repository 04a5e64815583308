"""A rank of a cell on several chips, as the program's launcher starts
it: ``python -m portbench.worker <spec.json>``."""

import sys

from portbench.cell import rank_main

if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1]))
