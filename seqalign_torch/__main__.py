"""``python -m seqalign_torch``: the alignSequence command line."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
