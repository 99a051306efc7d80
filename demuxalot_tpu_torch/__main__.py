"""``python -m demuxalot_tpu_torch`` — see cli.py for the subcommands."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
