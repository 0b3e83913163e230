"""``python -m repro_torch.server``: generate a replayable traffic trace.

Thin alias for the ``repro_torch.server.traffic`` CLI (same flags) that avoids
runpy's package-reimport warning; see that module for the trace format.
"""
from .traffic import _main

if __name__ == "__main__":
    _main()
