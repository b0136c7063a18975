"""``python -m repro_torch.service`` — run the standalone DSE daemon.

Preferred over ``-m repro_torch.service.server`` (which works too, but trips
runpy's already-imported warning because the package imports the server
module at import time).
"""
from .server import main

if __name__ == "__main__":
    raise SystemExit(main())
