"""``python -m repro_torch.analysis`` entry point."""
import sys

from repro_torch.analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())
