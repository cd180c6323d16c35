"""``python -m tapqir_tpu_torch`` runs the command-line interface."""

import sys

from tapqir_tpu_torch.main import main

if __name__ == "__main__":
    sys.exit(main())
