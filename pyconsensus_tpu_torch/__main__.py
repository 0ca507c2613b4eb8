"""``python -m pyconsensus_tpu_torch``: the command line (:mod:`.cli`)."""

import sys

from .cli import main

sys.exit(main())
