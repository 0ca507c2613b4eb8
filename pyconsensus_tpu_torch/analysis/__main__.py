"""``python -m pyconsensus_tpu_torch.analysis`` — the consensus-lint CLI."""

from .cli import main

main()
