"""Part of the pyconsensus_tpu_torch port (see the package docstring)."""
