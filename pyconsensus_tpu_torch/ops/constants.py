"""Tie bands shared by every decision site of the port.

The same values as the JAX package's ``ops/numpy_kernels.py`` (which
documents why each band exists); the port keeps its own copy so that it
never imports the JAX package.
"""

#: catch-snap boundary band: a value within this band of ``0.5 ± tolerance``
#: resolves to the ambiguous 0.5 (f32 paths floor it at ``32 * eps``, see
#: ``torch_kernels.catch_tie_atol``)
CATCH_TIE_ATOL = 1e-9

#: weighted-median near-tie band (the scaled-event tail, not in this slice)
MEDIAN_TIE_ATOL = 1e-9

#: direction-fix tie band: ``set1`` wins when
#: ``d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2)``
DIRFIX_TIE_ATOL = 1e-9
