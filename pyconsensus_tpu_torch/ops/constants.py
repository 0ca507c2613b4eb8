"""Tie bands shared by every decision site of the port.

The same values as the JAX package's ``ops/numpy_kernels.py``; the port
keeps its own copy so that it never imports the JAX package. Each band
makes a decision that reduction-order noise could flip come out the same
way on every path: a value inside the band takes the tie's answer.
"""

#: catch-snap boundary band: a value within this band of ``0.5 ±
#: tolerance`` resolves to the ambiguous 0.5. Rational report data under
#: uniform reputation lands weighted means exactly on the boundary (12
#: ones over 20 reporters = 0.6), and two exact computations in different
#: orders straddle it by one ulp. 1e-9 sits far above float64 ulp noise on
#: O(1) means and far below any data-driven margin; float32 paths floor it
#: at ``32 * eps`` (``torch_kernels.catch_tie_atol``)
CATCH_TIE_ATOL = 1e-9

#: weighted-median tie band: a cumulative weight within this of 0.5 takes
#: the midpoint of that value and the next (the ``weightedstats`` rule
#: compares exactly, which two summation orders do not reproduce); float32
#: paths floor it at ``32 * eps``
MEDIAN_TIE_ATOL = 1e-9

#: direction-fix tie band: ``set1`` wins when
#: ``d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2)``. On symmetric matrices the
#: two orientations are exactly equidistant, and exact-but-different
#: algebra (eigh-cov, eigh-gram, the fused projected form) lands on either
#: side of 0 by one ulp
DIRFIX_TIE_ATOL = 1e-9
