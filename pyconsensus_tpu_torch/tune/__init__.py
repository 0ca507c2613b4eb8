"""pyconsensus_tpu_torch.tune — what the port keys persisted and shared
state on (``pyconsensus_tpu/tune``).

The port has :mod:`.fingerprint`: the runtime fingerprint the fleet's
wire handshake compares, and that the kernel-build cache will key on.
The block-shape autotuner and the roofline models of the reference's
package are ``ROADMAP.md`` §A.12.
"""

from __future__ import annotations

from .fingerprint import device_generation, runtime_fingerprint

__all__ = ["device_generation", "runtime_fingerprint"]
