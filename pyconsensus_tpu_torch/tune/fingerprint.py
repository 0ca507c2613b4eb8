"""The runtime fingerprint of a process
(``pyconsensus_tpu/tune/fingerprint.py``).

Two processes that agree on every field compute the same bits for the
same request: the fleet's wire handshake (``serve/transport/wire.py``)
refuses a worker whose fingerprint differs from the one the router
expects for it, naming the first field that differs (PYC602).

- :func:`device_generation` — the card's name with spaces dashed plus
  its ``sm_XY`` (``"NVIDIA-H100-80GB-HBM3-sm_90"``), or ``"cpu"``.
- :func:`runtime_fingerprint` — the package version, torch and its CUDA
  version, the platform, the generation, the default float dtype (it
  sets every computed dtype of a worker's service) and the digest of
  the kernel sources (``ops.build.sources_digest``: a worker built from
  other kernel sources loads other kernels). It is the counterpart of
  the reference's jax/jaxlib/x64 fields.

Unlike the reference's, it names no device count and no device index:
with one worker process a card, a worker sees one card (its
``cuda:0``, pinned by ``CUDA_VISIBLE_DEVICES``) where the router sees
them all, and the two must still agree.

Both read the environment at call time, and neither allocates on the
card: a device query opens no context.
"""

from __future__ import annotations

__all__ = ["device_generation", "runtime_fingerprint"]


def device_generation(device=None) -> str:
    """``device``'s generation (None: the card, raising where there is
    none): the card's name with spaces dashed and its ``sm_XY``, or
    ``"cpu"``."""
    import torch

    from ..parallel.sharded import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    index = dev.index if dev.index is not None else 0
    major, minor = torch.cuda.get_device_capability(index)
    name = str(torch.cuda.get_device_name(index)).replace(" ", "-")
    return f"{name}-sm_{major}{minor}"


def runtime_fingerprint(device=None) -> dict:
    """The fingerprint of this process computing on ``device`` (None:
    the card). Every field takes part in the handshake's comparison."""
    import torch

    from .. import __version__
    from ..ops.build import sources_digest
    from ..parallel.sharded import resolve_device

    dev = resolve_device(device)
    return {
        "package": __version__,
        "torch": str(torch.__version__),
        "cuda": torch.version.cuda,
        "platform": dev.type,
        "generation": device_generation(dev),
        "dtype": str(torch.get_default_dtype()).replace("torch.", ""),
        "kernels": sources_digest(),
    }
