"""The port's runtime witnesses as pytest fixtures.

A suite opts in with a module-level autouse fixture of its own that
requests the witnesses it runs under::

    from torch_witness import torch_lock_witness  # noqa: F401

    @pytest.fixture(autouse=True)
    def _witnessed(torch_lock_witness):
        yield

Each fixture installs the port's witness for the test and checks it at
teardown: the lock witness against the static may-hold-before graph
(CL801's), the protocol witness against the static happens-before graph
(CL901's), the digest witness by replaying every digest from the
durable artifact. The static graphs are computed once per process. On a
violation the witness JSON lands in the test's ``tmp_path``. Locks the
package builds at import are outside the lock witness here (the package
is imported before any test runs); ``chip_smoke.py --only witness``
installs it before the import.
"""

import pytest

from pyconsensus_tpu_torch.analysis.determinism_witness import \
    digest_witnessed
from pyconsensus_tpu_torch.analysis.protocol_witness import (
    protocol_witnessed, static_protocol_graph)
from pyconsensus_tpu_torch.analysis.witness import (static_lock_graph,
                                                    witnessed)


@pytest.fixture
def torch_lock_witness(tmp_path):
    with witnessed(static=static_lock_graph(),
                   dump_path=tmp_path / "lock_witness.json") as w:
        yield w


@pytest.fixture
def torch_protocol_witness(tmp_path):
    with protocol_witnessed(static=static_protocol_graph(),
                            dump_path=tmp_path / "protocol_witness.json"
                            ) as w:
        yield w


@pytest.fixture
def torch_digest_witness(tmp_path):
    with digest_witnessed(dump_path=tmp_path / "digest_witness.json") as w:
        yield w
