"""The port's ring collectives (``pyconsensus_tpu_torch/parallel/ring.py``)
against the reference's (``pyconsensus_tpu/parallel/ring.py``) on the
CPU, on the cases of ``tests/test_ring.py``: the all-reduce against the
sum of the partials (leading axes that divide no shard count, a scalar),
the same bits on every call, the Gram and matvec against numpy, and the
first component against the Gram eigh, the reference's ring and the
port's own. The port's mesh is ``make_mesh(devices=["cpu"] * 8)``, the
reference's the 8-device CPU platform.

The ring sums panel c as a left fold starting at shard c: panel 0
equals ``mesh.fold``'s bits, the others in general do not, so the plain
mesh core keeps ``mesh.fold`` and the ring stands alone, as in the
reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pyconsensus_tpu.ops import jax_kernels as jk
from pyconsensus_tpu.parallel import make_mesh as ref_make_mesh
from pyconsensus_tpu.parallel import ring_allreduce as ref_ring_allreduce
from pyconsensus_tpu.parallel import ring_first_pc as ref_ring_first_pc
from pyconsensus_tpu.parallel.ring import shard_map
from pyconsensus_tpu_torch import obs
from pyconsensus_tpu_torch.ops import torch_kernels as tk
from pyconsensus_tpu_torch.parallel import (make_mesh, ring_allreduce,
                                            ring_first_pc, ring_gram,
                                            ring_matvec)
from pyconsensus_tpu_torch.parallel.mesh import fold, place_event_shards


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=["cpu"] * 8)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("shape", [(8, 5), (16, 3), (7, 4), (1, 9), (24,),
                                   ()])
def test_allreduce_matches_sum_and_reference(rng, shape):
    """Every device ends with the sum; the reference's ring gives the same
    within 1e-12, and so does numpy's sum."""
    parts = rng.standard_normal((8,) + shape)
    out = ring_allreduce([_t(p) for p in parts])
    assert len(out) == 8 and all(torch.equal(o, out[0]) for o in out)
    assert out[0].shape == shape
    np.testing.assert_allclose(out[0].numpy(), parts.sum(axis=0),
                               rtol=1e-12)
    if shape:
        f = shard_map(lambda x: ref_ring_allreduce(x[0], "event"),
                      ref_make_mesh(batch=1, event=8), in_specs=P("event"),
                      out_specs=P())
        ref = np.asarray(f(jnp.asarray(parts)))
        np.testing.assert_allclose(out[0].numpy(), ref, rtol=1e-12)


def test_allreduce_scalarish():
    parts = [torch.tensor([float(i)]) for i in range(8)]
    assert ring_allreduce(parts)[0].tolist() == [28.0]


def test_allreduce_is_deterministic_and_panel_order(rng):
    """The same bits on every call; panel c is the left fold from shard
    c, so panel 0 is ``mesh.fold``'s bits."""
    parts = [_t(p) for p in rng.standard_normal((8, 16, 7))
             .astype(np.float32)]
    a, b = ring_allreduce(parts)[0], ring_allreduce(parts)[0]
    assert torch.equal(a, b)
    assert torch.equal(a[:2], fold(parts, torch.device("cpu"))[:2])
    for c in range(8):
        expect = parts[c][2 * c:2 * c + 2]
        for i in range(1, 8):
            expect = expect + parts[(c + i) % 8][2 * c:2 * c + 2]
        assert torch.equal(a[2 * c:2 * c + 2], expect), c


@pytest.mark.parametrize("R,E", [(24, 64), (13, 40)])
def test_gram_and_matvec(rng, mesh8, R, E):
    """R = 13 divides no shard count: the panels pad. The hops and bytes
    counters move as the reference's do: 2(n - 1) hops, 2(n - 1)/n of the
    payload."""
    X = rng.standard_normal((R, E))
    v = rng.standard_normal(E)
    hops = ("pyconsensus_ring_collective_hops_total",)
    before = [obs.value(*hops, op=op) or 0 for op in ("gram", "matvec")]
    nbytes = obs.value("pyconsensus_ring_collective_bytes_total",
                       op="gram") or 0
    G = ring_gram(_t(X), mesh8)
    np.testing.assert_allclose(G.numpy(), X @ X.T, rtol=1e-10)
    t = ring_matvec(place_event_shards(_t(X), mesh8, dtype=torch.float64),
                    _t(v))
    np.testing.assert_allclose(t.numpy(), X @ v, rtol=1e-10, atol=1e-12)
    after = [obs.value(*hops, op=op) for op in ("gram", "matvec")]
    assert [a - b for a, b in zip(after, before)] == [14, 14]
    assert (obs.value("pyconsensus_ring_collective_bytes_total", op="gram")
            - nbytes) == int(R * R * 8 * 14 / 8)


@pytest.mark.parametrize("uniform", [True, False])
def test_first_pc_matches_gram_eigh_and_reference(rng, mesh8, uniform):
    """The ring's first component against the reference's Gram eigh and
    its ring (``tests/test_ring.py`` ``TestRingFirstPC``), and against the
    port's own ``weighted_prin_comp``, up to sign, within 1e-9."""
    R, E = (24, 64) if uniform else (16, 32)
    X = rng.random((R, E))
    rep = np.full(R, 1.0 / R) if uniform else rng.random(R)
    rep = rep / rep.sum()
    l_ref, s_ref = jk.weighted_prin_comp(jnp.asarray(X), jnp.asarray(rep),
                                         method="eigh-gram")
    l_ring, s_ring = ref_ring_first_pc(jnp.asarray(X), jnp.asarray(rep),
                                       ref_make_mesh(batch=1, event=8))
    l_one, s_one = tk.weighted_prin_comp(_t(X), _t(rep), method="eigh-gram")
    l, s = ring_first_pc(_t(X), _t(rep), mesh8)
    assert l.shape == (E,) and s.shape == (R,)
    for lr, sr in ((l_ref, s_ref), (l_ring, s_ring), (l_one, s_one)):
        lr, sr = np.asarray(lr), np.asarray(sr)
        sign = np.sign(np.dot(l.numpy(), lr))
        np.testing.assert_allclose(sign * l.numpy(), lr, atol=1e-9)
        np.testing.assert_allclose(sign * s.numpy(), sr, atol=1e-9)


def test_matrix_needs_a_mesh(rng):
    with pytest.raises(ValueError, match="mesh="):
        ring_gram(_t(rng.random((4, 8))))
