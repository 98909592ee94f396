"""The port's CSR segment sum (``ops.csr_segment_sum`` on CPU tensors, the
plain version the CUDA kernel is held against on the card) against the JAX
package's Pallas kernel in interpret mode (with its host ``plan_tiles``)
and its oracle, at rtol/atol 1e-5 (sums in another order).

The CUDA wrapper's planning step, ``row_pointers`` (CSR row pointers by
``searchsorted``, in place of ``plan_tiles``), runs on any device; a sum
over its ranges, the kernel's schedule, is held against the same
references here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.segment_sum import PAD_SENTINEL as J_SENTINEL
from repro.kernels.segment_sum import csr_segment_sum_pallas, plan_tiles
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum as kernel

RNG = np.random.default_rng(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _port(msgs, dst, n):
    before = kernel.LAUNCHES
    got = ops.csr_segment_sum(torch.from_numpy(msgs), torch.from_numpy(dst),
                              n)
    assert kernel.LAUNCHES == before          # a CPU tensor launches nothing
    assert got.dtype == torch.float32 and got.shape == (n, msgs.shape[1])
    return got.numpy()


def _csr_schedule(msgs, dst, n):
    """The CUDA kernel's schedule on the CPU: each node sums its contiguous
    rows row_ptr[v] .. row_ptr[v + 1] - 1 in edge order."""
    ptr = kernel.row_pointers(torch.from_numpy(dst), n).tolist()
    m = torch.from_numpy(msgs)
    out = torch.zeros((n, msgs.shape[1]))
    for v in range(n):
        for e in range(ptr[v], ptr[v + 1]):
            out[v] += m[e]
    return out.numpy()


def _pallas(msgs, dst, n, bn, be):
    first, t_max = plan_tiles(dst, n, bn, be, len(dst))
    out = csr_segment_sum_pallas(jnp.asarray(msgs), jnp.asarray(dst),
                                 jnp.asarray(first), n, bn=bn, be=be,
                                 t_max=t_max, interpret=True)
    return np.asarray(out)[:n]


def test_sentinel_is_the_reference_one():
    assert kernel.PAD_SENTINEL == J_SENTINEL == 0x3FFFFFFF


@pytest.mark.parametrize("e,d,n,bn,be", [
    (512, 64, 100, 128, 256),
    (1024, 128, 300, 128, 256),
    (256, 32, 1000, 128, 256),   # many empty blocks
])
def test_matches_pallas_interpret_and_oracle(e, d, n, bn, be):
    dst = np.sort(RNG.integers(0, n, size=e)).astype(np.int32)
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    got = _port(msgs, dst, n)
    np.testing.assert_allclose(got, _pallas(msgs, dst, n, bn, be), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.csr_segment_sum(
        jnp.asarray(msgs), jnp.asarray(dst), n)), **TOL)
    np.testing.assert_allclose(_csr_schedule(msgs, dst, n), got, **TOL)


def test_sentinel_padding():
    n, e, d = 50, 256, 16
    dst = np.sort(RNG.integers(0, n, size=e - 20)).astype(np.int32)
    dst = np.concatenate([dst, np.full(20, kernel.PAD_SENTINEL, np.int32)])
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    got = _port(msgs, dst, n)
    np.testing.assert_allclose(got, _pallas(msgs, dst, n, 128, 256), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.csr_segment_sum(
        jnp.asarray(msgs[:-20]), jnp.asarray(dst[:-20]), n)), **TOL)
    ptr = kernel.row_pointers(torch.from_numpy(dst), n)
    assert int(ptr[-1]) == e - 20                # padding is never read
    np.testing.assert_allclose(_csr_schedule(msgs, dst, n), got, **TOL)


@pytest.mark.parametrize("e,d,n", [(300, 24, 40), (700, 20, 90)])
def test_minus_one_padding_through_ops(monkeypatch, e, d, n):
    """-1 padding at the end of the sorted list, through both packages'
    ``ops`` entries (the reference's with its Pallas kernel forced, which
    maps -1 to the sentinel and pads E to its tile)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    dst = np.sort(RNG.integers(0, n, size=e)).astype(np.int32)
    dst[-37:] = -1
    msgs = RNG.normal(size=(e, d)).astype(np.float32)
    got = _port(msgs, dst, n)
    want = jops.csr_segment_sum(jnp.asarray(msgs), jnp.asarray(dst), n)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.csr_segment_sum(
        jnp.asarray(msgs), jnp.asarray(dst), n)), **TOL)
    mapped = np.where(dst < 0, kernel.PAD_SENTINEL, dst).astype(np.int32)
    np.testing.assert_allclose(_csr_schedule(msgs, mapped, n), got, **TOL)


def test_many_empty_nodes():
    """Edges on 10 of 2000 nodes: every other node sums to zero."""
    n, d = 2000, 8
    nodes = np.sort(RNG.choice(n, size=10, replace=False))
    dst = np.sort(RNG.choice(nodes, size=256)).astype(np.int32)
    msgs = RNG.normal(size=(256, d)).astype(np.float32)
    got = _port(msgs, dst, n)
    np.testing.assert_allclose(got, _pallas(msgs, dst, n, 128, 256), **TOL)
    empty = np.setdiff1d(np.arange(n), nodes)
    assert not got[empty].any()
    np.testing.assert_allclose(_csr_schedule(msgs, dst, n), got, **TOL)
