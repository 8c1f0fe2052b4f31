"""The port's two kernel wrappers against the reference's Pallas kernels.

On the CPU a wrapper runs its kernel's plain PyTorch version, so these
tests hold that version against the reference Pallas kernel (interpret
mode) and the NumPy oracles of ``stores/ref.py``, on the same numpy inputs,
including the edge cases: no edges / rows, ``-1`` padding and out-of-range
ids, an all-zero mask, and node / group counts that are not a multiple of
128.  Tolerance: sums ``rtol=1e-5, atol=1e-6`` (summation order differs
between frameworks); counts exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.stores import ref  # noqa: E402
from repro.stores.graph_kernels import scatter_add_pallas  # noqa: E402
from repro.stores.masked_kernels import masked_segment_agg_pallas  # noqa
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import (masked_segment_agg,  # noqa: E402
                                 masked_segment_agg_plain, scatter_add,
                                 scatter_add_plain)

RTOL, ATOL = 1e-5, 1e-6

# (edges, nodes, share of padded / out-of-range edges)
SCATTER_CASES = [(0, 64, 0.0), (1, 1, 0.0), (700, 300, 0.0),
                 (2048, 1000, 0.25), (3000, 131, 1.0)]


def _edges(seed, e, n, pad):
    r = np.random.RandomState(seed)
    vals = r.randn(e).astype(np.float32)
    dst = r.randint(0, n, e).astype(np.int32)
    bad = r.rand(e) < pad
    dst[bad] = np.where(r.rand(int(bad.sum())) < 0.5, -1,
                        n + r.randint(0, 5, int(bad.sum())))
    return vals, dst


@pytest.mark.parametrize("e,n,pad", SCATTER_CASES)
def test_scatter_add_matches_pallas_and_ref(e, n, pad):
    vals, dst = _edges(e + n, e, n, pad)
    got = scatter_add(torch.from_numpy(vals), torch.from_numpy(dst), n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = np.asarray(scatter_add_pallas(jnp.asarray(vals), jnp.asarray(dst),
                                         num_nodes=n, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ok = (dst >= 0) & (dst < n)
    oracle = ref.spmv_ref(np.arange(ok.sum()), dst[ok], np.ones(ok.sum()), n,
                          np.r_[vals[ok], np.zeros(max(n - ok.sum(), 0))])
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)


# (rows, groups, share of masked-in rows, share of padded keys)
SEGAGG_CASES = [(0, 64, 0.5, 0.0), (1, 1, 1.0, 0.0), (900, 300, 0.6, 0.0),
                (2048, 1000, 0.4, 0.2), (1500, 129, 0.0, 0.1),
                (3000, 131, 1.0, 1.0)]


@pytest.mark.parametrize("r,g,keep,pad", SEGAGG_CASES)
def test_masked_segment_agg_matches_pallas_and_ref(r, g, keep, pad):
    rs = np.random.RandomState(r + g)
    vals = rs.randn(r).astype(np.float32)
    keys = rs.randint(0, g, r).astype(np.int32)
    keys[rs.rand(r) < pad] = -1
    mw = (rs.rand(r) < keep).astype(np.float32)
    s, c = masked_segment_agg(torch.from_numpy(vals), torch.from_numpy(keys),
                              torch.from_numpy(mw), g)
    ps, pc = masked_segment_agg_pallas(jnp.asarray(vals), jnp.asarray(keys),
                                       jnp.asarray(mw), num_groups=g,
                                       interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(pc))
    ok = keys >= 0
    rsum, rcnt = ref.masked_segment_agg_ref(vals[ok], keys[ok], mw[ok], g)
    np.testing.assert_allclose(s.numpy(), rsum, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(c.numpy(), rcnt)
    if keep == 0.0:
        assert not c.any() and not s.any()


def test_cpu_tensors_never_launch_a_kernel():
    kernels.reset_launches()
    vals, dst = _edges(0, 500, 70, 0.1)
    scatter_add(torch.from_numpy(vals), torch.from_numpy(dst), 70)
    masked_segment_agg(torch.from_numpy(vals), torch.from_numpy(dst),
                       torch.ones(500), 70)
    assert scatter_add.launches == 0
    assert masked_segment_agg.launches == 0


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU goes to the kernel or raises: here a meta
    tensor (no card on this machine) is refused, not computed plainly."""
    vals = torch.zeros(8, device="meta")
    dst = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        scatter_add(vals, dst, 4)
    with pytest.raises(ValueError):   # vals on the CPU, dst off it
        scatter_add(torch.zeros(8), dst, 4)
    with pytest.raises(ValueError):
        masked_segment_agg(vals, dst, vals, 4)
    assert scatter_add.launches == 0 and masked_segment_agg.launches == 0


def test_plain_versions_drop_padding_without_touching_other_slots():
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0])
    dst = torch.tensor([-1, 0, 3, 2], dtype=torch.int32)
    assert scatter_add_plain(vals, dst, 3).tolist() == [2.0, 0.0, 8.0]
    s, c = masked_segment_agg_plain(vals, dst, torch.tensor([1., 1., 1., 0.]),
                                    3)
    assert s.tolist() == [2.0, 0.0, 0.0] and c.tolist() == [1.0, 0.0, 0.0]
