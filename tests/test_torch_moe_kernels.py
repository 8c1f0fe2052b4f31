"""The port's grouped expert matmul against the reference, on the CPU.

The same numpy inputs go through the reference's ``grouped_matmul`` (its
Pallas ``gmm`` in interpret mode, block 8, as ``tests/test_kernels.py``
runs it) and ``gmm_reference``, and through the port's ``grouped_matmul``
(for CPU tensors its plain version ``gmm_reference``), at the reference's
kernel-test shapes and a few more: C, D and F that are no multiple of any
tile, E = 1, all-zero capacity rows, a weight slice of a stacked layer tree
and a non-contiguous x.  Tolerances: float32 ``atol = rtol = 1e-4`` (one
float32 sum order against another over D terms); bfloat16 ``1e-2`` (both
sides round one float32 sum to bfloat16: one ulp, 2^-8 relative, apart at
most).  Also: the kernel entry ``gmm`` refuses CPU and meta tensors (no
card here) instead of computing plainly, and counts no launch; and the
bfloat16 kernel's operand check (``_tma_ready``) keeps the operands its
TMA tensor maps can read and pads a copy of the others.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm.ops import grouped_matmul as jgmm  # noqa: E402
from repro.kernels.moe_gmm.ref import gmm_reference as jgmm_ref  # noqa
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.moe_gmm import (_tma_ready, gmm,  # noqa: E402
                                         gmm_reference, grouped_matmul)

TOL = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)
# the reference's kernel-test shapes, then ragged and single-expert ones
SHAPES = [(2, 8, 8, 8), (4, 20, 12, 28), (3, 128, 64, 32), (1, 33, 40, 17),
          (2, 1, 8, 136)]
DTYPES = {"float32": (jnp.float32, torch.float32, TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _inputs(rng, e, c, d, f):
    return (rng.randn(e, c, d).astype(np.float32),
            rng.randn(e, d, f).astype(np.float32))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("e,c,d,f", SHAPES)
def test_grouped_matmul_matches_pallas_interpret(rng, e, c, d, f, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(rng, e, c, d, f)
    want = jgmm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), block=8,
                interpret=True)
    kernels.reset_launches()
    got = grouped_matmul(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (e, c, f)
    assert kernels.launches()["gmm"] == 0        # CPU: the plain version
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("e,c,d,f", SHAPES)
def test_gmm_reference_matches_reference(rng, e, c, d, f, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(rng, e, c, d, f)
    want = jgmm_ref(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    got = gmm_reference(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def test_strided_operands_and_empty_rows(rng):
    """A layer's weight slice of a stacked (L, E, D, F) tree, a
    non-contiguous x and all-zero capacity rows give what contiguous
    copies give; zero rows give zero outputs."""
    x, _ = _inputs(rng, 3, 24, 16, 8)
    stacked = torch.from_numpy(rng.randn(2, 3, 16, 40).astype(np.float32))
    w = stacked[1, :, :, 4:36]                   # a view at an offset
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
    xt[:, 10:] = 0.0                             # empty capacity slots
    assert not xt.is_contiguous() and not w.is_contiguous()
    got = grouped_matmul(xt, w)
    want = jgmm(jnp.asarray(xt.contiguous().numpy()),
                jnp.asarray(w.contiguous().numpy()), block=8,
                interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert not got[:, 10:].any()


def test_kernel_entry_never_takes_the_plain_version(rng):
    """``gmm`` is the kernel: CPU tensors and meta tensors (no card here)
    raise before any launch, and count none; ``grouped_matmul`` sends a
    non-CPU tensor to it rather than to the plain version."""
    x, w = (torch.from_numpy(a) for a in _inputs(rng, 2, 8, 8, 8))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        gmm(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        gmm(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul(x.to("meta"), w.to("meta"))
    assert kernels.launches()["gmm"] == 0
    assert "gmm" in kernels.launches()


def _stacked(rng, lo, hi):
    stacked = torch.from_numpy(rng.randn(2, 4, 64, 400).astype(np.float32))
    return stacked.to(torch.bfloat16)[1, :, :, lo:hi]


@pytest.mark.parametrize("name,make,kept", [
    ("contiguous", lambda rng: torch.zeros(4, 20, 16, dtype=torch.bfloat16),
     True),
    ("layer slice at 8", lambda rng: _stacked(rng, 8, 392), True),
    ("E = 1, C = 1", lambda rng: torch.zeros(1, 1, 40, dtype=torch.bfloat16),
     True),
    ("rows of 12", lambda rng: torch.zeros(4, 20, 12, dtype=torch.bfloat16),
     False),
    ("layer slice at 4", lambda rng: _stacked(rng, 4, 388), False),
    ("transposed", lambda rng: torch.zeros(4, 64, 24, dtype=torch.bfloat16)
     .transpose(1, 2), False),
])
def test_tma_ready_keeps_or_pads(rng, name, make, kept):
    """What the bfloat16 kernel's TMA tensor maps read in place (unit inner
    stride, 16-byte aligned base, outer strides of the dimensions above 1
    multiples of 8 elements) is passed as it is; anything else becomes a
    copy with rows padded to a multiple of 8, equal in value."""
    t = make(rng)
    got = _tma_ready(t)
    assert (got is t) == kept
    assert got.shape == t.shape and torch.equal(got, t)
    assert got.stride(-1) == 1 and got.data_ptr() % 16 == 0
    assert all(st % 8 == 0 for st, n in zip(got.stride()[:-1],
                                            got.shape[:-1]) if n > 1)
