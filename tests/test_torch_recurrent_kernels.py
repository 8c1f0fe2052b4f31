"""The port's WKV6 and SSD recurrences against the reference, on the CPU.

The same numpy inputs (decays drawn in (0.4, 0.99) and (0.5, 0.99), as the
reference's kernel tests) go through the reference's functions and the
port's: the sequential recurrences with an initial state, the chunked XLA
engines, and the kernel entries (here their plain versions, for CPU
tensors) against the reference's Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them.  Tolerances, float32: ``1e-5`` for a
sequential recurrence against a sequential one (one float32 sum order
against another over at most 64 steps); ``2e-4`` where one side is a
chunked form (decays folded into exponentials, the reference's own
tolerance); bfloat16: ``1e-2``, one bfloat16 rounding of a float32 result
that two implementations reach in different orders.  Also: state
continuity across a split, b and c passed with head stride 0, and the
kernel entries refusing non-CPU tensors here instead of computing plainly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ops import ssd as jssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunked as jssd_chunked  # noqa: E402
from repro.kernels.ssd.ref import ssd_reference as jssd_ref  # noqa: E402
from repro.kernels.wkv6.ops import wkv6 as jwkv6  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_chunked as jwkv6_chunked  # noqa
from repro.kernels.wkv6.ref import wkv6_reference as jwkv6_ref  # noqa
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_reference  # noqa
from repro_torch.kernels.wkv6 import (wkv6, wkv6_chunked,  # noqa: E402
                                      wkv6_reference)

SEQ = dict(atol=1e-5, rtol=1e-5)
CHUNKED = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)
SHAPES = [1, 13, 64]


def _wkv_inputs(rng, b, t, h, d):
    r, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.4, 0.99, (b, t, h, d)).astype(np.float32)
    u = rng.randn(h, d).astype(np.float32)
    return r, k, v, w, u


def _ssd_inputs(rng, b, t, h, p, n):
    x = rng.randn(b, t, h, p).astype(np.float32)
    a = rng.uniform(0.5, 0.99, (b, t, h)).astype(np.float32)
    bb, cc = (rng.randn(b, t, h, n).astype(np.float32) for _ in range(2))
    return x, a, bb, cc


def _j(arrs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in arrs]


def _t(arrs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in arrs]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("t", SHAPES)
def test_wkv6_recurrences_match_reference(rng, t):
    arrs = _wkv_inputs(rng, 2, t, 3, 8)
    s0 = rng.randn(2, 3, 8, 8).astype(np.float32)
    jy, js = jwkv6_ref(*_j(arrs), initial_state=jnp.asarray(s0))
    ty, ts = wkv6_reference(*_t(arrs), initial_state=torch.from_numpy(s0))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **SEQ)
    np.testing.assert_allclose(ts.numpy(), _np(js), **SEQ)
    jy, js = jwkv6_chunked(*_j(arrs))
    ty, ts = wkv6_chunked(*_t(arrs))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **CHUNKED)
    np.testing.assert_allclose(ts.numpy(), _np(js), **CHUNKED)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", SHAPES)
def test_wkv6_entry_matches_pallas_interpret(rng, t, dtype):
    arrs = _wkv_inputs(rng, 2, t, 2, 16)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    *jx, ju = _j(arrs, jdt)
    *tx, tu = _t(arrs, tdt)
    want = jwkv6(*jx, ju, chunk=8, interpret=True)
    kernels.reset_launches()
    got = wkv6(*tx, tu)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert kernels.launches()["wkv6"] == 0        # CPU: the plain version
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(SEQ if dtype == "float32" else BF16))


@pytest.mark.parametrize("t", SHAPES)
def test_ssd_recurrences_match_reference(rng, t):
    arrs = _ssd_inputs(rng, 2, t, 3, 8, 8)
    s0 = rng.randn(2, 3, 8, 8).astype(np.float32)
    jy, js = jssd_ref(*_j(arrs), initial_state=jnp.asarray(s0))
    ty, ts = ssd_reference(*_t(arrs), initial_state=torch.from_numpy(s0))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **SEQ)
    np.testing.assert_allclose(ts.numpy(), _np(js), **SEQ)
    jy, js = jssd_chunked(*_j(arrs), chunk=16)
    ty, ts = ssd_chunked(*_t(arrs), chunk=16)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **CHUNKED)
    np.testing.assert_allclose(ts.numpy(), _np(js), **CHUNKED)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", SHAPES)
def test_ssd_entry_matches_pallas_interpret(rng, t, dtype):
    arrs = _ssd_inputs(rng, 2, t, 2, 16, 8)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jssd(*_j(arrs, jdt), chunk=8, interpret=True)
    kernels.reset_launches()
    got = ssd(*_t(arrs, tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert kernels.launches()["ssd"] == 0
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(CHUNKED if dtype == "float32" else BF16))


def test_ssd_head_stride_zero_b_and_c(rng):
    """b and c as one (B, T, N) matrix expanded over heads (the mamba
    block's view, nothing copied) give what the materialized copies give."""
    x, a, bb, cc = _ssd_inputs(rng, 2, 13, 4, 8, 8)
    b1, c1 = bb[:, :, :1], cc[:, :, :1]
    tb = torch.from_numpy(b1).expand(2, 13, 4, 8)
    tc = torch.from_numpy(c1).expand(2, 13, 4, 8)
    assert tb.stride(2) == 0
    got = ssd(torch.from_numpy(x), torch.from_numpy(a), tb, tc)
    want, _ = jssd_ref(*_j((x, a, np.repeat(b1, 4, 2), np.repeat(c1, 4, 2))))
    np.testing.assert_allclose(got.numpy(), _np(want), **SEQ)


def test_state_continuity_across_a_split(rng):
    """Two halves with the state carried equal the whole, for both."""
    r, k, v, w, u = _t(_wkv_inputs(rng, 1, 16, 2, 8))
    full, s_full = wkv6_reference(r, k, v, w, u)
    y1, s1 = wkv6_reference(r[:, :8], k[:, :8], v[:, :8], w[:, :8], u)
    y2, s2 = wkv6_reference(r[:, 8:], k[:, 8:], v[:, 8:], w[:, 8:], u,
                            initial_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(),
                               **SEQ)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **SEQ)
    x, a, bb, cc = _t(_ssd_inputs(rng, 1, 16, 2, 8, 4))
    full, s_full = ssd_reference(x, a, bb, cc)
    y1, s1 = ssd_reference(x[:, :8], a[:, :8], bb[:, :8], cc[:, :8])
    y2, s2 = ssd_reference(x[:, 8:], a[:, 8:], bb[:, 8:], cc[:, 8:],
                           initial_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(),
                               **SEQ)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **SEQ)


def test_non_cpu_tensors_never_take_the_plain_version(rng):
    """Off the CPU the entries launch the kernel or raise: meta tensors
    (no card here) raise, count no launch; bad dtypes and head sizes are
    refused before any launch."""
    kernels.reset_launches()
    r, k, v, w, u = (x.to("meta") for x in _t(_wkv_inputs(rng, 1, 4, 2, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(r, k, v, w, u)
    x, a, bb, cc = (t.to("meta") for t in _t(_ssd_inputs(rng, 1, 4, 2, 8, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        ssd(x, a, bb, cc)
    assert kernels.launches()["wkv6"] == kernels.launches()["ssd"] == 0
    assert {"wkv6", "ssd"} <= set(kernels.launches())
