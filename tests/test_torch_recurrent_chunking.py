"""The blocking of the chunked bf16 SSD and WKV6 kernels, mirrored in torch
on the CPU and held against the sequential references.

``csrc/ssd.cu`` and ``csrc/wkv6.cu`` compute the recurrences in chunks of
L = 64 steps on the tensor cores (their source notes give the math).  A
CUDA kernel cannot run here, so each kernel's scheme is mirrored step for
step: the same chunk length, the same chunk-local cumulative log2 decays
(never summed across chunks), the same reference point at each 16-step
sub-chunk boundary for WKV6, the same split of A's pairs between a product
(earlier sub-chunks) and element-by-element sums (inside a sub-chunk, the
bonus u on the diagonal), and the same splitting of every float32 operand
of a product into two bfloat16 terms, hi + lo.  The mirrors run in float32
and are held against ``ssd_reference`` / ``wkv6_reference`` and the JAX
package's sequential references on numpy inputs made from a seed, within
``2e-4`` relative (the chunked engines' own tolerance: decays folded into
powers of two) and ``2e-5`` of the output's largest magnitude absolute
(each hi + lo operand carries a relative error up to 2^-17, summed over
up to 131 steps: ~1e-5 of the output's scale, where a wrong index or
decay moves it by ~1).  Decays: 1.0, 1e-6 and mixed (``exp(-exp(z))``, z ~ N(0, 1.5): per
channel for WKV6, so channels below 1e-3 sit beside channels near 1 in one
head; per head, with a spread over time, for SSD), at T in {1, L - 1,
L + 1, 2 L + 3}.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ref import ssd_reference as jssd_ref  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_reference as jwkv6_ref  # noqa
from repro_torch.kernels.ssd import ssd_reference  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_reference  # noqa: E402

L, SUB = 64, 16          # the kernels' chunk and WKV6's sub-chunk
TS = [1, L - 1, L + 1, 2 * L + 3]
DECAYS = ["1.0", "1e-6", "mixed"]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * float(np.abs(want).max()))


def _split(x, mode):
    """x as the kernels feed a float32 operand to the tensor cores: two
    bfloat16 terms hi + lo (``recurrence.cuh`` split2; mode "hi+lo"), or,
    for comparison, rounded once ("hi") or left float32 ("exact")."""
    if mode == "exact":
        return x, torch.zeros_like(x)
    hi = x.to(torch.bfloat16).float()
    if mode == "hi":
        return hi, torch.zeros_like(x)
    return hi, (x - hi).to(torch.bfloat16).float()


def _chunk(v, t0, pad):
    """Steps [t0, t0 + L) of a (B, T, ...) tensor, padded past T."""
    part = v[:, t0:t0 + L]
    rest = L - part.shape[1]
    if rest:
        fill = torch.full((v.shape[0], rest, *v.shape[2:]), pad)
        part = torch.cat([part, fill], dim=1)
    return part


def ssd_mirror(x, a, b, c, split="hi+lo"):
    """``chunk_kernel`` of csrc/ssd.cu: per chunk, with cum the inclusive
    cumsum of log2 max(a, 1e-37) inside the chunk,
    Y = 2^cum_t (C H_in) + (C Bᵀ ⊙ 2^(cum_t - cum_s) [s <= t]) X and
    H_out = 2^cum_L H_in + Bᵀ (2^(cum_L - cum_s) X); M, H_in and the
    decayed X as hi + lo.  Returns y (B, T, H, P) float32."""
    x, a, b, c = (v.float() for v in (x, a, b, c))
    bs, t, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros(bs, h, n, p)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))   # s <= t
    ys = []
    for t0 in range(0, t, L):
        xc, bc, cc = (_chunk(v, t0, 0.0) for v in (x, b, c))
        cum = torch.cumsum(torch.log2(torch.clamp(_chunk(a, t0, 1.0),
                                                  min=1e-37)), dim=1)
        hh, hl = _split(state, split)
        y = (torch.einsum("bthn,bhnp->bthp", cc, hh)
             + torch.einsum("bthn,bhnp->bthp", cc, hl))
        y = y * torch.exp2(cum)[..., None]
        g = torch.einsum("bthn,bshn->bhts", cc, bc)
        seg = (cum[:, :, None] - cum[:, None]).permute(0, 3, 1, 2)
        m = torch.where(tri, g * torch.exp2(seg), 0.0)
        mh, ml = _split(m, split)
        y = (y + torch.einsum("bhts,bshp->bthp", mh, xc)
             + torch.einsum("bhts,bshp->bthp", ml, xc))
        ys.append(y)
        xh, xl = _split(xc * torch.exp2(cum[:, -1:] - cum)[..., None], split)
        state = (torch.exp2(cum[:, -1])[..., None, None] * state
                 + torch.einsum("bshn,bshp->bhnp", bc, xh)
                 + torch.einsum("bshn,bshp->bhnp", bc, xl))
    return torch.cat(ys, dim=1)[:, :t]


def _wkv6_a(rc, kc, cwx, u, split):
    """A (B, H, L, L) of one chunk: earlier sub-chunks as one product at
    the reference point c = 16 I, both factors <= 1 (hi + lo each, three
    products); the sub-chunk itself element by element with
    2^(cw_{t-1} - cw_s) for s < t and u for s = t.  ``cwx`` (B, L + 1, H,
    D): row t the sum of log2 w over the chunk's steps before t."""
    bs, _, h, d = rc.shape
    a = torch.zeros(bs, h, L, L)
    lower = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)
    diag = torch.eye(SUB, dtype=torch.bool)
    for i in range(L // SUB):
        r0 = SUB * i
        rows = slice(r0, r0 + SUB)
        if i:
            ref = cwx[:, r0:r0 + 1]
            qh, ql = _split(rc[:, rows] * torch.exp2(cwx[:, rows] - ref),
                            split)
            kh, kl = _split(kc[:, :r0] * torch.exp2(ref - cwx[:, 1:r0 + 1]),
                            split)
            a[:, :, rows, :r0] = sum(torch.einsum("bthd,bshd->bhts", qq, kk)
                                     for qq, kk in ((qh, kh), (qh, kl),
                                                    (ql, kh)))
        e = cwx[:, rows, None] - cwx[:, None, r0 + 1:r0 + SUB + 1]
        f = torch.where(lower[None, :, :, None, None], torch.exp2(e),
                        torch.where(diag[None, :, :, None, None],
                                    u[None, None, None], 0.0))
        a[:, :, rows, rows] = torch.einsum("bthd,bshd,btshd->bhts",
                                           rc[:, rows], kc[:, rows], f)
    return a


def wkv6_mirror(r, k, v, w, u, split="hi+lo"):
    """``chunk_kernel`` of csrc/wkv6.cu: per chunk, with cw the per-channel
    inclusive cumsum of log2 max(w, 1e-37) inside the chunk,
    y = A V + (r_t 2^cw_{t-1}) S_in and
    S_out = diag(2^cw_L) S_in + Σ_s (k_s 2^(cw_L - cw_s)) ⊗ v_s; every
    float32 operand of a product as hi + lo.  Returns y float32."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    bs, t, h, d = r.shape
    state = torch.zeros(bs, h, d, d)
    ys = []
    for t0 in range(0, t, L):
        rc, kc, vc = (_chunk(x, t0, 0.0) for x in (r, k, v))
        lw = torch.log2(torch.clamp(_chunk(w, t0, 1.0), min=1e-37))
        cwx = torch.cat([torch.zeros(bs, 1, h, d), torch.cumsum(lw, 1)], 1)
        ah, al = _split(_wkv6_a(rc, kc, cwx, u, split), split)
        y = (torch.einsum("bhts,bshj->bthj", ah, vc)
             + torch.einsum("bhts,bshj->bthj", al, vc))
        qh, ql = _split(rc * torch.exp2(cwx[:, :L]), split)
        sh, sl = _split(state, split)
        y = y + sum(torch.einsum("bthi,bhij->bthj", qq, ss)
                    for qq, ss in ((qh, sh), (qh, sl), (ql, sh)))
        ys.append(y)
        kh, kl = _split(kc * torch.exp2(cwx[:, L:] - cwx[:, 1:]), split)
        state = (torch.exp2(cwx[:, L])[..., None] * state
                 + torch.einsum("bshi,bshj->bhij", kh, vc)
                 + torch.einsum("bshi,bshj->bhij", kl, vc))
    return torch.cat(ys, dim=1)[:, :t]


def _wkv_inputs(rng, b, t, h, d, decay):
    r, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    if decay == "mixed":
        w = np.exp(-np.exp(rng.randn(b, t, h, d) * 1.5))
    else:
        w = np.full((b, t, h, d), float(decay))
    u = rng.randn(h, d).astype(np.float32)
    return r, k, v, w.astype(np.float32), u


def _ssd_inputs(rng, b, t, h, p, n, decay):
    x = rng.randn(b, t, h, p).astype(np.float32)
    if decay == "mixed":
        z = rng.randn(1, 1, h) * 1.5 + rng.randn(b, t, h) * 0.5
        a = np.exp(-np.exp(z))
    else:
        a = np.full((b, t, h), float(decay))
    bb, cc = (rng.randn(b, t, h, n).astype(np.float32) for _ in range(2))
    return x, a.astype(np.float32), bb, cc


def _t(arrs):
    return [torch.from_numpy(x) for x in arrs]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("t", TS)
def test_ssd_mirror_matches_references(rng, t, decay):
    arrs = _ssd_inputs(rng, 2, t, 3, 16, 16, decay)
    got = ssd_mirror(*_t(arrs)).numpy()
    _close(got, ssd_reference(*_t(arrs))[0].numpy())
    _close(got, _np(jssd_ref(*map(jnp.asarray, arrs))[0]))


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("t", TS)
def test_wkv6_mirror_matches_references(rng, t, decay):
    arrs = _wkv_inputs(rng, 2, t, 2, 16, decay)
    got = wkv6_mirror(*_t(arrs)).numpy()
    _close(got, wkv6_reference(*_t(arrs))[0].numpy())
    _close(got, _np(jwkv6_ref(*map(jnp.asarray, arrs))[0]))


def test_wkv6_mirror_is_finite_where_the_plain_factorization_overflows(
        rng):
    """At w = 1e-6 the one-sided factorization of a whole chunk,
    k_s 2^-cw_s (wkv6_chunked without its clamp), passes float32's range
    within 7 steps; the sub-chunk scheme's exponents are all <= 0, so the
    mirror stays finite and equals the sequential recurrence."""
    arrs = _wkv_inputs(rng, 1, 2 * L + 3, 2, 16, "1e-6")
    r, k, v, w, u = _t(arrs)
    cw = torch.cumsum(torch.log2(w[:, :L]), dim=1)
    assert torch.isinf(k[:, :L] * torch.exp2(-cw)).any()
    got = wkv6_mirror(r, k, v, w, u)
    assert torch.isfinite(got).all()
    _close(got.numpy(), wkv6_reference(r, k, v, w, u)[0].numpy())


@pytest.mark.parametrize("kernel", ["ssd", "wkv6"])
def test_operand_split_stays_inside_bfloat16_tolerance(rng, kernel):
    """Why the bfloat16 kernels split their float32 operands, and why the
    bfloat16 tolerance (1e-2 absolute and relative) holds for them, at the
    served length T = 2048 (two heads of the served width: zamba2-7b's
    P = N = 64, rwkv6-3b's D = 64) with bfloat16 inputs and mixed decays.
    hi + lo moves the float32 result by < 1e-5 of its scale (~4e-6 here);
    one bfloat16 rounding of the same operands moves it ~700 times as far,
    and then elements near 0 leave the tolerance.  After the output's own
    rounding the split mirror and the plain version differ by at most one
    bfloat16 ulp, inside 1e-2."""
    if kernel == "ssd":
        arrs = _ssd_inputs(rng, 1, 2048, 2, 64, 64, "mixed")
        mirror, plain = ssd_mirror, ssd_reference
    else:
        arrs = _wkv_inputs(rng, 1, 2048, 2, 64, "mixed")
        mirror, plain = wkv6_mirror, wkv6_reference
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in arrs]
    if kernel == "wkv6":
        bf[-1] = bf[-1].float()          # u stays float32
    exact = mirror(*bf, split="exact")
    want = plain(*bf)[0].float()
    split, rounded = mirror(*bf), mirror(*bf, split="hi")
    moved = float((split - exact).abs().max())
    assert moved < 1e-5 * float(exact.abs().max())
    assert float((rounded - exact).abs().max()) > 100 * moved

    def outside(y):
        y = y.to(torch.bfloat16).float()
        return int(((y - want).abs() > 1e-2 + 1e-2 * want.abs()).sum())

    assert outside(split) == 0 and outside(rounded) > 0
