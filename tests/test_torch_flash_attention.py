"""The port's flash-attention wrappers against the reference's Pallas kernel.

On the CPU both entries (``flash_attention`` in (B, S, H, D) and
``flash_attention_hmajor`` heads-major) run the plain PyTorch version, so
these tests hold it against the reference kernel in interpret mode and
against ``mha_reference``, on the same numpy inputs, at the shapes of the
reference's own kernel tests and at the wide head dims (160, 256) the
kernel takes.  Tolerance: the reference's own float32 tolerance, ``8 *
2e-5`` (blocked online softmax and the dense softmax sum in other orders).
One test models, in plain PyTorch, the single rounding the card's
bfloat16 tensor-core kernel adds (P to bfloat16 before P V) and holds it
within the chip check's unchanged bfloat16 tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jfa  # noqa
from repro.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import mha_reference  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

TOL = 8 * 2e-5


def _qkv(rng, b, sq, skv, h, kv, d):
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, kv, d).astype(np.float32),
            rng.randn(b, skv, kv, d).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("b,s,h,kv,d", [
    (1, 16, 2, 2, 8),       # MHA tiny
    (2, 48, 4, 2, 16),      # GQA, non-multiple-of-block seq
    (1, 128, 8, 1, 32),     # MQA, block-aligned
])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16)])
def test_flash_attention_matches_reference(rng, b, s, h, kv, d, causal,
                                           window):
    q, k, v = _qkv(rng, b, s, s, h, kv, d)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    kern = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window, interpret=True)
    ref = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 4)])
def test_flash_attention_hmajor_matches_reference(rng, causal, window):
    """The heads-major entry against the reference's block-aligned
    ``flash_attention_hmajor`` (blocks of 8 over 16 positions, GQA)."""
    q, k, v = _qkv(rng, 2, 16, 16, 4, 2, 8)
    qh, kh, vh = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    got = tfa.flash_attention_hmajor(*_t(qh, kh, vh), causal=causal,
                                     window=window)
    want = jfa.flash_attention_hmajor(
        jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh), causal=causal,
        window=window, block_q=8, block_k=8, interpret=True)
    assert got.shape == (2, 4, 16, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_flash_attention_sm_scale(rng):
    q, k, v = _qkv(rng, 1, 16, 16, 2, 1, 8)
    got = tfa.flash_attention(*_t(q, k, v), sm_scale=0.3)
    want = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("sq,skv", [(1, 40), (5, 40), (100, 1000)])
def test_flash_attention_decode_shapes(rng, sq, skv):
    """q_len < kv_len, causal, end-aligned (the serve_step hot path)."""
    q, k, v = _qkv(rng, 2, sq, skv, 4, 2, 16)
    got = tfa.flash_attention(*_t(q, k, v), causal=True)
    ref = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    if sq <= 5:
        kern = flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL,
                                   rtol=TOL)


def test_fully_masked_rows_follow_mha_reference(rng):
    """q_len 4 > kv_len 3, causal: query 0 sees no key.  The port (and
    ``mha_reference``) give the mean of v over the 3 keys; the reference
    kernel gives sum(v) / block_k there (its running max starts at the
    -1e30 of the masked logits, so every masked key weighs exp(0) = 1 and
    the normalizer is the block size).  Rows with a key agree."""
    q, k, v = _qkv(rng, 1, 4, 3, 2, 1, 8)
    got = tfa.flash_attention(*_t(q, k, v), causal=True).numpy()
    ref = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True))
    kern = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      interpret=True))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)           # (1, H, D)
    np.testing.assert_allclose(got[:, 0], mean_v, atol=TOL, rtol=TOL)
    block_k = 8                         # the reference pads kv_len 3 to 8
    want_kern = np.repeat(v.sum(axis=1), 2, axis=1) / block_k
    np.testing.assert_allclose(kern[:, 0], want_kern, atol=TOL, rtol=TOL)
    assert not np.allclose(kern[:, 0], got[:, 0], atol=1e-3)
    np.testing.assert_allclose(got[:, 1:], kern[:, 1:], atol=TOL, rtol=TOL)


def test_plain_bfloat16_casts_back(rng):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(rng, 1, 16, 16, 2, 2, 8))
    got = tfa.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=1e-2, rtol=1e-2)


def test_non_cpu_tensors_never_take_the_plain_version(rng):
    """Off the CPU the wrapper launches the kernel or raises: meta tensors
    (no CUDA here) raise instead of falling back, and count no launch."""
    kernels.reset_launches()
    q, k, v = (t.to("meta") for t in _t(*_qkv(rng, 1, 16, 16, 2, 2, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_hmajor(q, k, v)
    assert kernels.launches()["flash_attention"] == 0


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16)])
def test_flash_attention_wide_heads_match_reference(rng, d, causal, window):
    """head_dim 160 (stablelm-12b) and 256, the widest the kernel takes,
    GQA 4 / 2 over 40 positions: the plain version against the reference
    kernel in interpret mode and ``mha_reference``, float32."""
    q, k, v = _qkv(rng, 1, 40, 40, 4, 2, d)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert got.shape == (1, 40, 4, d) and got.dtype == torch.float32
    kern = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window, interpret=True)
    ref = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("d,match", [(160, "CUDA"), (256, "CUDA"),
                                     (264, "unsupported shapes"),
                                     (100, "unsupported shapes")])
def test_head_dim_limits_on_meta_tensors(d, match):
    """Head dims that are multiples of 8 up to 256 pass the wrappers'
    shape checks (meta tensors then meet the CUDA refusal); 264 (above
    256) and 100 (no multiple of 8) are refused as shapes."""
    kernels.reset_launches()
    q = torch.empty(2, 24, 4, d, device="meta")
    kv = torch.empty(2, 24, 2, d, device="meta")
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_hmajor(q.transpose(1, 2), kv.transpose(1, 2),
                                   kv.transpose(1, 2))
    assert kernels.launches()["flash_attention"] == 0


def _tensor_core_model(q, k, v, block_k=128):
    """The bfloat16 kernel's arithmetic in plain PyTorch, causal: float32
    logits of the bfloat16 inputs (their products are exact in float32),
    an online softmax over key tiles of ``block_k`` with the probabilities
    P rounded to bfloat16 before P V (the tensor core's A operand) and
    float32 sums.  Returns the float32 output before the kernel's one
    rounding of it.  q (B, S, H, D), k, v (B, S, K, D)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qf = q.float().transpose(1, 2)                              # B H S D
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    logits = (qf @ kf.transpose(-1, -2)) * d ** -0.5
    logits = logits.masked_fill(~tfa.attention_mask(s, s, causal=True,
                                                     window=0), -torch.inf)
    m = torch.full((b, h, s, 1), -torch.inf)
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, h, s, d))
    for k0 in range(0, s, block_k):
        x = logits[..., k0:k0 + block_k]
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new).nan_to_num(0.0)
        p = torch.exp(x - m_new).nan_to_num(0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + block_k]
        m = m_new
    return (o / l).transpose(1, 2)


def test_p_rounding_stays_inside_bfloat16_tolerance(rng):
    """Why the chip check's bfloat16 tolerance (1e-2 absolute and
    relative) stays as it was for the tensor-core kernel.  Its one new
    rounding, P to bfloat16 (relative 2^-9 per probability), moves the
    float32 output by at most ~2e-3 at 1 x 2048, 2 / 1 heads of 128,
    unit-normal bfloat16 inputs, causal (the served prefill's shape, one
    head pair; the largest moves are the first rows, whose few
    probabilities are near 1); after the output's own rounding the kernel
    and the plain version then differ by at most one bfloat16 ulp (0.0078
    at |x| < 2), inside 1e-2."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(rng, 1, 2048, 2048, 2, 1, 128))
    model = _tensor_core_model(q, k, v)
    plain32 = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=True)
    moved = float((model - plain32).abs().max())
    assert 0 < moved < 5e-3
    plain = tfa.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(model.to(torch.bfloat16).float().numpy(),
                               plain.float().numpy(), atol=1e-2, rtol=1e-2)
