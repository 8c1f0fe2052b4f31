"""The kernel entries' backward against the reference's, on the CPU.

The reference differentiates its four model kernels through a
``jax.custom_vjp`` whose backward is the VJP of the kernel's plain oracle
(``src/repro/kernels/*/ops.py``); the port's entries run through
``kernels/autograd.py::PlainVJP`` under autograd, whose backward is the VJP
of the port's plain version.  Checked, on numpy inputs from a seed:

  * the gradients of flash attention (both layouts; causal, windowed, GQA,
    non-causal), the grouped expert matmul (a ragged capacity C), WKV6
    (r, k, v, w, u) and SSD (x, a, b, c; b and c shared over heads as the
    mamba block passes them, and per head) against ``jax.grad`` through
    the reference's entries (the Pallas kernels in interpret mode, as the
    reference's own tests run them), and the forward outputs;
  * an entry goes through ``PlainVJP`` only when grad mode is on and an
    input requires grad, and then its gradient equals the plain version's
    autograd on the same inputs.

Tolerances: float32 throughout; gradients within ``1e-5`` of each
gradient's largest magnitude (``atol``) and ``rtol=1e-5`` (the same float32
math summed in another order; the recurrences over 20 steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jflash  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_hmajor as jflash_hmajor)
from repro.kernels.moe_gmm import ops as jgmm  # noqa: E402
from repro.kernels.ssd import ops as jssd  # noqa: E402
from repro.kernels.wkv6 import ops as jwkv6  # noqa: E402
from repro_torch.kernels import autograd as tautograd  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.kernels import wkv6 as twkv6  # noqa: E402

RTOL = 1e-5
REL_ATOL = 1e-5


def close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=REL_ATOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def port_grads(entry, arrays, cot):
    """The port entry's output and the gradients of ``sum(out * cot)``
    with respect to every input."""
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = entry(*xs)
    assert type(out.grad_fn).__name__ == "PlainVJPBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    return out, [x.grad for x in xs]


def ref_grads(entry, arrays, cot):
    """The reference entry's output and ``jax.grad`` of the same sum."""
    args = [jnp.asarray(a) for a in arrays]
    out, vjp = jax.vjp(entry, *args)
    return out, vjp(jnp.asarray(cot))


def check_grads(port_entry, ref_entry, arrays, cot):
    out, grads = port_grads(port_entry, arrays, cot)
    jout, jgrads = ref_grads(ref_entry, arrays, cot)
    close(out, jout, "forward")
    assert len(grads) == len(jgrads)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        close(g, jg, f"gradient of input {i}")


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (b, sq, skv, heads, kv heads, head_dim, causal, window)
FLASH_CASES = {
    "causal": (2, 16, 16, 4, 4, 16, True, 0),
    "windowed": (1, 24, 24, 4, 4, 16, True, 5),
    "GQA": (2, 16, 16, 4, 2, 16, True, 0),
    "GQA windowed": (1, 20, 20, 6, 2, 8, True, 7),
    "non-causal ragged": (1, 13, 13, 4, 2, 16, False, 0),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_gradients_match_reference(name):
    b, sq, skv, h, kh, d, causal, window = FLASH_CASES[name]
    rng = np.random.RandomState(0)
    arrays = [normal(rng, b, sq, h, d), normal(rng, b, skv, kh, d),
              normal(rng, b, skv, kh, d)]
    cot = normal(rng, b, sq, h, d)
    check_grads(
        lambda q, k, v: tflash.flash_attention(q, k, v, causal=causal,
                                               window=window),
        lambda q, k, v: jflash.flash_attention(q, k, v, causal=causal,
                                               window=window, block_q=8,
                                               block_k=8, interpret=True),
        arrays, cot)


def test_flash_attention_hmajor_gradients_match_reference():
    """The heads-major entry through the same rule: the reference's
    ``flash_attention_hmajor`` has no VJP of its own, so its gradient is
    the transposed layout's through ``ops.flash_attention``."""
    b, s, h, kh, d = 2, 16, 4, 2, 16
    rng = np.random.RandomState(1)
    arrays = [normal(rng, b, h, s, d), normal(rng, b, kh, s, d),
              normal(rng, b, kh, s, d)]
    cot = normal(rng, b, h, s, d)

    def ref(q, k, v):
        t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
        return t(jflash.flash_attention(t(q), t(k), t(v), causal=True,
                                        block_q=8, block_k=8,
                                        interpret=True))

    check_grads(lambda q, k, v: tflash.flash_attention_hmajor(
        q, k, v, causal=True), ref, arrays, cot)
    # and the reference's heads-major kernel gives the same forward
    out = tflash.flash_attention_hmajor(
        *[torch.from_numpy(a) for a in arrays], causal=True)
    close(out, jflash_hmajor(*[jnp.asarray(a) for a in arrays], causal=True,
                             block_q=8, block_k=8, interpret=True))


@pytest.mark.parametrize("shape", [(3, 5, 12, 7), (2, 40, 16, 24)],
                         ids=["C5", "C40"])
def test_grouped_matmul_gradients_match_reference(shape):
    e, c, d, f = shape
    rng = np.random.RandomState(2)
    arrays = [normal(rng, e, c, d), normal(rng, e, d, f)]
    cot = normal(rng, e, c, f)
    check_grads(tgmm.grouped_matmul,
                lambda x, w: jgmm.grouped_matmul(x, w, block=8,
                                                 interpret=True),
                arrays, cot)


def wkv6_arrays(rng, b, t, h, d):
    r, k, v = (normal(rng, b, t, h, d) for _ in range(3))
    w = rng.uniform(0.4, 0.99, (b, t, h, d)).astype(np.float32)
    u = normal(rng, h, d)
    return [r, k, v, w, u]


def test_wkv6_gradients_match_reference():
    rng = np.random.RandomState(3)
    arrays = wkv6_arrays(rng, 1, 20, 2, 8)
    cot = normal(rng, 1, 20, 2, 8)
    check_grads(twkv6.wkv6,
                lambda *a: jwkv6.wkv6(*a, chunk=8, interpret=True),
                arrays, cot)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-head"])
def test_ssd_gradients_match_reference(shared):
    """b and c shared over heads arrive as an expanded view (stride 0), as
    the mamba block passes them; their gradient sums over the heads."""
    rng = np.random.RandomState(4)
    b, t, h, p, n = 1, 20, 2, 8, 8
    x = normal(rng, b, t, h, p)
    a = rng.uniform(0.5, 0.99, (b, t, h)).astype(np.float32)
    hh = 1 if shared else h
    bm, cm = normal(rng, b, t, hh, n), normal(rng, b, t, hh, n)
    cot = normal(rng, b, t, h, p)

    def port(x_, a_, b_, c_):
        return tssd.ssd(x_, a_, b_.expand(b, t, h, n), c_.expand(b, t, h, n))

    def ref(x_, a_, b_, c_):
        return jssd.ssd(x_, a_, jnp.broadcast_to(b_, (b, t, h, n)),
                        jnp.broadcast_to(c_, (b, t, h, n)), chunk=8,
                        interpret=True)

    check_grads(port, ref, [x, a, bm, cm], cot)


def _entry_cases(rng):
    """(entry, plain, inputs) for each kernel entry."""
    b, s, h, kh, d = 1, 12, 4, 2, 8
    flash = [torch.from_numpy(normal(rng, b, s, n, d)) for n in (h, kh, kh)]
    gmm = [torch.from_numpy(normal(rng, 2, 6, 8)),
           torch.from_numpy(normal(rng, 2, 8, 5))]
    wkv = [torch.from_numpy(a) for a in wkv6_arrays(rng, 1, 9, 2, 8)]
    ssd = [torch.from_numpy(normal(rng, 1, 9, 2, 8)),
           torch.from_numpy(rng.uniform(0.5, 0.99, (1, 9, 2))
                            .astype(np.float32)),
           torch.from_numpy(normal(rng, 1, 9, 2, 8)),
           torch.from_numpy(normal(rng, 1, 9, 2, 8))]
    return {
        "flash_attention": (tflash.flash_attention,
                            tflash.flash_attention_plain, flash),
        "flash_attention_hmajor": (
            tflash.flash_attention_hmajor,
            lambda q, k, v: tflash.flash_attention_plain(
                q.transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2)).transpose(1, 2),
            [x.transpose(1, 2).contiguous() for x in flash]),
        "grouped_matmul": (tgmm.grouped_matmul, tgmm.gmm_reference, gmm),
        "wkv6": (twkv6.wkv6, lambda *a: twkv6.wkv6_reference(*a)[0], wkv),
        "ssd": (tssd.ssd, lambda *a: tssd.ssd_reference(*a)[0], ssd),
    }


ENTRIES = list(_entry_cases(np.random.RandomState(0)))


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_skips_the_function_without_a_gradient(name, monkeypatch):
    """No input that requires grad, or grad mode off: the entry calls its
    forward directly (``PlainVJP.apply`` is never reached) and builds no
    autograd node, so the serving prefill and decode launch as before."""
    entry, plain, inputs = _entry_cases(np.random.RandomState(5))[name]

    def refuse(*a, **k):
        raise AssertionError("PlainVJP used without a gradient")

    monkeypatch.setattr(tautograd.PlainVJP, "apply", refuse)
    out = entry(*inputs)
    assert out.grad_fn is None
    torch.testing.assert_close(out, plain(*inputs), rtol=0, atol=0)
    with torch.no_grad():
        out = entry(*[x.clone().requires_grad_() for x in inputs])
    assert out.grad_fn is None


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_gradient_is_the_plain_versions(name):
    """With a gradient the entry goes through ``PlainVJP``: its output and
    its gradients equal the plain version's under autograd, bitwise, on
    the CPU (where the forward is the plain version too)."""
    entry, plain, inputs = _entry_cases(np.random.RandomState(6))[name]
    xs = [x.clone().requires_grad_() for x in inputs]
    ys = [x.clone().requires_grad_() for x in inputs]
    out, want = entry(*xs), plain(*ys)
    assert type(out.grad_fn).__name__ == "PlainVJPBackward"
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    (out * cot).sum().backward()
    (want * cot).sum().backward()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=0)


def test_backward_gradients_keep_the_inputs_dtypes():
    """bfloat16 q, k, v get bfloat16 gradients; wkv6's float32 ``u``
    beside bfloat16 r, k, v, w gets a float32 one."""
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(normal(rng, 1, 8, 2, 8)).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    tflash.flash_attention(q, k, v).float().sum().backward()
    assert {x.grad.dtype for x in (q, k, v)} == {torch.bfloat16}
    arrays = wkv6_arrays(rng, 1, 6, 2, 8)
    r, kk, vv, w = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                    for a in arrays[:4])
    u = torch.from_numpy(arrays[4]).requires_grad_()
    twkv6.wkv6(r, kk, vv, w, u).float().sum().backward()
    assert r.grad.dtype == torch.bfloat16 and u.grad.dtype == torch.float32
