"""The whole ``hashtag_pulse`` analysis: the port against the reference.

At a small size (4,000 tweets, 64 hashtags, vocab 128) the reference runs
with its Pallas kernels in interpret mode, and the port runs on the CPU
(its kernels' plain versions) over the reference's own store payloads,
carried over with ``payload_from_numpy``.  Fused scores agree to
``rtol=1e-5, atol=1e-6``; the top-10 hashtags are equal.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core.adil_parser import parse_adil as jparse  # noqa: E402
from repro.core.ir import SystemCatalog as JSystemCatalog  # noqa: E402
from repro.core.ir import standard_catalog as jcatalog  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.adil_parser import parse_adil as tparse  # noqa: E402
from repro_torch.core.ir import standard_catalog as tcatalog  # noqa: E402
from repro_torch.examples import tri_model_analysis as texample  # noqa
from repro_torch.stores import payload_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIZE = dict(users=300, hashtags=64, tweets=4000, vocab=128)
RTOL, ATOL = 1e-5, 1e-6


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_tri_model_analysis",
        ROOT / "examples" / "tri_model_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def both():
    jex = _reference_example()
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    jstores = jex.build_social_data(jrng, **SIZE)
    tstores = texample.build_social_data(trng, **SIZE)
    jq = jrng.randint(0, SIZE["vocab"], 6)
    tq = trng.randint(0, SIZE["vocab"], 6)
    return jex, jstores, tstores, jq, tq


def test_build_social_data_gives_the_reference_arrays(both):
    _, (jt, jg, jc), (tt, tg, tc), jq, tq = both
    np.testing.assert_array_equal(jq, tq)   # same RandomState call order
    for name in ("user", "hashtag", "doc", "engagement"):
        np.testing.assert_array_equal(tt.column(name), jt.column(name))
    for name in ("indptr", "indices", "src", "weights"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    for name in ("doc_ids", "term_ids", "tf", "doc_len", "idf"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))


def test_hashtag_pulse_matches_reference(both):
    jex, (jt, jg, jc), (tt, tg, tc), jq, _ = both
    script = jex.adil_script(jt, jg, jc)
    assert texample.adil_script(tt, tg, tc) == script
    query = jc.query_vector(jq)

    jfn = jparse(script, jcatalog()).compile(
        JSystemCatalog(), engines=jengines(pallas=True))
    jtable, jgraph, jcorpus = jt.payload(), jg.payload(), jc.payload()
    want = np.asarray(jfn({}, {"tweets": jtable, "g": jgraph, "cx": jcorpus,
                               "q": jnp.asarray(query)}))

    tfn = repro_torch.compile(tparse(script, tcatalog()), device="cpu")
    assert tfn.chosen_impls() == [n.impl for n in jfn.concrete.topo()]
    inputs = {
        "tweets": payload_from_numpy("table", {
            "cols": {k: np.asarray(v) for k, v in jtable.cols.items()},
            "valid": np.asarray(jtable.valid),
            "count": np.asarray(jtable.count)}, "cpu"),
        "g": payload_from_numpy("graph", {k: np.asarray(v)
                                          for k, v in jgraph.items()}, "cpu"),
        "cx": payload_from_numpy("corpus", {k: np.asarray(v) for k, v
                                            in jcorpus.items()}, "cpu"),
        "q": torch.from_numpy(query)}
    got = tfn({}, inputs).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.argsort(-got, kind="stable")[:10],
                                  np.argsort(-want, kind="stable")[:10])
    # the port's own payloads give the same result as the carried ones
    own = tfn({}, texample.inputs_for(tt, tg, tc, query, "cpu")).numpy()
    np.testing.assert_array_equal(own, got)


def test_entry_points_raise_without_a_card(both):
    _, _, (tt, tg, tc), _, _ = both
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    analysis = tparse(texample.adil_script(tt, tg, tc), tcatalog())
    for call in (lambda: repro_torch.compile(analysis),
                 lambda: analysis.compile(repro_torch.SystemCatalog()),
                 tt.payload, tg.payload, tc.payload,
                 lambda: payload_from_numpy("graph", {})):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    fn = repro_torch.compile(analysis, device="cpu")
    fn.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        fn({}, texample.inputs_for(tt, tg, tc, np.zeros(128), "cpu"))


def test_planned_function_refuses_inputs_on_another_device(both):
    _, _, (tt, tg, tc), _, _ = both
    fn = repro_torch.compile(
        tparse(texample.adil_script(tt, tg, tc), tcatalog()), device="cpu")
    inputs = texample.inputs_for(tt, tg, tc, np.zeros(128), "cpu")
    inputs["q"] = torch.zeros(128, device="meta")
    with pytest.raises(ValueError, match="payload"):
        fn({}, inputs)
