"""The tri-store's remaining operators on the port against the reference:
the non-unique bounded join, the triangle count, the stores' appends and
ADIL's map / filter / reduce.

Every case runs the same numpy inputs through the reference package (its
Pallas paths in interpret mode) and the port on the CPU, and where there
is one through the NumPy oracle of ``repro.stores.ref``.  Join indices,
counts, validity and ``overflow`` exact (every slot, placeholders
included); float results ``rtol=1e-5, atol=1e-6``; plan ids equal under
one ``HardwareSpec``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import ir as jir  # noqa: E402
from repro.core.adil import Analysis as JAnalysis  # noqa: E402
from repro.core.executor import ExecContext as JExecContext  # noqa: E402
from repro.core.executor import run_plan_subset as jrun_subset  # noqa: E402
from repro.core.plan_cache import PlanCache as JPlanCache  # noqa: E402
from repro.core.rewrite import DEFAULT_PIPELINE  # noqa: E402
from repro.stores import ColumnStore as JColumnStore  # noqa: E402
from repro.stores import GraphStore as JGraphStore  # noqa: E402
from repro.stores import TextStore as JTextStore  # noqa: E402
from repro.stores import column_store as jcol  # noqa: E402
from repro.stores import graph_store as jgraph  # noqa: E402
from repro.stores import ref  # noqa: E402
from repro.stores import store_engines as jengines  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core.adil import Analysis as TAnalysis  # noqa: E402
from repro_torch.core.executor import ExecContext, run_plan_subset  # noqa
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.stores import (BoundedRel, ColumnStore,  # noqa: E402
                                GraphStore, TextStore)
from repro_torch.stores import column_store as tcol  # noqa: E402
from repro_torch.stores import graph_store as tgraph  # noqa: E402
from repro_torch.stores.runtime import _i_bounded_join  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
HW = dict(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
          hbm_bytes=80e9, vmem_bytes=232_448)
NOFUSE_PIPELINE = tuple(p for p in DEFAULT_PIPELINE if p != "fuse_store_ops")
CPU = torch.device("cpu")


def _jsys():
    return jir.SystemCatalog(hardware=jir.HardwareSpec(**HW))


def _tsys():
    return tir.SystemCatalog(hardware=tir.HardwareSpec(**HW))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# hash_join_nonunique
# --------------------------------------------------------------------------


def _joins(lkeys, lmask, rkeys, rmask, cap):
    """The port's and the reference's join on the same numpy inputs, as
    numpy tuples ``(lidx, ridx, valid, count, overflow)``."""
    got = tcol.hash_join_nonunique(_t(lkeys), _t(lmask), _t(rkeys),
                                   _t(rmask), cap)
    want = jcol.hash_join_nonunique(jnp.asarray(lkeys), jnp.asarray(lmask),
                                    jnp.asarray(rkeys), jnp.asarray(rmask),
                                    cap)
    assert [g.dtype for g in got[:3]] == [torch.int32, torch.int32,
                                         torch.bool]
    assert got[3].dtype == torch.int32 and got[3].shape == ()
    assert got[4].dtype == torch.bool and got[4].shape == ()
    return (tuple(g.numpy() for g in got),
            tuple(np.asarray(w) for w in want))


def _same_join(got, want):
    for name, g, w in zip(("lidx", "ridx", "valid", "count", "overflow"),
                          got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _matches_oracle(got, lkeys, lmask, rkeys, rmask, cap):
    lidx, ridx, valid, count, overflow = ref.bounded_join_ref(
        lkeys, lmask, rkeys, rmask, cap)
    assert int(got[3]) == count and bool(got[4]) == overflow
    np.testing.assert_array_equal(got[2], valid)
    np.testing.assert_array_equal(got[0][valid], lidx[valid])
    np.testing.assert_array_equal(got[1][valid], ridx[valid])


JOIN_CASES = {
    # name: (nl, nr, key range, left valid share, right valid share, cap)
    "random": (300, 200, 60, 0.8, 0.7, 2048),
    "random, capacity overflows": (300, 200, 20, 1.0, 1.0, 500),
    "probe side empty": (0, 200, 60, 1.0, 1.0, 64),
    "build side empty": (300, 0, 60, 1.0, 1.0, 64),
    "every build row invalid": (100, 80, 10, 1.0, 0.0, 256),
    "every probe row invalid": (100, 80, 10, 0.0, 1.0, 256),
    "capacity 1": (40, 30, 5, 1.0, 1.0, 1),
}


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_hash_join_nonunique_matches_reference_and_oracle(case, rng):
    nl, nr, kr, lshare, rshare, cap = JOIN_CASES[case]
    lkeys = rng.randint(0, kr, nl).astype(np.int32)
    rkeys = rng.randint(0, kr, nr).astype(np.int32)
    lmask = rng.rand(nl) < lshare
    rmask = rng.rand(nr) < rshare
    got, want = _joins(lkeys, lmask, rkeys, rmask, cap)
    _same_join(got, want)
    _matches_oracle(got, lkeys, lmask, rkeys, rmask, cap)
    if nl == 0 or nr == 0 or lshare == 0.0 or rshare == 0.0:
        assert int(got[3]) == 0 and not got[2].any() and not got[4]


def test_invalid_build_rows_among_equal_keys_are_skipped(rng):
    """Runs of equal build keys whose validity alternates: each probe row
    emits exactly the valid rows of its run, in the stable sorted order."""
    rkeys = np.repeat(np.arange(6, dtype=np.int32), 7)
    rkeys = rkeys[rng.permutation(rkeys.size)]
    rmask = rng.rand(rkeys.size) < 0.5
    lkeys = rng.randint(-1, 8, 50).astype(np.int32)      # -1 and 6-7: none
    lmask = np.ones(50, bool)
    got, want = _joins(lkeys, lmask, rkeys, rmask, 400)
    _same_join(got, want)
    _matches_oracle(got, lkeys, lmask, rkeys, rmask, 400)
    valid = got[2]
    assert rmask[got[1][valid]].all()
    np.testing.assert_array_equal(rkeys[got[1][valid]],
                                  lkeys[got[0][valid]])


def test_skewed_cross_join_past_2_24():
    """5,000 x 5,000 equal keys: 25M true matches (past 2^24) into 1,000
    slots, all owned by probe row 0 in build order."""
    keys = np.full(5000, 7, np.int32)
    ones = np.ones(5000, bool)
    got, want = _joins(keys, ones, keys, ones, 1000)
    _same_join(got, want)
    assert int(got[3]) == 1000 and bool(got[4])
    np.testing.assert_array_equal(got[0], np.zeros(1000, np.int32))
    np.testing.assert_array_equal(got[1], np.arange(1000, dtype=np.int32))


def test_int64_ends_match_reference_where_float32_prefixes_round():
    """The port sums the clamped per-probe counts in int64, the reference
    in float32.  Here 20,000 probe rows each match 2,001 build rows,
    clamped to capacity + 1 = 1,025, so the ends reach 20.5M, past 2^24,
    where float32 prefixes round.  The emitted slots, all in probe row 0's
    range, still agree with the reference's and with the closed form."""
    lkeys = np.full(20_000, 3, np.int32)
    rkeys = np.concatenate([np.full(2001, 3, np.int32),
                            np.arange(4, 100, dtype=np.int32)])
    cap = 1024
    got, want = _joins(lkeys, np.ones(20_000, bool), rkeys,
                       np.ones(rkeys.size, bool), cap)
    _same_join(got, want)
    assert int(got[3]) == cap and bool(got[4])
    np.testing.assert_array_equal(got[0], np.zeros(cap, np.int32))
    np.testing.assert_array_equal(got[1], np.arange(cap, dtype=np.int32))


def test_capacity_guard_raises_as_the_reference():
    k = np.zeros(4, np.int32)
    m = np.ones(4, bool)
    with pytest.raises(jir.ValidationError) as jerr:
        jcol.hash_join_nonunique(jnp.asarray(k), jnp.asarray(m),
                                 jnp.asarray(k), jnp.asarray(m), 1 << 23)
    with pytest.raises(tir.ValidationError) as terr:
        tcol.hash_join_nonunique(_t(k), _t(m), _t(k), _t(m), 1 << 23)
    assert str(terr.value) == str(jerr.value)
    # one below the guard is admitted
    out = tcol.hash_join_nonunique(_t(k), _t(m), _t(k), _t(m), 16)
    assert int(out[3]) == 16 and not bool(out[4])


def test_partitioned_bounded_join_without_mesh_runs_dense():
    """A ``partitioned`` node off a mesh runs the dense bounded join, as the
    reference's does: every slot of the reference's ``bounded_join``."""
    rng = np.random.RandomState(11)
    lk, rk = (rng.randint(0, 6, n).astype(np.int32) for n in (40, 24))
    lm, rm = rng.rand(40) > 0.2, rng.rand(24) > 0.2
    node = type("N", (), {"attrs": {"left_on": "k", "right_on": "k",
                                    "capacity": 96, "bucket_cap": 16,
                                    "dist": "partitioned"}})()
    left = BoundedRel({"k": _t(lk), "i": _t(np.arange(40, dtype=np.int32))},
                      _t(lm))
    right = BoundedRel({"k": _t(rk), "w": _t(rng.rand(24).astype(
        np.float32))}, _t(rm))
    got = _i_bounded_join(ExecContext(root={}, scope={}, device=CPU),
                          [left, right], node)
    lidx, ridx, valid, count, ovf = jcol.hash_join_nonunique(
        jnp.asarray(lk), jnp.asarray(lm), jnp.asarray(rk), jnp.asarray(rm),
        96)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(got.cols["i"].numpy(), np.asarray(lidx))
    np.testing.assert_array_equal(got.cols["k"].numpy(), lk[np.asarray(lidx)])
    np.testing.assert_array_equal(
        got.cols["w"].numpy(), right.cols["w"].numpy()[np.asarray(ridx)])
    assert int(got.count) == int(count) > 0
    assert bool(got.overflow) == bool(ovf) is False


# --------------------------------------------------------------------------
# bounded_join through the planner, standalone and fused
# --------------------------------------------------------------------------


def _join_tables(rng):
    n, m = 600, 160
    tcols = {"user": rng.randint(0, 50, n).astype(np.int32),
             "tag": rng.randint(0, 12, n).astype(np.int32),
             "eng": rng.gamma(2.0, 12.0, n).astype(np.float32)}
    icols = {"user": rng.randint(0, 50, m).astype(np.int32),
             "influence": rng.rand(m).astype(np.float32)}
    return tcols, icols


def _join_analysis(pkg, tcols, icols, store_rel):
    A, C = (JAnalysis, JColumnStore) if pkg == "ref" else (TAnalysis,
                                                           ColumnStore)
    cat = (jir if pkg == "ref" else tir).standard_catalog()
    table, infl = C(tcols), C(icols)
    with A("bj", cat) as a:
        t = a.op("rel_scan", a.bind("t", table))
        hot = a.op("rel_filter", t, col="eng", cmp="ge", value=20.0)
        j = a.op("bounded_join", hot, a.bind("i", infl), left_on="user",
                 right_on="user", capacity=1024)
        if store_rel:
            a.store(j)
        else:
            a.store(a.op("col_tensor", a.op(
                "rel_group_agg", j, key="tag", num_groups=12,
                aggs=(("infl", "sum", "influence"),)), col="infl",
                dim="nodes"))
    return a, table, infl


def _same_value(got, want, where):
    if isinstance(got, BoundedRel):
        valid = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), valid, err_msg=where)
        assert int(got.count) == int(want.count), where
        assert bool(got.overflow) == bool(want.overflow), where
        assert set(got.cols) == set(want.cols), where
        for k, v in got.cols.items():
            g, w = v.numpy()[valid], np.asarray(want.cols[k])[valid]
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{where}.{k}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{where}.{k}")
    elif isinstance(got, torch.Tensor):
        w = np.asarray(want)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(got.numpy(), w, err_msg=where)
    elif isinstance(got, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_value(g, w, f"{where}[{i}]")


def _both_envs(jfn, tfn, jins, tins):
    jenv = jrun_subset(jfn.concrete, JExecContext(root={}, scope={}), jins,
                       [n.id for n in jfn.concrete.topo()])
    tenv = run_plan_subset(tfn.concrete,
                           ExecContext(root={}, scope={}, device=CPU), tins,
                           [n.id for n in tfn.concrete.topo()])
    for n in tfn.concrete.topo():
        _same_value(tenv[n.id], jenv[n.id], f"{n.id}:{n.impl}")
    return jenv, tenv


@pytest.mark.parametrize("pipeline", ["default", "unfused"])
@pytest.mark.parametrize("store_rel", [True, False],
                         ids=["relation", "group-agg"])
def test_bounded_join_planned_matches_reference(rng, pipeline, store_rel):
    tcols, icols = _join_tables(rng)
    pipe = DEFAULT_PIPELINE if pipeline == "default" else NOFUSE_PIPELINE
    ja, jt, ji = _join_analysis("ref", tcols, icols, store_rel)
    ta, tt, ti = _join_analysis("port", tcols, icols, store_rel)
    jfn = ja.compile(_jsys(), engines=jengines(pallas=True), cache=False,
                     rewrite_pipeline=pipe)
    tfn = repro_torch.compile(ta, _tsys(), device="cpu", cache=False,
                              rewrite_pipeline=pipe)
    assert tfn.plan_id == jfn.plan_id
    impls = tfn.chosen_impls()
    assert impls == [n.impl for n in jfn.concrete.topo()]
    chains = [[s[0] for s in n.attrs["chain"]] for n in tfn.concrete.topo()
              if n.impl.startswith("rel_fused")]
    if pipeline == "unfused":
        assert "bounded_join_col" in impls and not chains
    else:
        assert "bounded_join_col" not in impls
        assert any("bounded_join" in c for c in chains)
    jins = {"t": jt.payload(), "i": ji.payload()}
    tins = {"t": tt.payload("cpu"), "i": ti.payload("cpu")}
    jenv, tenv = _both_envs(jfn, tfn, jins, tins)
    out = tenv[tfn.concrete.outputs[0]]
    if store_rel:
        assert int(out.count) > 0 and not bool(out.overflow)


# --------------------------------------------------------------------------
# triangle count
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,edges", [(40, 120), (97, 600), (8, 0)])
def test_triangle_count_matches_reference_and_oracle(n, edges, rng):
    e = rng.randint(0, n, (2, edges))
    jg = JGraphStore.from_edges(e[0], e[1], n, symmetric=True)
    tg = GraphStore.from_edges(e[0], e[1], n, symmetric=True)
    want = float(jgraph.triangle_count(jg.payload()))
    got = tgraph.triangle_count(tg.payload("cpu"))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == want
    # the oracle's Σ(A ∘ A²) is an integer (self-loops make it no multiple
    # of 6); both packages divide it by 6 once in float32
    s = round(6 * ref.triangle_count_ref(tg.src, tg.indices, n))
    assert float(got) == float(np.float32(s) / np.float32(6.0))
    # through the planner: graph_tricount -> graph_tricount_csr
    with JAnalysis("tri", jir.standard_catalog()) as ja:
        ja.store(ja.op("graph_tricount", ja.bind("g", jg)))
    with TAnalysis("tri", tir.standard_catalog()) as ta:
        ta.store(ta.op("graph_tricount", ta.bind("g", tg)))
    jfn = ja.compile(_jsys(), engines=jengines(pallas=True), cache=False)
    tfn = repro_torch.compile(ta, _tsys(), device="cpu", cache=False)
    assert tfn.plan_id == jfn.plan_id
    assert "graph_tricount_csr" in tfn.chosen_impls()
    assert float(tfn({}, {"g": tg.payload("cpu")})) == float(
        jfn({}, {"g": jg.payload()}))


# --------------------------------------------------------------------------
# appends
# --------------------------------------------------------------------------


def test_column_store_append_within_and_beyond_capacity():
    st = ColumnStore({"x": np.arange(60, dtype=np.int32),
                      "y": np.arange(60, dtype=np.float64)}, capacity=128)
    js = JColumnStore({"x": np.arange(60, dtype=np.int32),
                       "y": np.arange(60, dtype=np.float64)}, capacity=128)
    for n in (20, 100):                       # within, then beyond
        new = {"x": np.arange(n, dtype=np.int64),
               "y": np.linspace(0, 1, n)}
        st.append(new)
        js.append(new)
        assert (st.rows, st.capacity, st.version) == (js.rows, js.capacity,
                                                      js.version)
        assert repr(st.type) == repr(js.type)
        rel, jrel = st.payload("cpu"), js.payload()
        assert rel.capacity == jrel.capacity
        assert int(rel.count) == int(jrel.count)
        for k in ("x", "y"):
            np.testing.assert_array_equal(rel.cols[k].numpy(),
                                          np.asarray(jrel.cols[k]))
            np.testing.assert_array_equal(st.column(k), js.column(k))
    assert (st.rows, st.capacity, st.version) == (180, 180, 2)


@pytest.mark.parametrize("bad", ["schema", "ragged", "dtype", "wrap"])
def test_column_store_append_errors_as_the_reference(bad):
    """The reference's checks and messages; a refused append leaves the
    port's store as it was (the reference concatenates the columns before
    a mismatched dtype, ROADMAP §3 "Differences by design")."""
    cols = {"x": np.arange(8, dtype=np.int32),
            "y": np.arange(8, dtype=np.float32)}
    new = {"schema": {"x": np.arange(3, dtype=np.int32)},
           "ragged": {"x": np.arange(3, dtype=np.int32),
                      "y": np.arange(4, dtype=np.float32)},
           "dtype": {"x": np.arange(3, dtype=np.int32),
                     "y": np.arange(3, dtype=np.int32)},
           "wrap": {"x": np.array([1 << 40, 0, 1]),
                    "y": np.arange(3, dtype=np.float32)}}[bad]
    st, js = ColumnStore(dict(cols)), JColumnStore(dict(cols))
    with pytest.raises(jir.ValidationError) as jerr:
        js.append(new)
    with pytest.raises(tir.ValidationError) as terr:
        st.append(new)
    assert str(terr.value) == str(jerr.value)
    # a refused append changes nothing
    assert (st.rows, st.version) == (8, 0)
    np.testing.assert_array_equal(st.column("x"), cols["x"])


def test_append_bumps_version_and_invalidates_cache(rng):
    """As the reference's test: a version bump re-plans (a cache miss with
    a new plan id) and the recompiled plan sees the appended rows; both
    packages' plan ids stay equal through the append."""
    x0 = rng.randint(0, 4, 60).astype(np.int32)
    x1 = rng.randint(0, 4, 30).astype(np.int32)
    stores = {"ref": JColumnStore({"x": x0}, capacity=128),
              "port": ColumnStore({"x": x0}, capacity=128)}
    caches = {"ref": JPlanCache(), "port": PlanCache()}

    def build(pkg):
        A, m = (JAnalysis, jir) if pkg == "ref" else (TAnalysis, tir)
        with A("inc", m.standard_catalog()) as a:
            tw = a.bind("t", stores[pkg])
            f = a.op("rel_filter", a.op("rel_scan", tw), col="x", cmp="ge",
                     value=1)
            a.store(a.op("rel_group_agg", f, key="x", num_groups=4,
                         aggs=(("n", "count", None),)))
        return a

    def compile_(pkg):
        if pkg == "ref":
            return build(pkg).compile(_jsys(), engines=jengines(pallas=True),
                                      cache=caches[pkg])
        return repro_torch.compile(build(pkg), _tsys(), device="cpu",
                                   cache=caches[pkg])

    fn1 = {p: compile_(p) for p in stores}
    fn1b = {p: compile_(p) for p in stores}
    for p in stores:
        stores[p].append({"x": x1})
        assert stores[p].version == 1
    fn2 = {p: compile_(p) for p in stores}
    for p in stores:
        assert fn1b[p].plan_id == fn1[p].plan_id
        assert fn2[p].plan_id != fn1[p].plan_id
        assert caches[p].hits == 1
    assert fn1["port"].plan_id == fn1["ref"].plan_id
    assert fn2["port"].plan_id == fn2["ref"].plan_id
    assert compile_("port").plan_id == fn2["port"].plan_id
    assert caches["port"].hits == 2
    out = fn2["port"]({}, {"t": stores["port"].payload("cpu")})
    assert float(out.cols["n"].sum()) == float(
        (stores["port"].column("x") >= 1).sum())


def test_text_store_append_equals_fresh_index(rng):
    vocab = 16
    docs1 = [rng.randint(0, vocab, rng.randint(0, 6)) for _ in range(10)]
    docs2 = [rng.randint(0, vocab, rng.randint(0, 6)) for _ in range(7)]
    docs3 = [rng.randint(0, vocab, rng.randint(1, 6)) for _ in range(5)]
    inc = TextStore.from_docs(docs1, vocab)
    inc.append(docs2)
    inc.append(docs3)
    jinc = JTextStore.from_docs(docs1, vocab)
    jinc.append(docs2)
    jinc.append(docs3)
    every = docs1 + docs2 + docs3
    full = TextStore.from_flat(np.concatenate(every),
                               np.array([d.size for d in every]), vocab)
    assert inc.version == 2 == jinc.version
    assert inc.n_docs == full.n_docs == jinc.n_docs
    assert inc.n_postings == full.n_postings == jinc.n_postings
    assert inc.type == full.type
    for name in ("doc_ids", "term_ids", "tf", "doc_len", "idf"):
        np.testing.assert_array_equal(getattr(inc, name),
                                      getattr(full, name), err_msg=name)
        np.testing.assert_array_equal(getattr(inc, name),
                                      getattr(jinc, name), err_msg=name)
    # the payload the next plan reads carries the appended documents
    got, want = inc.payload("cpu"), full.payload("cpu")
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    with pytest.raises(tir.ValidationError, match="doc 23: term id"):
        inc.append([[1, 2], [vocab]])
    assert inc.version == 2 and inc.n_docs == 22


# --------------------------------------------------------------------------
# ADIL's map / filter / reduce
# --------------------------------------------------------------------------

KEEP = (lambda v: float(v.max()) > 1.5)          # noqa: E731
FOLD = (lambda acc, v: acc * 0.5 + v)            # noqa: E731


def _collection_analysis(pkg, length, size, fold):
    A, m = (JAnalysis, jir) if pkg == "ref" else (TAnalysis, tir)
    vec = m.TensorT((length,), "float32", ("vocab",))
    with A("collections", m.standard_catalog()) as a:
        xs = a.input("xs", m.ListT(vec, size))
        body = m.Plan("body")
        body.add_input("x", vec)
        body.set_outputs(body.add("ffn_act", ["x"], {"act": "relu2"}))
        kept = a.filter(a.map(xs, body), KEEP)
        a.store(a.reduce(kept, fold))
    return a


@pytest.mark.parametrize("fold", [FOLD, "sum"], ids=["callable", "add"])
def test_map_filter_reduce_match_reference(rng, fold):
    n, length = 8, 64
    scales = np.linspace(0.1, 1.0, n)
    vals = [(rng.randn(length) * s).astype(np.float32) for s in scales]
    ja = _collection_analysis("ref", length, n, fold)
    ta = _collection_analysis("port", length, n, fold)
    jfn = ja.compile(_jsys(), engines=jengines(pallas=True), cache=False)
    tfn = repro_torch.compile(ta, _tsys(), device="cpu", cache=False)
    assert tfn.plan_id == jfn.plan_id
    assert tfn.chosen_impls() == ["map", "filter", "reduce", "store"]
    jins = {"xs": [jnp.asarray(v) for v in vals]}
    tins = {"xs": [torch.from_numpy(v) for v in vals]}
    _both_envs(jfn, tfn, jins, tins)
    got = tfn({}, tins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn({}, jins)))
    # the plain computation: relu^2, keep by max, fold in order
    kept = [np.square(np.maximum(v, 0)) for v in vals]
    kept = [v for v in kept if float(v.max()) > 1.5]
    assert 0 < len(kept) < n
    acc = kept[0]
    for v in kept[1:]:
        acc = acc * np.float32(0.5) + v if callable(fold) else acc + v
    np.testing.assert_array_equal(got.numpy(), acc)
