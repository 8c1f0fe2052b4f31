"""The blocking of the CUDA group-by kernel, mirrored in Python on the CPU
and held against the plain version, the reference Pallas kernel and the
NumPy oracle.

``csrc/masked_segment_agg.cu`` reduces on chip before its global atomics
(its source note gives the design): each CTA takes a contiguous range of
4-row quads (single rows before mw's first 16-byte boundary and after its
last whole quad go to warp 0 of CTA 0); each warp queues its active,
in-range rows and takes them off in rounds of 32; in a round, lanes with
equal keys are summed into the lowest of them; that lane adds its pair to
the CTA's open-addressed table (Fibonacci hash, linear probing bounded at
``probe`` slots) or, when ``probe`` slots hold other keys, to the global
sums; the table is flushed into the global sums at the end.  A CUDA
kernel cannot run here, so the scheme is mirrored step for step, in one
order the card may take (CTAs, then warps, then lanes, in turn), with its
float64 sums rounded once to float32.  The mirror is held against
``masked_segment_agg_plain``, ``masked_segment_agg_pallas(...,
interpret=True)`` and ``ref.masked_segment_agg_ref`` on numpy inputs made
from a seed: zipf-skewed keys, the hot key permuted and at the top id,
more distinct keys a tile than slots (rows spill), G = 1, padding keys,
an all-zero mask, views off the 16-byte boundary and dyadic weights; at
small tables and at the kernel's own constants.  Tolerance: sums
``rtol=1e-5, atol=1e-6`` (float32 against float64 sums in other orders),
counts exact.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# two intra-op threads: the suite runs beside other test workers
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.stores import ref  # noqa: E402
from repro.stores.masked_kernels import masked_segment_agg_pallas  # noqa
from repro_torch.kernels import masked_segment_agg_plain  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
CSRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch" /
        "kernels" / "csrc" / "masked_segment_agg.cu")
# the kernel's constants (test_constants_match_the_kernel reads them back)
KERNEL = {"threads": 512, "log_slots": 12, "probe": 16, "min_quads": 4}
# CTAs of the kernel an H100 holds at once: two an SM (110 KB of shared
# memory and 60 registers a thread each), 132 SMs
RESIDENT = 264
EMPTY = -1


def grid(n_rows, head, resident, threads, min_quads):
    """The launch of ``masked_segment_agg_f32``: ``(ctas, quads, quads a
    CTA)``."""
    n_quads = (n_rows - head) // 4
    per_cta = threads * min_quads
    ctas = min(max(-(-n_quads // per_cta), 1), resident)
    return ctas, n_quads, -(-n_quads // ctas)


def add_rows(lanes, table, gsums, gcounts, log_slots, probe, stats):
    """One round: ``lanes`` holds each lane's ``(key, s, c)`` or None.
    Equal keys are summed into the lowest lane (its own pair first, then
    its peers' in lane order), which adds to its slot or spills."""
    groups = {}
    for row in lanes:
        if row is not None:
            key, s, c = row
            acc = groups.setdefault(key, [0.0, 0.0])
            acc[0] += s
            acc[1] += c
    keys, sums, counts = table
    mask = (1 << log_slots) - 1
    for key, (s, c) in groups.items():
        h = ((key * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - log_slots)
        for p in range(probe):
            slot = (h + p) & mask
            if keys[slot] == EMPTY:
                keys[slot] = key
            if keys[slot] == key:
                sums[slot] += s
                counts[slot] += c
                stats["slotted"].add(key)
                break
        else:
            gsums[key] += s
            gcounts[key] += c
            stats["spills"] += 1
            stats["spilled"].add(key)
    stats["rounds"] += 1


def drain(queue, everything, *args):
    """A warp's queue: whole rounds of 32 off its front; with
    ``everything``, the rest too, as one partial round."""
    while len(queue) >= 32 or (everything and queue):
        lanes = queue[:32] + [None] * (32 - len(queue[:32]))
        del queue[:32]
        add_rows(lanes, *args)


def mirror(vals, keys, mw, num_groups, *, offset=0, resident=RESIDENT,
           threads=512, log_slots=12, probe=16, min_quads=4):
    """The kernel's sums and counts, float32, and its statistics.
    ``offset``: mw's first row's place after a 16-byte boundary (rows);
    ``resident``: the CTAs the card holds at once."""
    r = len(mw)
    mis = offset % 4
    head = min(4 - mis, r) if mis else 0
    ctas, n_quads, per_cta = grid(r, head, resident, threads, min_quads)
    gsums = np.zeros(num_groups, np.float64)
    gcounts = np.zeros(num_groups, np.float64)
    stats = {"ctas": ctas, "spills": 0, "flushed": 0, "both": 0,
             "rounds": 0, "queue": 0}

    def row(i):
        w = float(mw[i])
        if w == 0.0:
            return None
        k = int(keys[i])
        if not 0 <= k < num_groups:
            return None
        return k, float(np.float32(vals[i]) * np.float32(w)), w

    for b in range(ctas):
        table = ([EMPTY] * (1 << log_slots), [0.0] * (1 << log_slots),
                 [0.0] * (1 << log_slots))
        stats.update(slotted=set(), spilled=set())
        args = (table, gsums, gcounts, log_slots, probe, stats)
        queues = [[] for _ in range(threads // 32)]
        if b == 0:
            edge = list(range(head)) + list(range(head + 4 * n_quads, r))
            queues[0] += [e for e in map(row, edge) if e is not None]
        q0, q1 = b * per_cta, min((b + 1) * per_cta, n_quads)
        for base in range(q0, q1, threads):
            for warp, queue in enumerate(queues):
                for j in range(4):
                    for lane in range(32):
                        q = base + 32 * warp + lane
                        e = row(head + 4 * q + j) if q < q1 else None
                        if e is not None:
                            queue.append(e)
                stats["queue"] = max(stats["queue"], len(queue))
                drain(queue, False, *args)
        for queue in queues:
            drain(queue, True, *args)
        for key, s, c in zip(*table):
            if key != EMPTY:
                gsums[key] += s
                gcounts[key] += c
                stats["flushed"] += 1
        stats["both"] += len(stats["slotted"] & stats["spilled"])
    return gsums.astype(np.float32), gcounts.astype(np.float32), stats


def _zipf(rs, r, g):
    return (rs.zipf(1.3, r) % g).astype(np.int32)


def _inputs(case, rs):
    """``(vals, keys, mw, num_groups, offset)`` of one case."""
    r, g = 6000, 512
    vals = rs.randn(r).astype(np.float32)
    mw = (rs.rand(r) < 0.3).astype(np.float32)
    keys = _zipf(rs, r, g)
    offset = 0
    if case == "permuted hot key":
        keys = rs.permutation(g).astype(np.int32)[keys]
    elif case == "hot keys at the top ids":
        keys = (g - 1 - keys).astype(np.int32)
    elif case == "more distinct keys a tile than slots":
        g = 1000
        keys = rs.randint(0, g, r).astype(np.int32)
    elif case == "G 1":
        g = 1
        keys = rs.randint(-1, 2, r).astype(np.int32)
    elif case == "padding keys -1 and >= G":
        bad = rs.rand(r) < 0.3
        keys[bad] = np.where(rs.rand(int(bad.sum())) < 0.5, -1,
                             g + rs.randint(0, 5, int(bad.sum())))
    elif case == "all-zero mask":
        mw[:] = 0.0
    elif case == "view off the boundary, R % 4 == 3":
        r = 5999
        vals, keys, mw, offset = vals[1:], keys[1:], mw[1:], 1
    elif case == "R 3 at row 1":
        vals, keys, mw, offset = vals[1:4], keys[1:4], mw[1:4], 1
    elif case == "dyadic weights":
        mw = np.array([0.0, 0.5, 1.0, 2.0], np.float32)[rs.randint(0, 4, r)]
    return vals[:r], keys[:r], mw[:r], g, offset


# small tables and CTAs, so a few thousand rows take several CTAs and
# fill the tables: 64 threads, 64 slots, 8 probes, a CTA per 1,024 rows
SMALL = {"threads": 64, "log_slots": 6, "probe": 8, "min_quads": 4}
CASES = ["zipf", "permuted hot key", "hot keys at the top ids",
         "more distinct keys a tile than slots", "G 1",
         "padding keys -1 and >= G", "all-zero mask",
         "view off the boundary, R % 4 == 3", "R 3 at row 1",
         "dyadic weights"]


def _check(vals, keys, mw, g, got_s, got_c):
    ps, pc = masked_segment_agg_plain(torch.from_numpy(vals),
                                      torch.from_numpy(keys),
                                      torch.from_numpy(mw), g)
    np.testing.assert_allclose(got_s, ps.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_c, pc.numpy())
    js, jc = masked_segment_agg_pallas(jnp.asarray(vals), jnp.asarray(keys),
                                       jnp.asarray(mw), num_groups=g,
                                       interpret=True)
    np.testing.assert_allclose(got_s, np.asarray(js), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_c, np.asarray(jc))
    ok = (keys >= 0) & (keys < g)
    rs, rc = ref.masked_segment_agg_ref(vals[ok], keys[ok], mw[ok], g)
    np.testing.assert_allclose(got_s, rs, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_c, rc)


@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_plain_pallas_and_ref(case):
    rs = np.random.RandomState(CASES.index(case))
    vals, keys, mw, g, offset = _inputs(case, rs)
    s, c, stats = mirror(vals, keys, mw, g, offset=offset, **SMALL)
    _check(vals, keys, mw, g, s, c)
    assert stats["both"] == 0       # a key has a slot in a CTA, or none
    assert stats["queue"] <= 32 + 4 * 32   # the kernel's kStage
    if len(mw) > 1024:
        assert stats["ctas"] > 1
    if case == "more distinct keys a tile than slots":
        assert stats["spills"] > 0
    if case == "all-zero mask":
        assert stats["flushed"] == 0 and stats["spills"] == 0
        assert stats["rounds"] == 0
        assert not c.any() and not s.any()


def test_mirror_at_the_kernels_constants():
    """20,000 zipf rows at the kernel's own table (4096 slots, 16 probes)
    and CTA (512 threads, a CTA per 8,192 rows): three CTAs, no spill, the
    hot key flushed once a CTA, and about one round of 32 lanes for every
    128 rows at 30 % active rows (one a row of each quad would make four)."""
    rs = np.random.RandomState(7)
    r, g = 20_000, 1024
    vals = rs.randn(r).astype(np.float32)
    keys = _zipf(rs, r, g)
    mw = (rs.rand(r) < 0.3).astype(np.float32)
    s, c, stats = mirror(vals, keys, mw, g, **KERNEL)
    _check(vals, keys, mw, g, s, c)
    assert stats["ctas"] == 3 and stats["spills"] == 0
    assert stats["flushed"] < int((mw != 0).sum())
    # full rounds, plus at most one partial round a warp and CTA
    active = int((mw != 0).sum())
    assert stats["rounds"] <= active // 32 + 3 * KERNEL["threads"] // 32


def test_grid_is_sized_to_the_rows_and_capped():
    """The pushdown plan's call (200,000 rows) launches 25 CTAs, not a
    persistent grid; the path's 10M rows stop at the resident CTAs."""
    t, m = KERNEL["threads"], KERNEL["min_quads"]
    assert grid(200_000, 0, RESIDENT, t, m) == (25, 50_000, 2000)
    assert grid(10_000_000, 0, RESIDENT, t, m) == (264, 2_500_000, 9470)
    assert grid(3, 3, RESIDENT, t, m) == (1, 0, 0)
    assert grid(0, 0, RESIDENT, t, m) == (1, 0, 0)


def test_constants_match_the_kernel():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert {"threads": const("kThreads"), "log_slots": const("kLogSlots"),
            "probe": const("kProbe"),
            "min_quads": const("kMinQuadsPerThread")} == KERNEL
    assert "0x9E3779B1u" in src
    assert re.search(r"constexpr int kStage = 32 \+ 4 \* 32;", src)
