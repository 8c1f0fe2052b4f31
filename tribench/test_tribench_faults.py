"""Whole runs of the harness on the CPU at a tiny size, past its look for a
chip: every cell comes out correct as it stands, and with the timed path
broken underneath, ``correct`` comes out false.

The faults a cell of this benchmark can have: a step that returns its
state unchanged (an analysis answered with the previous answer); half of
a batch left out (the batched light queries' second half answered with
the first half's results); an answer altered where it is produced (a
PageRank vector, a text score).  There is no exchange between chips: every
cell takes one."""
import pytest
import torch

from tribench.testkit import SEED, run_cell, tiny_root

torch.set_num_threads(2)
CELLS = ["pulse_10m.solo", "pulse_10m.team16"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    rc, res, err = run_cell(root, cell)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "compared"
    assert all(c["value"] <= c["limit"] for c in res["compared"].values())
    assert "correct True" in err.strip().splitlines()[-1]


def test_stale_answer_fails(root, monkeypatch):
    from repro_torch.serving.runtime import AsyncServingRuntime
    real, last = AsyncServingRuntime.run_analysis, []

    def stale(self, *a, **kw):
        out = real(self, *a, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    monkeypatch.setattr(AsyncServingRuntime, "run_analysis", stale)
    rc, res, err = run_cell(root, "pulse_10m.solo")
    assert rc == 0 and res["correct"] is False, err


def test_stale_round_fails(root, monkeypatch):
    from repro_torch.serving.runtime import AsyncServingRuntime
    real, last = AsyncServingRuntime.serve_analyses, []

    def stale(self, reqs, **kw):
        res = real(self, reqs, **kw)
        if last:
            for r, old in zip(res, last[-1]):
                r.value = old.value
        last.append(res)
        return res

    monkeypatch.setattr(AsyncServingRuntime, "serve_analyses", stale)
    rc, res, err = run_cell(root, "pulse_10m.team16")
    assert rc == 0 and res["correct"] is False, err


def test_half_batch_left_out_fails(root, monkeypatch):
    from repro_torch.serving.runtime import AsyncServingRuntime
    real = AsyncServingRuntime._run_batched_group

    def half(self, leaders):
        keep = leaders[:max(len(leaders) // 2, 1)]
        vals = real(self, keep)
        return [vals[i % len(vals)] for i in range(len(leaders))]

    monkeypatch.setattr(AsyncServingRuntime, "_run_batched_group", half)
    rc, res, err = run_cell(root, "pulse_10m.team16")
    assert rc == 0 and res["correct"] is False, err


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("where", ["pagerank", "tfidf_topk"])
def test_altered_answer_fails(root, monkeypatch, where, cell):
    """PageRank off by 1e-4 of itself; the 64th hit's score lost."""
    import repro_torch.stores.runtime as engines
    real = getattr(engines, where)

    def altered(*a, **kw):
        out = real(*a, **kw)
        if where == "pagerank":
            return out * (1 + 1e-4)
        ids, scores, valid = out
        return ids, torch.cat([scores[:-1], scores[-1:] * 0]), valid

    monkeypatch.setattr(engines, where, altered)
    rc, res, err = run_cell(root, cell, seed=SEED + 5)
    assert rc == 0 and res["correct"] is False, err
