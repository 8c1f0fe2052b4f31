"""The tri-store's masked kernels, each beside its plain PyTorch version.

  * :func:`masked_segment_agg` — the fused mask-weighted group-by
    ``(Σ vals·mw, Σ mw)`` per group (``rel_fused_agg_pallas``);
  * :func:`masked_tfidf` — TF-IDF scores of the documents a pushed doc
    mask keeps (``text_topk_masked_pallas``);
  * :func:`join_probe` — equi-join probe against a small unique-key build
    side (``rel_join_probe_pallas``);
  * :func:`compact_prefix` — prefix compaction of stacked 32-bit columns
    (``compact_prefix_pallas``).

On CUDA tensors each wrapper launches its hand-written kernel
``csrc/<name>.cu`` (which replaces the reference function of the same name
in ``stores/masked_kernels.py``; the source note gives the design and the
bound) or raises — it never falls back.  On CPU tensors it runs its
``*_plain`` version, the same function in plain PyTorch.

Convention (the reference's): keys outside ``[0, num_groups)`` — the
padding key ``-1`` — match no group.  A row, document or posting whose mask
is 0 adds nothing: the reference's skip of all-zero mask blocks taken per
row.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# the most build rows the probe kernel takes: join_probe.cu's shared-memory
# table (kMaxBuild there) is sized for it, and the planner's gate on
# ``rel_join_probe_pallas`` (core/physical.py) reads it from here
JOIN_PROBE_MAX_BUILD = 4096


def _plain_or_cuda(name: str, ts) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device (the kernel launches); raises
    otherwise."""
    # plain loops: this runs on every launch, and generator expressions
    # cost more than the comparisons
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            break
    else:
        if dev.type == "cpu":
            return True
        if dev.type == "cuda":
            return False
    raise ValueError(f"{name}: inputs must lie on one CUDA device (or all "
                     f"on the CPU), got {[str(t.device) for t in ts]}")


def _check(name: str, ts, dtypes) -> None:
    """Raise unless each tensor has its dtype and is contiguous."""
    for t, dt in zip(ts, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: needs dtypes "
                            f"{[str(d) for d in dtypes]}, got "
                            f"{[str(t.dtype) for t in ts]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous inputs")


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def masked_segment_agg_plain(vals: torch.Tensor, keys: torch.Tensor,
                             maskw: torch.Tensor, num_groups: int):
    """Plain PyTorch group-by: two ``index_add_`` with the padding mask,
    summed in float64 and rounded to float32, as the kernel sums.  Rows
    with weight 0 or an out-of-range key go to one spill slot past the
    end, cut off after."""
    g = int(num_groups)
    w = maskw.to(torch.float32)
    ok = (w != 0) & (keys >= 0) & (keys < g)
    idx = torch.where(ok, keys, torch.full_like(keys, g))
    acc = torch.zeros(2, g + 1, dtype=torch.float64, device=vals.device)
    acc[0].index_add_(0, idx, (vals.to(torch.float32) * w).to(torch.float64))
    acc[1].index_add_(0, idx, w.to(torch.float64))
    out = acc[:, :g].to(torch.float32)
    return out[0], out[1]


def masked_segment_agg(vals: torch.Tensor, keys: torch.Tensor,
                       maskw: torch.Tensor, num_groups: int):
    """``(sums, counts)`` per group id: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Under ``torch.func.vmap`` (a
    batched query of the serving runtime) the call goes through
    :func:`_segment_agg_op`, whose batching rule runs the kernel once per
    batch row.  An unbatched call skips the op, whose dispatch is a
    measurable share of the call (``chip_smoke.py`` prints it as ``op_ms``
    beside ``ms``; PERF.md §6)."""
    ts = (vals, keys, maskw)
    if _is_batched(ts):
        out = _segment_agg_op(vals, keys, maskw, int(num_groups))
    else:
        out = _segment_agg(vals, keys, maskw, num_groups)
    return out[0], out[1]


def _segment_agg(vals, keys, maskw, num_groups) -> torch.Tensor:
    """The stacked ``(2, num_groups)`` (sums, counts) of one unbatched
    call: the kernel's output, or the plain version's on the CPU."""
    ts = (vals, keys, maskw)
    if _plain_or_cuda("masked_segment_agg", ts):
        return torch.stack(masked_segment_agg_plain(vals, keys, maskw,
                                                    num_groups))
    _check("masked_segment_agg", ts,
           (torch.float32, torch.int32, torch.float32))
    if vals.dim() != 1 or any(t.shape != vals.shape for t in ts):
        raise ValueError("masked_segment_agg: needs 1-D inputs of one "
                         f"length, got {[tuple(t.shape) for t in ts]}")
    g, r = int(num_groups), int(vals.shape[0])
    if r == 0 or g == 0:
        return torch.zeros(2, g, dtype=torch.float32, device=vals.device)
    # float64 scratch (sums, counts), zeroed by the entry and rounded into
    # ``out``; freeing it on return is safe in stream order, as in
    # scatter_add
    acc = torch.empty(2, g, dtype=torch.float64, device=vals.device)
    out = torch.empty(2, g, dtype=torch.float32, device=vals.device)
    fn = build.entry("masked_segment_agg", "masked_segment_agg_f32",
                     *[_P] * 5, _LL, _I, _P)
    build.check(fn(vals.data_ptr(), keys.data_ptr(), maskw.data_ptr(),
                   acc.data_ptr(), out.data_ptr(), r, g,
                   build.stream(out.device)), "masked_segment_agg")
    masked_segment_agg.launches += 1
    return out


masked_segment_agg.launches = 0


def _is_batched(ts) -> bool:
    """True when a tensor is a ``torch.func.vmap`` batched tensor: its
    ``data_ptr()`` names no batch row, so the kernel cannot take it."""
    for t in ts:
        if torch._C._functorch.is_batchedtensor(t):
            return True
    return False


@torch.library.custom_op("repro_torch::masked_segment_agg", mutates_args=())
def _segment_agg_op(vals: torch.Tensor, keys: torch.Tensor,
                    maskw: torch.Tensor, num_groups: int) -> torch.Tensor:
    """:func:`masked_segment_agg` as an operator, so that ``vmap`` can
    reach it through :func:`_segment_agg_vmap`."""
    return _segment_agg(vals, keys, maskw, num_groups)


def _segment_agg_vmap(info, in_dims, vals, keys, maskw, num_groups):
    """The batching rule: one unbatched call (one kernel launch on the
    card) per batch row, its (2, G) outputs stacked on dim 0.  An input
    without a batch dim is shared by every row."""
    rows = []
    for t, d in zip((vals, keys, maskw), in_dims[:3]):
        rows.append([t] * info.batch_size if d is None
                    else list(t.movedim(d, 0)))
    out = torch.stack([_segment_agg_op(v.contiguous(), k.contiguous(),
                                       w.contiguous(), num_groups)
                       for v, k, w in zip(*rows)])
    return out, 0


torch.library.register_vmap(_segment_agg_op, _segment_agg_vmap)


# --------------------------------------------------------------------------
# masked TF-IDF scoring (csrc/masked_tfidf.cu)
# --------------------------------------------------------------------------


def ordered_doc_sum(doc_ptr, docs, term_ids, tf, doc_len, w,
                    max_doc_postings: int) -> torch.Tensor:
    """The TF-IDF score of each document in ``docs``: ``(w[term] * tf) /
    doc_len`` summed over its postings in posting order, one elementwise
    pass per posting rank, in float32 — the kernel's sum and the dense
    ``tfidf_scores``' expression, so every masked realization that scores a
    document with it is bitwise equal to the dense one."""
    acc = torch.zeros(docs.shape[0], dtype=torch.float32,
                      device=doc_len.device)
    if docs.numel() == 0 or term_ids.numel() == 0:
        return acc
    start, end = doc_ptr[docs].long(), doc_ptr[docs + 1].long()
    dl = doc_len[docs]
    last = int(term_ids.shape[0]) - 1
    zero = torch.zeros((), dtype=torch.float32, device=acc.device)
    for j in range(int(max_doc_postings)):
        p = start + j
        pc = torch.clamp(p, max=last)
        c = w[term_ids[pc]] * tf[pc] / dl
        acc = acc + torch.where(p < end, c, zero)
    return acc


def masked_tfidf_plain(doc_ptr, term_ids, tf, doc_len, w, doc_mask,
                       max_doc_postings: int) -> torch.Tensor:
    """Plain PyTorch masked scoring: only the kept documents are scored,
    each with :func:`ordered_doc_sum`.  Masked docs score 0."""
    out = torch.zeros(doc_len.shape[0], dtype=torch.float32,
                      device=doc_len.device)
    docs = torch.nonzero(doc_mask).flatten()
    out[docs] = ordered_doc_sum(doc_ptr, docs, term_ids, tf, doc_len, w,
                                max_doc_postings)
    return out


def masked_tfidf(doc_ptr, term_ids, tf, doc_len, w, doc_mask,
                 max_doc_postings: int) -> torch.Tensor:
    """``score[d] = Σ_{postings p of d} w[term[p]]·tf[p]/doc_len[d]`` for
    the documents ``doc_mask`` keeps, 0 for the others; ``doc_ptr`` is the
    corpus payload's CSR offsets and ``w = query · idf``.  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    ts = (doc_ptr, term_ids, tf, doc_len, w, doc_mask)
    if _plain_or_cuda("masked_tfidf", ts):
        return masked_tfidf_plain(*ts, max_doc_postings)
    _check("masked_tfidf", ts, (torch.int32, torch.int32, torch.float32,
                                torch.float32, torch.float32, torch.bool))
    n = int(doc_len.shape[0])
    if (any(t.dim() != 1 for t in ts) or doc_ptr.shape[0] != n + 1
            or doc_mask.shape[0] != n or tf.shape != term_ids.shape):
        raise ValueError("masked_tfidf: needs 1-D doc_ptr (n+1), doc_len and "
                         "doc_mask (n), term_ids and tf of one length, got "
                         f"{[tuple(t.shape) for t in ts]}")
    out = torch.empty(n, dtype=torch.float32, device=doc_len.device)
    if n == 0:
        return out
    fn = build.entry("masked_tfidf", "masked_tfidf_f32", *[_P] * 7, _I, _P)
    build.check(fn(*(t.data_ptr() for t in ts), out.data_ptr(), n,
                   build.stream(out.device)), "masked_tfidf")
    masked_tfidf.launches += 1
    return out


masked_tfidf.launches = 0


# --------------------------------------------------------------------------
# join probe (csrc/join_probe.cu)
# --------------------------------------------------------------------------


def join_probe_plain(lkeys, rkeys, rvalid):
    """Plain PyTorch probe: stable sort of the valid build keys, then a
    binary search per probe key."""
    idx = torch.zeros(lkeys.shape, dtype=torch.int32, device=lkeys.device)
    matched = torch.zeros(lkeys.shape, dtype=torch.bool, device=lkeys.device)
    rows = torch.nonzero(rvalid).flatten()
    if lkeys.numel() == 0 or rows.numel() == 0:
        return idx, matched
    keys = rkeys[rows]
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    pos = torch.clamp(torch.searchsorted(sk, lkeys), max=sk.shape[0] - 1)
    matched = sk[pos] == lkeys
    idx = torch.where(matched, rows[order[pos]], 0).to(torch.int32)
    return idx, matched


def join_probe(lkeys, rkeys, rvalid):
    """``(idx, matched)``: for each probe key, the row of the valid build
    row with that key (build keys unique among valid rows) and a match
    flag; unmatched rows report index 0.  The CUDA kernel for CUDA tensors
    (build side of at most :data:`JOIN_PROBE_MAX_BUILD` rows), the plain
    version for CPU tensors."""
    ts = (lkeys, rkeys, rvalid)
    if _plain_or_cuda("join_probe", ts):
        return join_probe_plain(*ts)
    _check("join_probe", ts, (torch.int32, torch.int32, torch.bool))
    p, nr = int(lkeys.shape[0]), int(rkeys.shape[0])
    if (lkeys.dim() != 1 or rkeys.dim() != 1 or rvalid.shape != rkeys.shape
            or nr > JOIN_PROBE_MAX_BUILD):
        raise ValueError("join_probe: needs 1-D keys and a build side of at "
                         f"most {JOIN_PROBE_MAX_BUILD} rows, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if p == 0 or nr == 0:
        return (torch.zeros(p, dtype=torch.int32, device=lkeys.device),
                torch.zeros(p, dtype=torch.bool, device=lkeys.device))
    # the kernel writes every probe row's index and flag
    idx = torch.empty(p, dtype=torch.int32, device=lkeys.device)
    matched = torch.empty(p, dtype=torch.bool, device=lkeys.device)
    fn = build.entry("join_probe", "join_probe_i32", *[_P] * 5, _LL, _I, _P)
    build.check(fn(lkeys.data_ptr(), rkeys.data_ptr(), rvalid.data_ptr(),
                   idx.data_ptr(), matched.data_ptr(), p, nr,
                   build.stream(idx.device)), "join_probe")
    join_probe.launches += 1
    return idx, matched


join_probe.launches = 0


# --------------------------------------------------------------------------
# prefix compaction (csrc/compact_prefix.cu)
# --------------------------------------------------------------------------


def compact_prefix_plain(vals, pos, keep, out_capacity: int):
    """Plain PyTorch compaction: the kept rows that fit, copied to their
    slots by index; slots no row lands on stay 0."""
    cap = int(out_capacity)
    out = torch.zeros(vals.shape[0], cap, dtype=vals.dtype,
                      device=vals.device)
    rows = torch.nonzero((keep > 0) & (pos >= 0) & (pos < cap)).flatten()
    out[:, pos[rows].long()] = vals[:, rows]
    return out


def compact_prefix(vals, pos, keep, out_capacity: int) -> torch.Tensor:
    """Prefix compaction of ``C`` stacked value rows: ``out[c, pos[i]] =
    vals[c, i]`` for kept rows (``keep > 0``) whose slot ``pos`` (the
    exclusive valid-prefix sum) is below ``out_capacity``; others drop.
    Values move as 32-bit words, bitwise.  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    ts = (vals, pos, keep)
    if _plain_or_cuda("compact_prefix", ts):
        return compact_prefix_plain(*ts, out_capacity)
    _check("compact_prefix", ts, (torch.float32, torch.int32, torch.float32))
    if (vals.dim() != 2 or pos.dim() != 1 or keep.shape != pos.shape
            or vals.shape[1] != pos.shape[0]):
        raise ValueError("compact_prefix: needs (C, R) vals with (R,) pos and "
                         f"keep, got {[tuple(t.shape) for t in ts]}")
    c, r, cap = int(vals.shape[0]), int(vals.shape[1]), int(out_capacity)
    out = torch.zeros(c, cap, dtype=torch.float32, device=vals.device)
    if r == 0 or cap == 0 or c == 0:
        return out
    fn = build.entry("compact_prefix", "compact_prefix_u32", *[_P] * 4, _I,
                     _LL, _LL, _P)
    build.check(fn(vals.data_ptr(), pos.data_ptr(), keep.data_ptr(),
                   out.data_ptr(), c, r, cap, build.stream(out.device)),
                "compact_prefix")
    compact_prefix.launches += 1
    return out


compact_prefix.launches = 0
