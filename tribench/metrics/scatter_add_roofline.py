"""``scatter_add_roofline``: the SpMV scatter kernel's share of its
roofline in the traced window (device trace).

Time: every ``scatter_runs_kernel`` launch plus the float64 -> float32
rounding pass that directly follows it on its stream
(``round_to_f32_kernel``, a name the group-by's pass shares).  Work: each
launch scatters every mirrored edge of the cell's graph
(:func:`tribench.work.spmv_scatter`), counted from the reference's own
edge list."""
from tribench import work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "analyses_per_s"
KERNELS = ("scatter_runs_kernel",)
FOLLOWERS = ("round_to_f32_kernel",)


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_time(KERNELS, FOLLOWERS)
    if not launches or seconds <= 0:
        return None
    w = work.spmv_scatter(int(run.ref.src.numel()), run.ref.nodes)
    return 100.0 * launches * work.bound_s(w["bytes"], w["flops"]) / seconds
