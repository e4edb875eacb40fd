"""sim_plan_roofline: the frozen bound of the range-plan launches recorded
while the profiler ran (yardstick/bounds.py over each launch's real pages
and its passes) over their device time in the trace, as a mean per launch,
in percent."""
from simbench.roofline import KernelSpec, share, words
from simbench.yardstick import bounds


def _bound(rec):
    pages, flags = rec
    f = words(flags)
    return bounds.plan_bound(f[(f != 0).any(axis=1)], pages)


KERNEL = KernelSpec(
    name="sim_plan", module="repro_torch.kernels.sim_plan.ops",
    wrapper="sim_plan", trace_name="plan_kernel", submit="submit_plan",
    # a launch's real rows are the distinct pages its plans were queued on
    row_key=lambda args: getattr(args[0], "page_addr", None) if args
    else None,
    record=lambda rows, args, kw, out: (
        rows, args[4] if len(args) > 4 else kw["flags"]),
    bound=_bound)


def read(run):
    return share(run, KERNEL.name)
