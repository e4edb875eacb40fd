"""sim_lookup_roofline: the frozen bound of the fused lookup launches
recorded while the profiler ran (yardstick/bounds.py over each launch's
real lookups, not its padded rows) over their device time in the trace, as
a mean per launch, in percent."""
from simbench.roofline import KernelSpec, share, words
from simbench.yardstick import bounds

KERNEL = KernelSpec(
    name="sim_lookup", module="repro_torch.kernels.sim_fused.ops",
    wrapper="sim_fused_lookup", trace_name="lookup_kernel",
    submit="submit_lookup",
    # the flush's real lookups, each row's first slot, whether in place
    record=lambda rows, args, kw, out: (rows, out[2],
                                        kw.get("key_rows") is not None),
    bound=lambda rec: bounds.lookup_bound(rec[0], words(rec[1])[:rec[0]],
                                          rec[2]))


def read(run):
    return share(run, KERNEL.name)
