"""backend.launches_per_op: the program's launch counter
(``repro_torch.kernels.native.LAUNCHES``) over the window, per op."""


def read(run):
    if run.launches is None or not run.ops:
        return None
    return sum(run.launches.values()) / run.ops
