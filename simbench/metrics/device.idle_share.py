"""device.idle_share: 1 - the union of device activity (kernels, copies,
fills) over the profiled window's length."""


def read(run):
    prof = run.profile
    if prof is None or prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
