"""The attention backward's least time over the device time of the
kernels that compute it, in percent.

The least time is the configuration's count of it
(``run.flops.attn_bwd_least_seconds``).  The default reference counts it
as ``harness.flops`` does: the larger of its operations at the bfloat16
peak (10 * head_dim a head and visible causal pair) and its bytes at the
HBM bandwidth (q, k, v, o, dO and the rows' log-sum-exp read, dq, dk and
dv written once, k and v at their KV heads), for as many calls as the
program's backward counter counted in the window.  The kernels are those
whose names hold one of ``KERNELS``: the port's backward kernels and
PyTorch's SDPA backward kernels."""

KERNELS = ("dq_wgmma", "dkdv_wgmma", "prep_kernel", "dq_kernel", "dkdv_kernel", "flash_bwd",
           "fmha_cutlassB", "sdpa_sm90_flash_bprop", "flash_bprop")


def read(run):
    peak = run.peak
    calls = run.win.launches.get("bwd", 0)
    if not peak or run.trace is None or not calls:
        return None
    t = run.trace.seconds_named(KERNELS)
    if t <= 0:
        return None
    least = run.flops.attn_bwd_least_seconds(run.m, run.traffic, calls, peak)
    return 100.0 * least / t
