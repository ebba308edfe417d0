"""The attention forward's least time over the device time of the
kernels that compute it, in percent.

The least time is the configuration's count of it
(``run.flops.attn_fwd_least_seconds``).  The default reference counts it
as ``harness.flops`` does: the larger of its operations at the bfloat16
peak (4 * head_dim a head and visible causal pair) and its bytes at the
HBM bandwidth (q, k, v read and o written once, k and v at their KV
heads), for as many calls as the program's ``flash_attention`` counter
counted in the window.  The kernels are those whose names hold one of
``KERNELS``: the port's forward kernels and PyTorch's SDPA forward
kernels, so the share reads the same work whatever computes it."""

KERNELS = ("fa_wgmma", "fa_kernel", "flash_fwd", "fmha_cutlassF", "sdpa_sm90_flash_fprop",
           "flash_fprop")


def read(run):
    peak = run.peak
    calls = run.win.launches.get("flash_attention", 0)
    if not peak or run.trace is None or not calls:
        return None
    t = run.trace.seconds_named(KERNELS)
    if t <= 0:
        return None
    least = run.flops.attn_fwd_least_seconds(run.m, run.traffic, calls, peak)
    return 100.0 * least / t
