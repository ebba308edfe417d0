"""The (token, choice) pairs the program's MoE layers dropped at their
experts' capacity over the pairs they routed, in the traced window, in
percent: the program's own counters ``moe.dropped`` (per expert, summed)
and ``moe.routed`` (`harness.program.counters`)."""

from harness import program


def read(run):
    n = program.moe_counts(program.counters()) if run.trace is not None else None
    return 100.0 * n[1] / n[0] if n else None
