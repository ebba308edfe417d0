"""The expert slots the program's MoE layers filled over the slots they
computed, in the traced window, in percent: (``moe.routed`` - the sum of
``moe.dropped``) / ``moe.slots``, the program's own counters
(`harness.program.counters`).  A slot not filled is padding the expert
products compute all the same."""

from harness import program


def read(run):
    n = program.moe_counts(program.counters()) if run.trace is not None else None
    return 100.0 * (n[0] - n[1]) / n[2] if n else None
