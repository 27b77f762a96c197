"""plan_ms (ms a call): analysis and planning, the self time of the
program's ``countProducts`` and ``loadBalanceCounting`` spans (on a
diagonal-plane route ``loadBalanceCounting`` holds the plan's count and
alloc, which are ``count_ms``'s)."""

from speckbench.trace import stage_mean


def read(rec):
    return stage_mean(rec, ("countProducts", "loadBalanceCounting"))
