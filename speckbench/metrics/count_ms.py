"""count_ms (ms a call): count and stage, the self time of the program's
``spGEMMCounting`` and ``allocC`` spans."""

from speckbench.trace import stage_mean


def read(rec):
    return stage_mean(rec, ("spGEMMCounting", "allocC"))
