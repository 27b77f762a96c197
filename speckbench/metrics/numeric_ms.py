"""numeric_ms (ms a call): the numeric phase, the self time of the
program's ``spGEMMNumeric`` span."""

from speckbench.trace import stage_mean


def read(rec):
    return stage_mean(rec, ("spGEMMNumeric",))
