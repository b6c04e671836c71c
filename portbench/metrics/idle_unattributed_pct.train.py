"""idle_unattributed_pct.train: 100 x the share of the traced window's
device idle time at whose middle the training thread had no program span
open (portbench/spans.py, idle attribution)."""
from portbench.spans import idle_unattributed_pct


def read(run):
    return idle_unattributed_pct(run, ("step", "sampler"))
