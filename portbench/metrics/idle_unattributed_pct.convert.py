"""idle_unattributed_pct.convert: 100 x the share of the traced window's
device idle time at whose middle the submitting thread had no program
span open (portbench/spans.py, idle attribution)."""
from portbench.spans import idle_unattributed_pct


def read(run):
    return idle_unattributed_pct(run, ("submit",))
