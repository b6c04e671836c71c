"""device_idle_pct.convert: 100 x (1 - the union of device activity over
the traced window's length), the training cell."""
from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
