"""adam_ms.train: mean device ms per step of the program span `step.adam`
(the optimizer's update)."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "step", ("step.adam",), device=True)
