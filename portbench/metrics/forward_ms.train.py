"""forward_ms.train: mean device ms per step of the program span
`step.forward` (the Super-SloMo loss)."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "step", ("step.forward",), device=True)
