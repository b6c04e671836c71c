"""backward_ms.train: mean device ms per step of the program span
`step.backward` (the loss's backward pass)."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "step", ("step.backward",), device=True)
