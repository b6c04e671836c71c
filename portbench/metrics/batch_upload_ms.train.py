"""batch_upload_ms.train: mean host ms per step of the program span
`step.upload`, the batch's copy to the card."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "step", ("step.upload",))
