"""flow_unet_ms.convert: mean device ms per chunk of the program span
`slomo.flow_unet` (CUDA events around the flow UNet)."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "submit", ("slomo.flow_unet",), device=True)
