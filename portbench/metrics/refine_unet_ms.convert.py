"""refine_unet_ms.convert: mean device ms per chunk of the program spans
`slomo.refine_unet` (CUDA events around each group's refinement UNet)."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "submit", ("slomo.refine_unet",), device=True)
