"""SuperSloMo in PyTorch (port of v2e_tpu/models/): the flow and
refinement UNets (`UNet`, an nn.Module that carries its layer spec and
draws its own weights), the bilinear backwarp, the interpolation engine
and the checkpoint loaders, which read the original torch checkpoint and
the JAX package's converted .npz."""

from v2e_tpu_torch.models.unet import UNet, unet_apply
from v2e_tpu_torch.models.backwarp import backwarp
from v2e_tpu_torch.models.slomo import SuperSloMo, interpolate_pairs
from v2e_tpu_torch.models.convert_ckpt import (
    load_slomo_params,
    convert_torch_checkpoint,
    init_random_slomo_params,
)

__all__ = [
    "UNet",
    "unet_apply",
    "backwarp",
    "SuperSloMo",
    "interpolate_pairs",
    "load_slomo_params",
    "convert_torch_checkpoint",
    "init_random_slomo_params",
]
