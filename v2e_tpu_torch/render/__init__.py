"""Event-frame rendering (DVS video)."""

from v2e_tpu_torch.render.renderer import EventRenderer, ExposureMode

__all__ = ["EventRenderer", "ExposureMode"]
