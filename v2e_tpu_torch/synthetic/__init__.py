"""Synthetic inputs of the port (port of v2e_tpu/synthetic/).

Analytically defined stimuli, used as demo inputs and as the emulator's
test oracle (known contrast and speed give predictable event counts).  The
plugin protocol is the reference's: subclass `base_synthetic_input` and
override ``next_frame()``/``total_frames()``; the CLI loads the class by
module path (loader.py).  The bundled generators also render whole chunks
on the device (``device_frames``, device.py).  `make_source_frames`
(source.py) is the benchmark's source video.
"""

from v2e_tpu_torch.synthetic.base import base_synthetic_input
from v2e_tpu_torch.synthetic.loader import load_synthetic_input
from v2e_tpu_torch.synthetic.source import make_source_frames

__all__ = ["base_synthetic_input", "load_synthetic_input", "make_source_frames"]
