"""Event stream sinks and input readers of the port (port of v2e_tpu/io/).

The writers produce the original v2e's file formats: AEDAT-2.0 (jAER),
AEDAT-4.0 (dv), text, and HDF5 event databases.  All take AER events
``events[N, 4] = [t_seconds, x, y, p(+1/-1)]``.  h5py and zstandard are
imported only by the writers that need them.
"""

from v2e_tpu_torch.io.aedat2 import AEDat2Output
from v2e_tpu_torch.io.text import DVSTextOutput
from v2e_tpu_torch.io.hdf5 import DVSH5Output
from v2e_tpu_torch.io.aedat4 import AEDat4Output

__all__ = ["AEDat2Output", "DVSTextOutput", "DVSH5Output", "AEDat4Output"]
