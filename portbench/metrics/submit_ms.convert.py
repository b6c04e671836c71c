"""submit_ms.convert: mean host ms of the emulator's submit call per chunk
in the window (the fused chunk's enqueue, and compaction's wait for the
device's occupancy count)."""
from portbench.readers import host_mean_ms


def read(run):
    return host_mean_ms(run, "submit")
