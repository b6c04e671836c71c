"""realtime_x: seconds of source whose events reached the AEDAT-2 file
inside the window, over the window's seconds."""
from portbench.readers import window_done


def read(run):
    if "chunk_source_s" not in run.counts or run.window_s <= 0:
        return None
    return len(window_done(run)) * run.counts["chunk_source_s"] / run.window_s
