"""chunk_ms_p95: the 95th percentile, over every chunk handed over inside
the window, of the ms from the source handing over the chunk's last frame
to the chunk's events reaching the AEDAT-2 file.  None when a chunk never
arrived (the run then counts it as failed)."""
import numpy as np


def read(run):
    hand, done = run.records.get("handover_ns"), run.records.get("done_ns")
    if not hand:
        return None
    ws, we = run.window_start_ns, run.window_end_ns
    chunks = [c for c, t in enumerate(hand) if t is not None and ws <= t < we]
    if not chunks or any(c >= len(done) for c in chunks):
        return None
    return float(np.percentile([(done[c] - hand[c]) / 1e6 for c in chunks], 95))
