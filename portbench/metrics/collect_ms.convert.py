"""collect_ms.convert: mean host ms per chunk of the emulator's
collect_fetch plus collect_finalize (the copy of the compacted cells, the
events' materialization and the AEDAT-2 write), on the pipeline's
threads."""
from portbench.readers import host_mean_ms


def read(run):
    fetch, fin = host_mean_ms(run, "collect_fetch"), host_mean_ms(run, "collect_finalize")
    if fetch is None or fin is None:
        return None
    return fetch + fin
