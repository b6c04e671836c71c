"""compact_ms.convert: mean device ms per chunk of the program span
`emulator.compact` (the sparse compaction and the scalars packed for the
host)."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "submit", ("emulator.compact",), device=True)
