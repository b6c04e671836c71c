"""fetch_wait_ms.convert: mean host ms per chunk of the program span
`collect.fetch.wait`, the fetch thread's copy of the chunk's scalars,
which waits for the chunk on the device."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "submit", ("collect.fetch.wait",))
