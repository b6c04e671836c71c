"""materialize_ms.convert: mean host ms per chunk of the program span
`collect.materialize`, the events made from the compacted cells and
shuffled, on the finalize thread."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "submit", ("collect.materialize",))
