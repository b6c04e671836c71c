"""sink_write_ms.convert: mean host ms per chunk of the program spans
`collect.write`, each sink's pack and write (here the AEDAT-2 file)."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "submit", ("collect.write",))
