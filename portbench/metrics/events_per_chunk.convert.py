"""events_per_chunk.convert: mean events per chunk, the `events` count of
the program span `collect.finalize`."""
from portbench.spans import per_request_count


def read(run):
    return per_request_count(run, "submit", "collect.finalize", "events")
