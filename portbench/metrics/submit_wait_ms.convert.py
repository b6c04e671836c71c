"""submit_wait_ms.convert: mean host ms per chunk that the submitting
thread waits on the device inside submit: the program spans
`submit.upload` (frames and times to the card), `slomo.resize.upload`
(the pre- and postprocess resizes' weight matrices to the card, pageable
copies that wait for the stream) and `emulator.compact.sync`
(compaction's torch.nonzero)."""
from portbench.spans import per_request_ms

WAITS = ("submit.upload", "slomo.resize.upload", "emulator.compact.sync")


def read(run):
    return per_request_ms(run, "submit", WAITS)
