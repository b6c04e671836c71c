"""precore_ms.convert: mean device ms per chunk of the program spans
`emulator.precore`: the noise draws, lin-log, the lowpass, leak and shot
noise, up to the inputs of K1 or K2."""
from portbench.spans import per_request_ms


def read(run):
    return per_request_ms(run, "submit", ("emulator.precore",), device=True)
