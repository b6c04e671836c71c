"""The DVS pixel model: config, parameters and state, chunk evaluation on
the device (`emulate_chunk`), host event materialization
(`materialize_events`) and the `EventEmulator` facade."""

from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.state import EmulatorParams, EmulatorState, init_state
from v2e_tpu_torch.emulator.core import emulate_chunk
from v2e_tpu_torch.emulator.events import materialize_events
from v2e_tpu_torch.emulator.emulator import EventEmulator

__all__ = [
    "EmulatorConfig",
    "EmulatorParams",
    "EmulatorState",
    "init_state",
    "emulate_chunk",
    "materialize_events",
    "EventEmulator",
]
