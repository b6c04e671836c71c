"""The DVS pixel model: config, state, chunk evaluation, events, facade."""
from v2e_tpu_torch.emulator.emulator import EventEmulator

__all__ = ["EventEmulator"]
