"""Deterministic fault injection and recovery (``repro.faults``): the
fault models, their pre-drawn traces and the exact retry billing of
:mod:`repro_torch.faults.model`, and the checksum frame's size
(:mod:`repro_torch.faults.frame`).  ``None``/``"none"`` is the default
and leaves the Trainer on its unmasked path."""
from repro_torch.faults.frame import FRAME_BYTES
from repro_torch.faults.model import (FAULT_MODELS, FAULT_STREAM, NO_FAULTS,
                                      RETRY_FOLD, CrashyClients, FaultModel,
                                      FaultStats, FaultTrace, LossyWire,
                                      NoFaults, OutageServer,
                                      accumulate_round, fault_from_flags,
                                      make_fault, register_fault,
                                      resolve_fault, round_wire_bytes)

__all__ = [
    "FRAME_BYTES", "FAULT_MODELS", "FAULT_STREAM", "NO_FAULTS",
    "RETRY_FOLD", "CrashyClients", "FaultModel", "FaultStats", "FaultTrace",
    "LossyWire", "NoFaults", "OutageServer", "accumulate_round",
    "fault_from_flags", "make_fault", "register_fault", "resolve_fault",
    "round_wire_bytes",
]
