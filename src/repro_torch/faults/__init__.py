"""Deterministic fault injection and recovery (``repro.faults``): the
fault models, their pre-drawn traces, the exact retry billing and the
corruption seed stream of :mod:`repro_torch.faults.model`, and the
checksum frame (:mod:`repro_torch.faults.frame`).  ``None``/``"none"`` is
the default and leaves the trainers on their unmasked paths."""
from repro_torch.faults.frame import (FRAME_BYTES, FramedCodec,
                                      check_frame, corrupt_frame,
                                      corrupt_payload, frame_checksum,
                                      make_frame)
from repro_torch.faults.model import (FAULT_MODELS, FAULT_STREAM, NO_FAULTS,
                                      RETRY_FOLD, RETRY_SALT, CrashyClients,
                                      FaultModel, FaultStats, FaultTrace,
                                      LossyWire, NoFaults, OutageServer,
                                      accumulate_round, fault_from_flags,
                                      make_fault, register_fault,
                                      resolve_fault, retry_key,
                                      round_wire_bytes)

__all__ = [
    "FRAME_BYTES", "FAULT_MODELS", "FAULT_STREAM", "NO_FAULTS",
    "RETRY_FOLD", "RETRY_SALT", "CrashyClients", "FaultModel", "FaultStats",
    "FaultTrace", "FramedCodec", "LossyWire", "NoFaults", "OutageServer",
    "accumulate_round", "check_frame", "corrupt_frame", "corrupt_payload",
    "fault_from_flags", "frame_checksum", "make_fault", "make_frame",
    "register_fault", "resolve_fault", "retry_key", "round_wire_bytes",
]
