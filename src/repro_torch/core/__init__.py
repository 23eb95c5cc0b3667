"""IANUS core: the paper's contribution as composable pieces (the port's
own copy of ``repro.core``; ``assert_unified_layout``, which needs a device
mesh, is not part of either package's ``__all__``).

  cost_model      — analytical MU/VU/DMA/PIM engine models (Alg. 1 substrate)
  pas             — PIM Access Scheduling: Algorithm 1, MHA mapping, policies
  unified_memory  — Fig. 4/5 tile allocation + address mapping; capacity math
"""
from repro_torch.core.cost_model import (
    FCConfig,
    HardwareModel,
    IANUS_HW,
    NPU_MEM_HW,
    TPU_V5E,
    TPU_ICI_BW,
    RooflineTerms,
    roofline,
)
from repro_torch.core.pas import (
    Command,
    MappingDecision,
    PASPolicy,
    adaptive_map,
    command_from_dict,
    command_to_dict,
    commands_from_dicts,
    decide_qk_sv_unit,
    decision_from_dict,
    decision_to_dict,
    decode_uses_gemv,
    lower_commands,
    merge_streams,
    phase_log_entry,
    route_fc_tpu,
    MU, VU, PIM, DMA, VALID_UNITS,
)
from repro_torch.core.unified_memory import (
    AddressMap,
    MemoryPlan,
    WeightTiler,
    partitioned_plan,
    shared_fraction,
    unified_plan,
)

__all__ = [
    "FCConfig", "HardwareModel", "IANUS_HW", "NPU_MEM_HW", "TPU_V5E",
    "TPU_ICI_BW", "RooflineTerms", "roofline",
    "Command", "MappingDecision", "PASPolicy", "adaptive_map",
    "command_from_dict", "command_to_dict", "commands_from_dicts",
    "decide_qk_sv_unit", "decision_from_dict", "decision_to_dict",
    "decode_uses_gemv", "lower_commands", "merge_streams",
    "phase_log_entry", "route_fc_tpu",
    "MU", "VU", "PIM", "DMA", "VALID_UNITS",
    "AddressMap", "MemoryPlan", "WeightTiler",
    "partitioned_plan", "shared_fraction", "unified_plan",
]
