"""Architecture registry of the port: the architectures it serves, by
``--arch`` name -- every configuration of the reference (``dense``,
``moe``, ``ssm``, ``hybrid``, the ``encdec`` whisper-medium and the
``vlm`` pixtral-12b) and the paper's own models (``paper_models``)."""
from repro_torch.configs import paper_models
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.granite_20b import CONFIG as GRANITE_20B
from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA_V01_52B
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as KIMI_K2_1T_A32B
from repro_torch.configs.llama32_1b import CONFIG as LLAMA32_1B
from repro_torch.configs.olmo_1b import CONFIG as OLMO_1B
from repro_torch.configs.phi3_medium_14b import CONFIG as PHI3_MEDIUM_14B
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B_A3B
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6_7B
from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM

ARCHS = {c.name: c for c in (RWKV6_7B, PIXTRAL_12B, KIMI_K2_1T_A32B,
                             QWEN3_MOE_30B_A3B, OLMO_1B, PHI3_MEDIUM_14B,
                             GRANITE_20B, LLAMA32_1B, WHISPER_MEDIUM,
                             JAMBA_V01_52B)}
ARCHS.update(paper_models.PAPER_MODELS)


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ARCHS", "get_arch"]
