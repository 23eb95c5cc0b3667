"""Architecture registry of the port: the architectures it serves."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA_V01_52B
from repro_torch.configs.llama32_1b import CONFIG as LLAMA32_1B
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6_7B

ARCHS = {c.name: c for c in (LLAMA32_1B, RWKV6_7B, JAMBA_V01_52B)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ARCHS", "get_arch"]
