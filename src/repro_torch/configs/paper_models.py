"""The paper's own evaluation models (Tables 3 & 4): the GPT-2 and BERT
configurations whose end-to-end inference the IANUS paper measures, and
its larger GPTs. The port's own copy, same fields as the reference's.

GPT-2 XL follows the paper: attention heads reduced 25 -> 24 (validated in
DFX [19]) to optimize parallelism.
"""
from repro_torch.configs.base import ModelConfig


def _gpt2(name, d, heads, layers, head_dim=64, vocab=50257):
    return ModelConfig(
        name=name,
        family="dense",
        source="paper Table 3/4 (GPT-2 / GPT)",
        num_layers=layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=head_dim,
        d_ff=4 * d,
        vocab_size=vocab,
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
    )


def _bert(name, d, heads, layers):
    cfg = _gpt2(name, d, heads, layers, vocab=30522)
    return cfg


# --- Table 3 -----------------------------------------------------------------
GPT2_M = _gpt2("gpt2-m", 1024, 16, 24)
GPT2_L = _gpt2("gpt2-l", 1280, 20, 36)
GPT2_XL = _gpt2("gpt2-xl", 1536, 24, 48)          # heads 25 -> 24 per the paper
GPT2_2p5B = _gpt2("gpt2-2.5b", 1920, 20, 54, head_dim=96)

BERT_B = _bert("bert-b", 768, 12, 12)
BERT_L = _bert("bert-l", 1024, 16, 24)
BERT_1p3B = _bert("bert-1.3b", 2048, 32, 24)
BERT_3p9B = _bert("bert-3.9b", 2560, 40, 48)

# --- Table 4 (scalability study) ----------------------------------------------
GPT_6p7B = _gpt2("gpt-6.7b", 4096, 32, 32, head_dim=128)
GPT_13B = _gpt2("gpt-13b", 5120, 40, 40, head_dim=128)
GPT_30B = _gpt2("gpt-30b", 7168, 56, 48, head_dim=128)

PAPER_GPT2 = {c.name: c for c in (GPT2_M, GPT2_L, GPT2_XL, GPT2_2p5B)}
PAPER_BERT = {c.name: c for c in (BERT_B, BERT_L, BERT_1p3B, BERT_3p9B)}
PAPER_LARGE = {c.name: c for c in (GPT_6p7B, GPT_13B, GPT_30B)}
PAPER_MODELS = {**PAPER_GPT2, **PAPER_BERT, **PAPER_LARGE}
