"""Command-stream builders for the paper's evaluation models (GPT-2 / BERT).

Emits the per-layer operation DAG of a transformer decoder for either stage,
with the dependency structure of the Fig. 7 schedules:

  summarization (7a): K-transpose overlaps V-generation (on-chip DMA), V
     moves to the WM during softmax, next FC weights prefetch during compute.
  generation (7c, MU mapping): K-concat on VU overlaps Q-gen on PIM, K/V
     prefetch overlaps SV of the previous head, QK^T/softmax overlap V-gen.
  generation (7b, PIM mapping): QK^T/SV issued to PIM (row-efficiency loss).

Workload mapping (§5.1): attention heads round-robin across NPU cores;
other FCs column-partitioned over the 4 cores with a join (sync) at the
four residual/GELU points. Adaptive FC mapping (Algorithm 1) runs on the
emitted stream before simulation.

The port's own copy of ``repro/sim/graphs.py``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import FCConfig, HardwareModel, IANUS_HW
from repro_torch.core.pas import (Command, PASPolicy, MU, VU, PIM, DMA,
                                  adaptive_map)


class _Builder:
    def __init__(self):
        self.cmds: List[Command] = []

    def add(self, cmd: Command) -> int:
        self.cmds.append(cmd)
        return len(self.cmds) - 1

    def fc_mu(self, name, n, d_in, d_out, deps, tag, cores=4,
              prefetch_dep: Optional[int] = None, bpe=2) -> List[int]:
        """Column-partitioned FC on the MU across `cores` cores, each with
        its own weight-load DMA. `prefetch_dep`: earliest point the weight
        load may start (scheduled mode prefetching)."""
        outs = []
        per_core = d_out // cores
        for c in range(cores):
            ld_dep = (prefetch_dep,) if prefetch_dep is not None else tuple(deps)
            ld = self.add(Command(f"{name}.w{c}", DMA, "dma_load",
                                  bytes=d_in * per_core * bpe,
                                  deps=ld_dep, tag=tag, core=c))
            outs.append(self.add(Command(
                f"{name}.{c}", MU, "fc", n_tokens=n,
                fc=FCConfig(d_in, per_core),
                deps=tuple(deps) + (ld,), tag=tag, core=c)))
        return outs

    def fc_any(self, name, n, d_in, d_out, deps, tag,
               prefetch_dep=None, cores=4) -> List[int]:
        """FC emitted as MU-mapped (Algorithm 1 may retarget to PIM).
        Generation-stage FCs use cores=1: PIM executes the whole FC across
        all channels/banks (head-wise weight partitioning is *within* the
        PIM array), so column-chunking would only inflate tile rounding."""
        return self.fc_mu(name, n, d_in, d_out, deps, tag, cores=cores,
                          prefetch_dep=prefetch_dep)


def _vu(b: _Builder, name, n, dim, deps, tag, passes=1.0, core=0) -> int:
    return b.add(Command(name, VU, "vec", n_tokens=n, dim=dim,
                         vu_passes=passes, deps=tuple(deps), tag=tag,
                         core=core))


# --------------------------------------------------------------------------- #
# one decoder layer
# --------------------------------------------------------------------------- #
def decoder_layer(b: _Builder, cfg: ModelConfig, n: int, kv_len: int,
                  stage: str, policy: PASPolicy, entry: int,
                  causal: bool = True, bpe: int = 2) -> int:
    """Append one decoder layer; returns the index of its output command.
    `entry` = dependency for the layer's first ops (previous layer output).
    `n` = tokens this pass; `kv_len` = total attended context (generation)."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    cores = 4

    ln1 = _vu(b, "ln1", n, d, [entry], "norm_res", passes=2.0)

    if stage == "summarization":
        # Fig. 7a: K first (so transpose overlaps V-gen), scaling folded into
        # the MU (output scaling support), V moved to WM during softmax.
        k = b.fc_any("k_gen", n, d, cfg.kv_dim, [ln1], "self_attn",
                     prefetch_dep=entry)
        ktr = b.add(Command("k_transpose", DMA, "dma_onchip",
                            bytes=n * cfg.kv_dim * bpe, deps=tuple(k),
                            tag="self_attn"))
        q = b.fc_any("q_gen", n, d, cfg.q_dim, [ln1], "fc_mha",
                     prefetch_dep=entry)
        v = b.fc_any("v_gen", n, d, cfg.kv_dim, [ln1], "self_attn",
                     prefetch_dep=entry)
        kv_store = b.add(Command("kv_store", DMA, "dma_store",
                                 bytes=2 * n * cfg.kv_dim * bpe,
                                 deps=tuple(k) + tuple(v), tag="self_attn"))
        # per-head QK^T -> masked softmax -> SV; heads pipelined per core
        # (the compiler emits one command per head; consecutive heads on a
        # core pipeline, so we batch heads_per_core per command)
        hpc = max(1, H // cores)
        sv_joins = []
        for core in range(cores):
            qk = b.add(Command(f"qk.c{core}", MU, "fc", n_tokens=n,
                               fc=FCConfig(hd, n * hpc),
                               deps=(q[core % len(q)], ktr), tag="self_attn",
                               core=core, weights_resident=False))
            sm = _vu(b, f"softmax.c{core}", n, n * hpc, [qk], "self_attn",
                     passes=1.5, core=core)
            vmv = b.add(Command(f"v_move.c{core}", DMA, "dma_onchip",
                                bytes=n * hd * hpc * bpe,
                                deps=(v[core % len(v)],), tag="self_attn",
                                core=core))
            sv = b.add(Command(f"sv.c{core}", MU, "fc", n_tokens=n,
                               fc=FCConfig(n, hd * hpc), deps=(sm, vmv),
                               tag="self_attn", core=core,
                               weights_resident=False))
            sv_joins.append(sv)
        proj = b.fc_any("out_proj", n, cfg.q_dim, d, sv_joins, "fc_mha",
                        prefetch_dep=entry)
        res1 = _vu(b, "res1", n, d, proj, "norm_res")            # sync point
    else:
        # generation (Fig. 7b/c): QKV GEMVs -> PIM via Algorithm 1
        k = b.fc_any("k_gen", n, d, cfg.kv_dim, [ln1], "self_attn",
                     prefetch_dep=entry, cores=1)
        kcat = _vu(b, "k_concat", n, cfg.kv_dim, k, "self_attn")
        ktr = b.add(Command("k_transpose", DMA, "dma_onchip",
                            bytes=kv_len * cfg.kv_dim * bpe, deps=(kcat,),
                            tag="self_attn"))
        q = b.fc_any("q_gen", n, d, cfg.q_dim, [ln1], "fc_mha",
                     prefetch_dep=entry, cores=1)
        v = b.fc_any("v_gen", n, d, cfg.kv_dim, [ln1], "self_attn",
                     prefetch_dep=entry, cores=1)
        # K_prev/V_prev prefetch: free to overlap from layer entry when
        # scheduled; the naive mode serializes it behind PIM bursts anyway.
        kv_bytes = 2 * kv_len * cfg.kv_dim * bpe
        kv_prefetch = b.add(Command("kv_prefetch", DMA, "dma_load",
                                    bytes=kv_bytes, deps=(entry,),
                                    tag="self_attn"))
        kv_store = b.add(Command("kv_store", DMA, "dma_store",
                                 bytes=2 * n * cfg.kv_dim * bpe,
                                 deps=tuple(k) + tuple(v), tag="self_attn"))
        sv_joins = []
        hpc = max(1, H // cores)
        if policy.qk_sv_unit == PIM:
            # Fig. 7b: QK^T and SV on PIM; DRAM row holds head_dim useful
            # elements -> d_in padded to the row (6.25% efficiency at 64).
            for h in range(H):
                qk = b.add(Command(f"qk.{h}", PIM, "fc", n_tokens=n,
                                   fc=FCConfig(1024, kv_len),
                                   deps=tuple(q) + (kv_store,),
                                   tag="self_attn"))
                sm = _vu(b, f"softmax.{h}", n, kv_len, [qk], "self_attn",
                         passes=1.5, core=h % cores)
                sv = b.add(Command(f"sv.{h}", PIM, "fc", n_tokens=n,
                                   fc=FCConfig(1024, hd),
                                   deps=(sm,), tag="self_attn"))
                sv_joins.append(sv)
        else:
            # Fig. 7c: QK^T / SV on the MU, overlapped with PIM FCs;
            # heads pipeline per core (inter-attention-head pipelining)
            for core in range(cores):
                qk = b.add(Command(f"qk.c{core}", MU, "fc", n_tokens=n,
                                   fc=FCConfig(hd, kv_len * hpc),
                                   deps=(q[core % len(q)], ktr, kv_prefetch),
                                   tag="self_attn", core=core,
                                   weights_resident=False))
                sm = _vu(b, f"softmax.c{core}", n, kv_len * hpc, [qk],
                         "self_attn", passes=1.5, core=core)
                sv = b.add(Command(f"sv.c{core}", MU, "fc", n_tokens=n,
                                   fc=FCConfig(kv_len, hd * hpc),
                                   deps=(sm, kv_prefetch, v[core % len(v)]),
                                   tag="self_attn", core=core,
                                   weights_resident=False))
                sv_joins.append(sv)
        proj = b.fc_any("out_proj", n, cfg.q_dim, d, sv_joins, "fc_mha",
                        prefetch_dep=entry)
        res1 = _vu(b, "res1", n, d, proj, "norm_res")

    ln2 = _vu(b, "ln2", n, d, [res1], "norm_res", passes=2.0)
    ff1 = b.fc_any("ffn1", n, d, cfg.d_ff, [ln2], "ffn", prefetch_dep=res1)
    act = _vu(b, "act_gelu", n, cfg.d_ff, ff1, "ffn")
    ff2 = b.fc_any("ffn2", n, cfg.d_ff, d, [act], "ffn", prefetch_dep=res1)
    res2 = _vu(b, "res2", n, d, ff2, "norm_res")                 # sync point
    return res2


def build_stage(cfg: ModelConfig, n: int, kv_len: int, stage: str,
                policy: PASPolicy, lm_head: bool = True,
                causal: bool = True,
                hw: HardwareModel = IANUS_HW) -> List[Command]:
    """Full model pass: embedding load, L decoder layers, LM head."""
    b = _Builder()
    emb = b.add(Command("embed", DMA, "dma_load",
                        bytes=n * cfg.d_model * 2, deps=(), tag="embed"))
    out = emb
    for _layer in range(cfg.num_layers):
        out = decoder_layer(b, cfg, n, kv_len, stage, policy, out,
                            causal=causal)
    if lm_head:
        lnf = _vu(b, "ln_f", n, cfg.d_model, [out], "norm_res", passes=2.0)
        # generation: one-token GEMV (PIM candidate); summarization: only the
        # last token feeds sampling
        head_tokens = 1
        b.fc_any("lm_head", head_tokens, cfg.d_model, cfg.vocab_size,
                 [lnf], "lm_head", prefetch_dep=out)
    cmds = b.cmds
    if policy.adaptive_fc:
        cmds, _ = adaptive_map(cmds, n, hw)
    return cmds


# --------------------------------------------------------------------------- #
# end-to-end latency composition
# --------------------------------------------------------------------------- #
def generation_step_latency(sim, cfg: ModelConfig, kv_len: int,
                            policy: PASPolicy):
    cmds = build_stage(cfg, 1, kv_len, "generation", policy, hw=sim.cfg.hw)
    return sim.run(cmds)


def e2e_latency(sim, cfg: ModelConfig, n_in: int, n_out: int,
                policy: PASPolicy) -> dict:
    """Summarization of n_in tokens + n_out generation steps. Step latency is
    affine in kv_len, so generation is sampled at 2 points and integrated
    (exact for an affine model; verified in tests)."""
    s = sim.run(build_stage(cfg, n_in, n_in, "summarization", policy,
                            hw=sim.cfg.hw))
    total = s.makespan
    tags = dict(s.tag_time)
    gen = 0.0
    if n_out > 1:
        r1 = generation_step_latency(sim, cfg, n_in + 1, policy)
        r2 = generation_step_latency(sim, cfg, n_in + n_out, policy)
        t1, t2 = r1.makespan, r2.makespan
        slope = (t2 - t1) / max(1, (n_out - 1))
        # sum_{i=1..n_out} (t1 + slope*(i-1))
        gen = n_out * t1 + slope * (n_out - 1) * n_out / 2.0
        for k in set(r1.tag_time) | set(r2.tag_time):
            a, bb = r1.tag_time.get(k, 0.0), r2.tag_time.get(k, 0.0)
            tags[k] = tags.get(k, 0.0) + n_out * (a + bb) / 2.0
    elif n_out == 1:
        r1 = generation_step_latency(sim, cfg, n_in + 1, policy)
        gen = r1.makespan
        for k, vv in r1.tag_time.items():
            tags[k] = tags.get(k, 0.0) + vv
    return {"total": total + gen, "summarization": total, "generation": gen,
            "tags": tags}
