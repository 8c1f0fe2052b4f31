"""Config-driven language model: the logical plan for the planner (prefill,
``prefill_kv`` and training shapes) and its parameters.

The port of the reference's ``models/lm.py`` for the ``dense`` family
(qwen3-0.6b).  The plan builders are the reference's node for node, so a
plan's id equals the reference's under an equal ``SystemCatalog``.
Parameters are a nested dict of tensors keyed exactly as the reference's
tree (``layers_0`` → ``b0_attn`` → ``wq`` …, each leaf stacked over the
group's layers), so the plans' ``pp`` paths index them unchanged;
:func:`params_from_numpy` carries the reference's parameters across.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.ir import Plan, TensorT, standard_catalog
from ..layers import attention as A
from ..layers import embedding as E
from ..layers import mlp as F
from ..layers.common import stack_params, torch_dtype

CATALOG = standard_catalog()
# the matrices the layers cast to the activation dtype before a matmul
_PROJECTIONS = frozenset(("wq", "wk", "wv", "wo", "wi", "wg"))


# --------------------------------------------------------------------------
# block descriptors and grouping
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Block:
    kind: str              # attn_mlp (the port's only kind so far)
    window: int = 0        # 0 = global attention
    causal: bool = True
    cross: bool = False    # decoder block with cross-attention


@dataclass(frozen=True)
class Group:
    """A scan group: ``count`` repetitions of the ``blocks`` superblock."""

    name: str
    count: int
    blocks: tuple


def layer_groups(cfg: ModelConfig) -> list:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"§1, the LM stack); the port runs the dense family")
    if cfg.local_ratio > 0:
        period = cfg.local_ratio + 1
        sup = tuple([Block("attn_mlp", window=cfg.window)] * cfg.local_ratio
                    + [Block("attn_mlp")])
        n_sup, rem = divmod(cfg.n_layers, period)
        groups = [Group("layers_0", n_sup, sup)]
        if rem:
            groups.append(Group(
                "layers_1", rem, (Block("attn_mlp", window=cfg.window),)))
        return groups
    return [Group("layers_0", cfg.n_layers, (Block("attn_mlp"),))]


# --------------------------------------------------------------------------
# param init
# --------------------------------------------------------------------------

def _attn_cfg(cfg: ModelConfig) -> dict:
    return {"embed": cfg.d_model, "heads": cfg.heads,
            "kv_heads": cfg.kv_heads, "head_dim": cfg.resolved_head_dim,
            "qk_norm": cfg.qk_norm}


def _init_block(gen, cfg: ModelConfig, block: Block, i: int, dtype):
    if block.kind != "attn_mlp" or block.cross:
        raise NotImplementedError(f"block {block} is not ported yet")
    e = cfg.d_model
    zeros = lambda: torch.zeros((e,), dtype=dtype, device=gen.device)  # noqa
    return {
        f"b{i}_ln1": {"scale": zeros()},
        f"b{i}_attn": A.init_attention(gen, _attn_cfg(cfg), dtype),
        f"b{i}_ln2": {"scale": zeros()},
        f"b{i}_mlp": F.init_mlp(
            gen, {"embed": e, "ffn": cfg.d_ff, "gated": cfg.gated}, dtype),
    }


def params_from_numpy(tree, device="cpu"):
    """A nested dict of arrays (the reference's parameters as numpy) as
    the same nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.array(tree)                  # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(device)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups = layer_groups(cfg)
        self.dtype = torch_dtype(cfg.dtype)
        self.pdtype = torch_dtype(cfg.param_dtype)

    # -- params -------------------------------------------------------------
    def init_params(self, gen: torch.Generator) -> dict:
        """He-initialized parameters drawn from ``gen``, made on its
        device, in ``cfg.param_dtype`` (the reference's tree)."""
        cfg = self.cfg
        params: dict = {"embed": E.init_embedding(
            gen, cfg.padded_vocab, cfg.d_model, self.pdtype,
            tied=cfg.tied_embeddings)}
        for g in self.groups:
            layers = []
            for _ in range(g.count):
                lp: dict = {}
                for i, blk in enumerate(g.blocks):
                    lp.update(_init_block(gen, cfg, blk, i, self.pdtype))
                layers.append(lp)
            params[g.name] = stack_params(layers)
        params["final_norm"] = {"scale": torch.zeros(
            (cfg.d_model,), dtype=self.pdtype, device=gen.device)}
        return params

    def inference_params(self, params: dict) -> dict:
        """``params`` with every projection matrix (``wq wk wv wo wi wg``)
        cast to the activation dtype once.  The reference casts them per
        call (``w.astype(x.dtype)``); the values are the same, without a
        cast of every matrix at every step.  Norm scales and the embedding
        table keep their dtype: rmsnorm and unembed read them in
        float32."""
        def cast(tree):
            return {k: cast(v) if isinstance(v, dict)
                    else v.to(self.dtype) if k in _PROJECTIONS else v
                    for k, v in tree.items()}
        return cast(params)

    # -- logical plan ---------------------------------------------------------
    def _block_nodes(self, sub: Plan, x: str, i: int, blk: Block,
                     emit_kv: bool = False) -> str:
        cfg = self.cfg
        if blk.kind != "attn_mlp" or blk.cross:
            raise NotImplementedError(f"block {blk} is not ported yet")
        pp = "b" + str(i)
        h = sub.add("rmsnorm", [x], {"pp": (f"{pp}_ln1",)})
        att = sub.add("attention", [h], {
            "pp": (f"{pp}_attn",), **_attn_cfg(cfg),
            "causal": blk.causal, "window": blk.window,
            "rope_theta": cfg.rope_theta,
            **({"emit_kv": True} if emit_kv else {})})
        x = sub.add("residual_add", [x, att])
        h = sub.add("rmsnorm", [x], {"pp": (f"{pp}_ln2",)})
        m = sub.add("mlp", [h], {
            "pp": (f"{pp}_mlp",), "ffn": cfg.d_ff,
            "gated": cfg.gated, "act": cfg.act,
            "embed": cfg.d_model})
        return sub.add("residual_add", [x, m])

    def _group_subplan(self, g: Group, batch: int, seq: int,
                       emit_kv: bool = False) -> Plan:
        cfg = self.cfg
        sub = Plan(name=f"{cfg.name}_{g.name}")
        sub.add_input("h", TensorT((batch, seq, cfg.d_model), cfg.dtype,
                                   ("batch", "seq", "embed")))
        x = "h"
        for i, blk in enumerate(g.blocks):
            x = self._block_nodes(sub, x, i, blk, emit_kv=emit_kv)
        sub.set_outputs(x)
        return sub

    def supports_prefill_kv(self) -> bool:
        """True when the whole serving cache is attention K/V — i.e. a
        ``prefill_kv`` plan captures the entire decode state."""
        return self.cfg.family in ("dense", "moe") and \
            self.cfg.frontend == "none"

    def build_plan(self, batch: int, seq: int, mode: str = "train") -> Plan:
        """The workload's logical plan.  ``mode="prefill_kv"`` is the
        serving prefill: like ``prefill`` but every attention carries
        ``emit_kv`` and every scan group collects the per-layer K/V as an
        extra plan output — (logits, kv_g0, kv_g1, ...) — so the KV cache is
        seeded directly from the planned forward."""
        cfg = self.cfg
        collect_kv = mode == "prefill_kv"
        if collect_kv and not self.supports_prefill_kv():
            raise ValueError(
                f"prefill_kv plans need an attention-only decode state; "
                f"{cfg.name} (family={cfg.family}, frontend={cfg.frontend}) "
                f"carries recurrent/frontend state")
        plan = Plan(name=f"{cfg.name}-{mode}")
        tokens = plan.add_input("tokens", TensorT((batch, seq), "int32",
                                                  ("batch", "seq")))
        x = plan.add("embed", [tokens], {
            "pp": ("embed",), "vocab": cfg.vocab, "embed": cfg.d_model,
            "dtype": cfg.dtype, "scale": cfg.embed_scale})
        kv_outs = []
        for g in self.groups:
            sub = self._group_subplan(g, batch, seq, emit_kv=collect_kv)
            x = plan.add("scan_layers", [x], {
                "n_layers": g.count, "pp": (g.name,),
                "param_group": g.name, "remat": cfg.remat,
                "unroll": cfg.scan_unroll,
                **({"collect_kv": True} if collect_kv else {})}, subplan=sub)
            if collect_kv:
                kv_outs.append(plan.add("tuple_get", [x], {"index": 1}))
                x = plan.add("tuple_get", [x], {"index": 0})
        x = plan.add("rmsnorm", [x], {"pp": ("final_norm",)})
        logits = plan.add("unembed", [x], {"pp": ("embed",),
                                           "vocab": cfg.padded_vocab,
                                           "true_vocab": cfg.vocab})
        if mode == "train":
            labels = plan.add_input("labels", TensorT((batch, seq), "int32",
                                                      ("batch", "seq")))
            loss = plan.add("softmax_xent", [logits, labels])
            out = plan.add("store", [loss])
            plan.set_outputs(out)
        else:
            out = plan.add("store", [logits])
            kv_stores = [plan.add("store", [k]) for k in kv_outs]
            plan.set_outputs(out, *kv_stores)
        return plan


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
