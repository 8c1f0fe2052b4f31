"""Config-driven language model: the logical plan for the planner (prefill,
``prefill_kv`` and training shapes) and its parameters.

The port of the reference's ``models/lm.py`` for every family: ``dense``
(qwen3-0.6b, deepseek-7b, stablelm-12b, gemma3-27b with its 5:1
local:global windows), ``moe`` (dbrx-132b, llama4-maverick: attention +
mixture-of-experts blocks), ``rwkv`` (rwkv6-3b), ``hybrid`` (zamba2-7b:
mamba blocks and a weight-shared attention block), ``vlm`` (llava-next-34b:
the dense stack behind a prefix of ``frontend_tokens`` precomputed
embeddings, joined by ``concat_seq``) and ``encdec`` (seamless-m4t-medium:
a non-causal encoder over precomputed frames, ``enc_norm``, and a decoder
whose blocks cross-attend to the encoder's output).  The plan builders are
the reference's node for node, so a plan's id equals the reference's under an
equal ``SystemCatalog``.
Parameters are a nested dict of tensors keyed exactly as the reference's
tree (``layers_0`` → ``b0_attn`` → ``wq`` …, each leaf stacked over the
group's layers), so the plans' ``pp`` paths index them unchanged;
:func:`params_from_numpy` carries the reference's parameters across, and
:func:`train_state_from_numpy` a whole train state.  ``LM.param_specs``
is the reference's specs tree (each leaf's tuple of dim names, for the
sharding rules), built without making a tensor, ``abstract_params``
the parameter tree as meta tensors (shapes and dtypes, nothing drawn),
and ``input_specs`` a cell's inputs as meta tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.ir import Plan, TensorT, standard_catalog
from ..layers import attention as A
from ..layers import embedding as E
from ..layers import mamba as M
from ..layers import mlp as F
from ..layers import moe as X
from ..layers import rwkv as R
from ..layers.common import META, stack_layers, stack_specs, torch_dtype
from ..train.train_step import TrainState

CATALOG = standard_catalog()
# the parameters the layers cast to the activation dtype at every call
# (``.astype(x.dtype)`` in the reference): attention and mlp projections
# (the moe block's expert weights ``wi``, ``wg``, ``wo`` too), the rwkv
# time and channel mixes' projections, decay LoRA and token-shift mixes,
# the mamba block's projections, conv and skip.  ``w0``, ``u``, ``a_log``,
# ``dt_bias``, the moe ``router`` and every norm scale are read in
# float32.
_CAST = frozenset(("wq", "wk", "wv", "wo", "wi", "wg",
                   "wr", "wA", "wB", "mu",
                   "w_in", "conv", "d_skip", "w_out"))


# --------------------------------------------------------------------------
# block descriptors and grouping
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Block:
    kind: str              # attn_mlp | attn_moe | rwkv | mamba | shared_attn
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
    if cfg.family == "encdec":
        return [
            Group("enc_0", cfg.enc_layers, (Block("attn_mlp", causal=False),)),
            Group("dec_0", cfg.dec_layers, (Block("attn_mlp", cross=True),)),
        ]
    if cfg.family == "rwkv":
        return [Group("layers_0", cfg.n_layers, (Block("rwkv"),))]
    if cfg.family == "hybrid":
        period = cfg.shared_attn_period
        sup = tuple([Block("mamba")] * (period - 1) + [Block("shared_attn")])
        n_sup, rem = divmod(cfg.n_layers, period)
        groups = [Group("layers_0", n_sup, sup)]
        if rem:
            groups.append(Group("layers_1", rem, (Block("mamba"),)))
        return groups
    if cfg.family == "moe":
        if cfg.moe_every > 1:
            sup = tuple([Block("attn_mlp")] * (cfg.moe_every - 1)
                        + [Block("attn_moe")])
            n_sup, rem = divmod(cfg.n_layers, cfg.moe_every)
            groups = [Group("layers_0", n_sup, sup)]
            if rem:
                groups.append(Group("layers_1", rem, (Block("attn_mlp"),)))
            return groups
        return [Group("layers_0", cfg.n_layers, (Block("attn_moe"),))]
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
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


def _mamba_cfg(cfg: ModelConfig) -> dict:
    return {"embed": cfg.d_model, "state": cfg.ssm_state,
            "expand": cfg.expand, "head_dim": cfg.mamba_head_dim}


def _init_block(gen, cfg: ModelConfig, block: Block, i: int, dtype):
    e = cfg.d_model
    zeros = lambda: {"scale": torch.zeros(  # noqa: E731
        (e,), dtype=dtype, device=gen.device)}
    if block.kind in ("attn_mlp", "attn_moe"):
        p = {f"b{i}_ln1": zeros(),
             f"b{i}_attn": A.init_attention(gen, _attn_cfg(cfg), dtype)}
        if block.cross:
            p[f"b{i}_lnx"] = zeros()
            p[f"b{i}_xattn"] = A.init_attention(gen, _attn_cfg(cfg), dtype)
        p[f"b{i}_ln2"] = zeros()
        if block.kind == "attn_moe":
            p[f"b{i}_moe"] = X.init_moe(
                gen, {"embed": e, "ffn": cfg.d_ff, "experts": cfg.experts},
                dtype)
        else:
            p[f"b{i}_mlp"] = F.init_mlp(
                gen, {"embed": e, "ffn": cfg.d_ff, "gated": cfg.gated},
                dtype)
        return p
    if block.kind == "rwkv":
        return {
            f"b{i}_ln1": zeros(),
            f"b{i}_tm": R.init_rwkv_time_mix(
                gen, {"embed": e, "heads": cfg.heads,
                      "head_dim": cfg.resolved_head_dim}, dtype),
            f"b{i}_ln2": zeros(),
            f"b{i}_cm": R.init_rwkv_channel_mix(
                gen, {"embed": e, "ffn": cfg.d_ff}, dtype),
        }
    if block.kind in ("mamba", "shared_attn"):
        # shared_attn reads its attention and mlp from the root "shared"
        return {f"b{i}_ln1": zeros(),
                f"b{i}_mamba": M.init_mamba2(gen, _mamba_cfg(cfg), dtype)}
    raise ValueError(block.kind)


def _init_shared(gen, cfg: ModelConfig, dtype) -> dict:
    """The hybrid family's weight-shared attention block (root scope)."""
    e = cfg.d_model
    zeros = lambda: {"scale": torch.zeros(  # noqa: E731
        (e,), dtype=dtype, device=gen.device)}
    return {"ln1": zeros(),
            "attn": A.init_attention(gen, _attn_cfg(cfg), dtype),
            "ln2": zeros(),
            "mlp": F.init_mlp(gen, {"embed": e, "ffn": cfg.d_ff,
                                    "gated": cfg.gated}, dtype)}


def _block_specs(cfg: ModelConfig, block: Block, i: int) -> dict:
    """The dim names of :func:`_init_block`'s leaves."""
    norm = {"scale": ("embed",)}
    if block.kind in ("attn_mlp", "attn_moe"):
        s = {f"b{i}_ln1": norm,
             f"b{i}_attn": A.attention_specs(_attn_cfg(cfg))}
        if block.cross:
            s[f"b{i}_lnx"] = norm
            s[f"b{i}_xattn"] = A.attention_specs(_attn_cfg(cfg))
        s[f"b{i}_ln2"] = norm
        if block.kind == "attn_moe":
            s[f"b{i}_moe"] = X.moe_specs()
        else:
            s[f"b{i}_mlp"] = F.mlp_specs({"gated": cfg.gated})
        return s
    if block.kind == "rwkv":
        return {f"b{i}_ln1": norm, f"b{i}_tm": R.rwkv_time_mix_specs(),
                f"b{i}_ln2": norm, f"b{i}_cm": R.rwkv_channel_mix_specs()}
    if block.kind in ("mamba", "shared_attn"):
        return {f"b{i}_ln1": norm, f"b{i}_mamba": M.mamba2_specs()}
    raise ValueError(block.kind)


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


def train_state_from_numpy(state, device="cpu") -> TrainState:
    """The reference's ``TrainState`` with numpy leaves (its ``step``,
    ``params``, ``opt_state``) as the port's, on ``device``."""
    return TrainState(*(params_from_numpy(t, device) for t in (
        state.step, state.params, state.opt_state)))


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
        return self._init(gen, cast=False)

    def init_inference_params(self, gen: torch.Generator) -> dict:
        """``inference_params(init_params(gen))``, bitwise, without the
        float32 tree: the same draws in the same order, each layer's
        ``_CAST`` leaves cast to the activation dtype as the layer is
        copied into its stack.  The peak is the cast tree plus one float32
        layer (llava-next-34b: 70.6 GB against 137.6 GB for the float32
        tree)."""
        return self._init(gen, cast=True)

    def _init(self, gen, *, cast: bool) -> dict:
        cfg = self.cfg
        params: dict = {"embed": E.init_embedding(
            gen, cfg.padded_vocab, cfg.d_model, self.pdtype,
            tied=cfg.tied_embeddings)}
        if cfg.family == "hybrid":
            shared = _init_shared(gen, cfg, self.pdtype)
            params["shared"] = self.inference_params(shared) if cast \
                else shared
        for g in self.groups:
            def layer(g=g):
                lp: dict = {}
                for i, blk in enumerate(g.blocks):
                    lp.update(_init_block(gen, cfg, blk, i, self.pdtype))
                return self.inference_params(lp) if cast else lp
            params[g.name] = stack_layers(layer, g.count)
        params["final_norm"] = {"scale": torch.zeros(
            (cfg.d_model,), dtype=self.pdtype, device=gen.device)}
        if cfg.family == "encdec":
            params["enc_norm"] = {"scale": torch.zeros(
                (cfg.d_model,), dtype=self.pdtype, device=gen.device)}
        return params

    def param_specs(self) -> dict:
        """The reference's specs tree: each leaf's tuple of semantic dim
        names (``("layers", "embed", "heads_flat")`` ...), keyed as the
        parameters.  Plain Python: no tensor is made, so it serves the
        largest configs."""
        cfg = self.cfg
        norm = {"scale": ("embed",)}
        specs: dict = {"embed": E.embedding_specs(tied=cfg.tied_embeddings)}
        if cfg.family == "hybrid":
            specs["shared"] = {
                "ln1": norm, "attn": A.attention_specs(_attn_cfg(cfg)),
                "ln2": norm, "mlp": F.mlp_specs({"gated": cfg.gated})}
        for g in self.groups:
            layer: dict = {}
            for i, blk in enumerate(g.blocks):
                layer.update(_block_specs(cfg, blk, i))
            specs[g.name] = stack_specs(layer)
        specs["final_norm"] = norm
        if cfg.family == "encdec":
            specs["enc_norm"] = norm
        return specs

    def abstract_params(self) -> dict:
        """The parameter tree as meta tensors: every leaf's shape and dtype,
        nothing drawn and no memory allocated."""
        return self._init(META, cast=False)

    def input_specs(self, shape) -> dict:
        """The inputs of a ``ShapeConfig`` cell as meta tensors, named,
        shaped and typed as the reference's ``input_specs``: a decode cell's
        ``tokens`` (B, 1) and scalar ``index``; else ``tokens`` (B, S) (the
        vlm's text after its ``frontend_tokens`` prefix), the vlm's and
        encdec's ``frontend_embeds`` in the activation dtype, and a train
        cell's ``labels`` (B, S).  Nothing is allocated."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"tokens": spec((b, 1)), "index": spec(())}
        if cfg.family == "encdec":
            out = {"frontend_embeds": spec((b, s, cfg.d_model), self.dtype),
                   "tokens": spec((b, s))}
        elif cfg.frontend != "none":
            out = {"frontend_embeds": spec((b, cfg.frontend_tokens,
                                            cfg.d_model), self.dtype),
                   "tokens": spec((b, s - cfg.frontend_tokens))}
        else:
            out = {"tokens": spec((b, s))}
        if shape.kind == "train":
            out["labels"] = spec((b, s))
        return out

    def inference_params(self, params: dict) -> dict:
        """``params`` with every parameter the layers cast per call (the
        ``_CAST`` names: projections and expert weights, the rwkv mixes and
        LoRA, the mamba conv and skip) cast to the activation dtype once.
        The reference casts them per call (``w.astype(x.dtype)``); the
        values are the same, without a cast of every matrix at every step.
        Norm scales, the embedding table and the parameters the layers read
        in float32 (``w0``, ``u``, ``a_log``, ``dt_bias``, the moe
        ``router``) keep their dtype."""
        def cast(tree):
            return {k: cast(v) if isinstance(v, dict)
                    else v.to(self.dtype) if k in _CAST else v
                    for k, v in tree.items()}
        return cast(params)

    # -- logical plan ---------------------------------------------------------
    def _block_nodes(self, sub: Plan, x: str, i: int, blk: Block,
                     emit_kv: bool = False) -> str:
        cfg = self.cfg
        pp = "b" + str(i)

        def norm(src, name):
            return sub.add("rmsnorm", [src], {"pp": (f"{pp}_{name}",)})

        if blk.kind in ("attn_mlp", "attn_moe"):
            h = norm(x, "ln1")
            att = sub.add("attention", [h], {
                "pp": (f"{pp}_attn",), **_attn_cfg(cfg),
                "causal": blk.causal, "window": blk.window,
                "rope_theta": cfg.rope_theta,
                **({"emit_kv": True} if emit_kv else {})})
            x = sub.add("residual_add", [x, att])
            if blk.cross:
                hx = norm(x, "lnx")
                xa = sub.add("cross_attention", [hx, "memory"], {
                    "pp": (f"{pp}_xattn",), **_attn_cfg(cfg)})
                x = sub.add("residual_add", [x, xa])
            h = norm(x, "ln2")
            if blk.kind == "attn_moe":
                m = sub.add("moe", [h], {
                    "pp": (f"{pp}_moe",), "ffn": cfg.d_ff,
                    "experts": cfg.experts, "top_k": cfg.top_k,
                    "act": cfg.act, "embed": cfg.d_model,
                    "pin_moe": cfg.pin_moe_layout})
            else:
                m = sub.add("mlp", [h], {
                    "pp": (f"{pp}_mlp",), "ffn": cfg.d_ff,
                    "gated": cfg.gated, "act": cfg.act,
                    "embed": cfg.d_model})
            return sub.add("residual_add", [x, m])
        if blk.kind == "rwkv":
            h = norm(x, "ln1")
            tm = sub.add("wkv6", [h], {
                "pp": (f"{pp}_tm",), "heads": cfg.heads,
                "head_dim": cfg.resolved_head_dim})
            x = sub.add("residual_add", [x, tm])
            h = norm(x, "ln2")
            cm = sub.add("rwkv_channel_mix", [h],
                         {"pp": (f"{pp}_cm",), "ffn": cfg.d_ff})
            return sub.add("residual_add", [x, cm])
        if blk.kind in ("mamba", "shared_attn"):
            h = norm(x, "ln1")
            mb = sub.add("ssd", [h], {
                "pp": (f"{pp}_mamba",), "heads":
                    cfg.expand * cfg.d_model // cfg.mamba_head_dim,
                "head_dim": cfg.mamba_head_dim, "state": cfg.ssm_state,
                "expand": cfg.expand, "embed": cfg.d_model})
            x = sub.add("residual_add", [x, mb])
            if blk.kind == "shared_attn":
                h = sub.add("rmsnorm", [x], {"pp": ("shared", "ln1"),
                                             "shared": True})
                att = sub.add("attention", [h], {
                    "pp": ("shared", "attn"), "shared": True,
                    **_attn_cfg(cfg), "causal": True, "window": 0,
                    "rope_theta": cfg.rope_theta})
                x = sub.add("residual_add", [x, att])
                h = sub.add("rmsnorm", [x], {"pp": ("shared", "ln2"),
                                             "shared": True})
                m = sub.add("mlp", [h], {
                    "pp": ("shared", "mlp"), "shared": True,
                    "ffn": cfg.d_ff, "gated": cfg.gated, "act": cfg.act,
                    "embed": cfg.d_model})
                x = sub.add("residual_add", [x, m])
            return x
        raise ValueError(blk.kind)

    def _group_subplan(self, g: Group, batch: int, seq: int,
                       with_memory: bool = False,
                       emit_kv: bool = False) -> Plan:
        cfg = self.cfg
        sub = Plan(name=f"{cfg.name}_{g.name}")
        sub.add_input("h", TensorT((batch, seq, cfg.d_model), cfg.dtype,
                                   ("batch", "seq", "embed")))
        if with_memory:
            sub.add_input("memory", TensorT((batch, seq, cfg.d_model),
                                            cfg.dtype,
                                            ("batch", "seq", "embed")))
        x = "h"
        for i, blk in enumerate(g.blocks):
            x = self._block_nodes(sub, x, i, blk, emit_kv=emit_kv)
        sub.set_outputs(x)
        return sub

    def supports_prefill_kv(self) -> bool:
        """True when the whole serving cache is attention K/V — i.e. a
        ``prefill_kv`` plan captures the entire decode state.  The
        recurrent families (rwkv, hybrid) carry state the planned forward
        does not expose: the serving runtime rebuilds it by replaying the
        prompt through the decode step.  The vlm and encdec families take
        ``frontend_embeds``, which no serving path supplies: the runtime
        refuses them."""
        return self.cfg.family in ("dense", "moe") and \
            self.cfg.frontend == "none"

    def build_plan(self, batch: int, seq: int, mode: str = "train") -> Plan:
        """The workload's logical plan.  ``mode="prefill_kv"`` is the
        serving prefill: like ``prefill`` but every attention carries
        ``emit_kv`` and every scan group collects the per-layer K/V as an
        extra plan output — (logits, kv_g0, kv_g1, ...) — so the KV cache is
        seeded directly from the planned forward.  A vlm plan takes
        ``frontend_embeds`` (batch, frontend_tokens, d_model) and the
        ``seq - frontend_tokens`` text tokens, joined by ``concat_seq``;
        an encdec plan is :meth:`_build_encdec_plan`'s."""
        cfg = self.cfg
        collect_kv = mode == "prefill_kv"
        if collect_kv and not self.supports_prefill_kv():
            raise ValueError(
                f"prefill_kv plans need an attention-only decode state; "
                f"{cfg.name} (family={cfg.family}, frontend={cfg.frontend}) "
                f"carries recurrent/frontend state — use mode='prefill' and "
                f"decode replay")
        if cfg.family == "encdec":
            return self._build_encdec_plan(batch, seq, mode)
        plan = Plan(name=f"{cfg.name}-{mode}")
        n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
        tokens = plan.add_input("tokens", TensorT((batch, seq - n_front),
                                                  "int32", ("batch", "seq")))
        x = plan.add("embed", [tokens], {
            "pp": ("embed",), "vocab": cfg.vocab, "embed": cfg.d_model,
            "dtype": cfg.dtype, "scale": cfg.embed_scale})
        if n_front:
            front = plan.add_input(
                "frontend_embeds",
                TensorT((batch, n_front, cfg.d_model), cfg.dtype,
                        ("batch", "seq", "embed")))
            x = plan.add("concat_seq", [front, x], {"axis": 1})
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

    def _build_encdec_plan(self, batch: int, seq: int, mode: str) -> Plan:
        """The encoder over ``frontend_embeds`` (batch, seq, d_model), its
        output normed by ``enc_norm`` and passed to every decoder layer as
        the scan's broadcast ``memory``; the decoder over ``tokens``
        (batch, seq).  Its scans carry no ``unroll`` attr, as the
        reference's."""
        cfg = self.cfg
        plan = Plan(name=f"{cfg.name}-{mode}")
        frames = plan.add_input(
            "frontend_embeds", TensorT((batch, seq, cfg.d_model), cfg.dtype,
                                       ("batch", "seq", "embed")))
        enc_g, dec_g = self.groups
        enc_sub = self._group_subplan(enc_g, batch, seq)
        mem = plan.add("scan_layers", [frames], {
            "n_layers": enc_g.count, "pp": (enc_g.name,),
            "param_group": enc_g.name, "remat": cfg.remat}, subplan=enc_sub)
        mem = plan.add("rmsnorm", [mem], {"pp": ("enc_norm",)})
        tokens = plan.add_input("tokens", TensorT((batch, seq), "int32",
                                                  ("batch", "seq")))
        x = plan.add("embed", [tokens], {
            "pp": ("embed",), "vocab": cfg.vocab, "embed": cfg.d_model,
            "dtype": cfg.dtype, "scale": cfg.embed_scale})
        dec_sub = self._group_subplan(dec_g, batch, seq, with_memory=True)
        x = plan.add("scan_layers", [x, mem], {
            "n_layers": dec_g.count, "pp": (dec_g.name,),
            "param_group": dec_g.name, "remat": cfg.remat}, subplan=dec_sub)
        x = plan.add("rmsnorm", [x], {"pp": ("final_norm",)})
        logits = plan.add("unembed", [x], {"pp": ("embed",),
                                           "vocab": cfg.padded_vocab,
                                           "true_vocab": cfg.vocab})
        if mode == "train":
            labels = plan.add_input("labels", TensorT((batch, seq), "int32",
                                                      ("batch", "seq")))
            loss = plan.add("softmax_xent", [logits, labels])
            plan.set_outputs(plan.add("store", [loss]))
        else:
            plan.set_outputs(plan.add("store", [logits]))
        return plan


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
