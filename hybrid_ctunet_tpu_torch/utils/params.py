"""Weights across the two packages, and seeded random init.

The port's modules carry the reference PyTorch state-dict keys, so
``hybrid_ctunet_tpu.utils.torch_import.convert_{tunet,cunet,ctunet}`` of a
port ``state_dict()`` (as numpy) is the JAX parameter tree. The
``*_state_dict_from_jax`` functions here are their inverses, in numpy,
without jax:

  Linear  kernel (in, out)               -> weight (out, in)
  Conv3d  kernel (k0, k1, k2, Cin, Cout) -> weight (Cout, Cin, k0, k1, k2)
  ConvT3d kernel (k0, k1, k2, Cin, Cout) -> weight (Cin, Cout, k0, k1, k2)
  LayerNorm scale/bias                   -> weight/bias
  BatchNorm scale/bias (``params``), mean/var (``batch_stats``)
                                         -> weight/bias, running_mean/var
                                            (num_batches_tracked 0: the JAX
                                            package keeps no count)
  blocks stacked on a leading depth axis (the JAX package's nn.scan layout:
  ``vit/blocks``, ``convnet/layer{s}_tail/block``) or one node per block
  (``vit/block{i}``, ``convnet/layer{s}_block{b}``) -> one key per block

BatchNorm keys are named after the port's owners: ``norm1``-``norm3`` of a
ResBlock or Bottleneck and the ResNet stem, ``downsample.1`` of a
Bottleneck's projection (the JAX ``downsample_norm``).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _lin(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (4, 3, 0, 1, 2)))


def _convT(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 4, 0, 1, 2)))


class _Out:
    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def put(self, key, value):
        if key in self.sd:
            raise KeyError(f"duplicate key {key}")
        self.sd[key] = np.array(value, dtype=np.float32)  # an owned, writable copy

    def ln(self, dst, node):
        self.put(f"{dst}.weight", node["scale"])
        self.put(f"{dst}.bias", node["bias"])

    def dense(self, dst, node):
        self.put(f"{dst}.weight", _lin(node["kernel"]))
        if "bias" in node:
            self.put(f"{dst}.bias", node["bias"])

    def conv(self, dst, node):
        self.put(f"{dst}.weight", _conv(node["kernel"]))
        if "bias" in node:
            self.put(f"{dst}.bias", node["bias"])

    def ffn(self, dst, node):
        self.ln(f"{dst}.net.0", node["norm"])
        self.dense(f"{dst}.net.1", node["fc1"])
        self.dense(f"{dst}.net.4", node["fc2"])

    def window_attn(self, dst, node):
        self.ln(f"{dst}.norm", node["norm"])
        self.dense(f"{dst}.to_qkv", node["to_qkv"])
        self.put(f"{dst}.rel_pos_bias.weight", node["rel_pos_bias"])
        self.dense(f"{dst}.to_out.0", node["to_out"])

    def norm(self, dst, node, stats, name):
        """A BatchNorm's parameters and running statistics; nothing for an
        InstanceNorm site, which has neither."""
        if name not in node:
            return
        self.put(f"{dst}.weight", node[name]["scale"])
        self.put(f"{dst}.bias", node[name]["bias"])
        self.put(f"{dst}.running_mean", stats[name]["mean"])
        self.put(f"{dst}.running_var", stats[name]["var"])
        self.put(f"{dst}.num_batches_tracked", 0)

    def resblock(self, dst, node, stats=None):
        for name in ("conv1", "conv2", "conv3"):
            if name in node:
                self.conv(f"{dst}.{name}.conv", node[name])
        for name in ("norm1", "norm2", "norm3"):
            self.norm(f"{dst}.{name}", node, stats, name)

    def head(self, dst, node):
        self.conv(f"{dst}.conv.conv", node["conv"])

    def transp(self, dst, node):
        self.put(f"{dst}.transp_conv.conv.weight", _convT(node["transp_conv"]["kernel"]))

    def pixelweight(self, dst, node):
        self.ln(f"{dst}.norm1", node["norm1"])
        self.ln(f"{dst}.norm2", node["norm2"])
        self.dense(f"{dst}.to_qkv1", node["to_qkv1"])
        self.dense(f"{dst}.to_qkv2", node["to_qkv2"])
        self.dense(f"{dst}.to_out.0", node["to_out"])

    def resnet(self, dst, node, stats=None):
        stats = stats or {}
        self.conv(f"{dst}.conv1.conv", node["conv1"])
        self.norm(f"{dst}.norm1", node, stats, "norm1")
        stage = 1
        while f"layer{stage}_block0" in node:
            blocks = [(node[f"layer{stage}_block0"], stats.get(f"layer{stage}_block0"))]
            tail = node.get(f"layer{stage}_tail")
            if tail is not None:
                depth = np.asarray(tail["block"]["conv1"]["kernel"]).shape[0]
                tail_stats = stats.get(f"layer{stage}_tail", {}).get("block")
                blocks += [(_index_tree(tail["block"], i),
                            None if tail_stats is None else _index_tree(tail_stats, i))
                           for i in range(depth)]
            else:
                b = 1
                while f"layer{stage}_block{b}" in node:
                    blocks.append((node[f"layer{stage}_block{b}"],
                                   stats.get(f"layer{stage}_block{b}")))
                    b += 1
            for b, (blk, st) in enumerate(blocks):
                base = f"{dst}.layer{stage}.{b}"
                for j in (1, 2, 3):
                    self.conv(f"{base}.conv{j}.conv", blk[f"conv{j}"])
                    self.norm(f"{base}.norm{j}", blk, st, f"norm{j}")
                if "downsample_conv" in blk:
                    self.conv(f"{base}.downsample.0.conv", blk["downsample_conv"])
                    self.norm(f"{base}.downsample.1", blk, st, "downsample_norm")
            stage += 1

    def res_heads(self, tree):
        for name in ("res_out", "res_out_48x48", "res_out_24x24"):
            self.head(name, tree[name])


def _index_tree(node, i):
    if isinstance(node, Mapping):
        return {k: _index_tree(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _tunet_core(out: _Out, core: Mapping, stats: Mapping) -> None:
    """The ViT branch, which TUNet and CTUNet key alike (at the top level)."""
    vit = core["vit"]
    out.ln("vit.to_patch_embedding.1", vit["patch_norm1"])
    out.dense("vit.to_patch_embedding.2", vit["patch_proj"])
    out.ln("vit.to_patch_embedding.3", vit["patch_norm2"])
    out.put("vit.pos_embedding", vit["pos_embedding"])
    if "blocks" in vit:
        depth = np.asarray(vit["blocks"]["attn"]["norm"]["scale"]).shape[0]
        blocks = [_index_tree(vit["blocks"], i) for i in range(depth)]
    else:
        blocks = [vit[f"block{i}"] for i in range(sum(k.startswith("block") for k in vit))]
    for i, b in enumerate(blocks):
        dst = f"vit.transformer.{i}"
        out.ln(f"{dst}.attn.norm", b["attn"]["norm"])
        out.dense(f"{dst}.attn.to_qkv", b["attn"]["to_qkv"])
        if "to_out" in b["attn"]:
            out.dense(f"{dst}.attn.to_out.0", b["attn"]["to_out"])
        out.ffn(f"{dst}.ff", b["ff"])

    enc = core["vit_encoder"]
    for ind in range(4):
        base = f"vit_encoder.layers.{ind}.0"
        if ind <= 2:
            out.window_attn(f"{base}.1.fn", enc[f"stage{ind}_block_attn"])
            out.ffn(f"{base}.2.fn", enc[f"stage{ind}_block_ff"])
            out.window_attn(f"{base}.5.fn", enc[f"stage{ind}_grid_attn"])
            out.ffn(f"{base}.6.fn", enc[f"stage{ind}_grid_ff"])
            shuffle = f"{base}.8"
        else:
            out.ffn(f"{base}.1.fn", enc[f"stage{ind}_ff1"])
            out.ffn(f"{base}.2.fn", enc[f"stage{ind}_ff2"])
            shuffle = f"{base}.4"
        out.dense(f"{shuffle}.to_out", enc[f"stage{ind}_shuffle"]["to_out"])

    out.resblock("vit_encoder0.layer", core["vit_encoder0"], stats.get("vit_encoder0"))
    out.resblock("vit_decoder0.conv_block", core["vit_decoder0"]["conv_block"],
                 stats.get("vit_decoder0", {}).get("conv_block"))
    out.dense("decoder_linear_96x96.head", core["decoder_linear_96x96"])
    out.head("vit_out", core["vit_out"])


def _split(tree: Mapping):
    """(params, batch_stats) of a variables dict (``{"params": ...,
    "batch_stats": ...}``) or of a bare parameter tree (no statistics)."""
    if "params" in tree:
        return tree["params"], tree.get("batch_stats") or {}
    return tree, {}


def _decoder_stats(stats: Mapping, name: str, block: str) -> Mapping:
    return stats.get(name, {}).get(block)


def tunet_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """JAX TUNet variables (``{"params": {"core": ...}[, "batch_stats":
    ...]}``) or parameter tree (``{"core": ...}``), leaves array-like ->
    reference/port state dict of float32 numpy arrays."""
    params, stats = _split(tree)
    out = _Out()
    _tunet_core(out, params["core"], stats.get("core", {}))
    return out.sd


def cunet_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """JAX CUNet variables or parameter tree -> reference/port state dict
    (the inverse of ``convert_cunet``)."""
    tree, stats = _split(tree)
    out = _Out()
    out.resnet("convnet", tree["convnet"], stats.get("convnet"))
    for k in (3, 2, 1, 0):
        node = tree[f"res_decoder{k}"]
        out.transp(f"res_decoder{k}", node)
        out.resblock(f"res_decoder{k}.conv_block", node["conv_block"],
                     _decoder_stats(stats, f"res_decoder{k}", "conv_block"))
    out.res_heads(tree)
    return out.sd


def ctunet_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """JAX CTUNet variables or parameter tree -> reference/port state dict
    (the inverse of ``convert_ctunet``): the ViT branch from ``core`` to the
    top level."""
    tree, stats = _split(tree)
    out = _Out()
    _tunet_core(out, tree["core"], stats.get("core", {}))
    out.resnet("convnet", tree["convnet"], stats.get("convnet"))
    for k in (3, 2, 1):
        dst, node = f"res_decoder{k}", tree[f"res_decoder{k}"]
        out.transp(dst, node)
        for i in (1, 2):
            out.pixelweight(f"{dst}.pixelweight_attention{i}", node[f"pixelweight_attention{i}"])
            out.resblock(f"{dst}.up_addconv_block{i}", node[f"up_addconv_block{i}"],
                         _decoder_stats(stats, dst, f"up_addconv_block{i}"))
    out.transp("res_decoder0", tree["res_decoder0"])
    out.resblock("res_decoder0.conv_block", tree["res_decoder0"]["conv_block"],
                 _decoder_stats(stats, "res_decoder0", "conv_block"))
    out.res_heads(tree)
    return out.sd


def load_numpy_state_dict(model: nn.Module, sd: Mapping[str, np.ndarray]) -> None:
    """``load_state_dict(strict=True)`` from numpy arrays onto the model's
    device (params stay fp32)."""
    device = next(model.parameters()).device
    model.load_state_dict(
        {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in sd.items()},
        strict=True,
    )


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from ``seed`` with the JAX package's init
    distributions: Linear weights N(0, 1/fan_in), conv and transposed-conv
    weights N(0, 2/fan_in) (fan_in = k^3 Cin for both: a transposed conv's
    weight is (Cin, Cout, k, k, k)), LayerNorm scale 1, biases 0, position
    embedding and relative-position tables N(0, 1). Draws on the
    parameters' device."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("pos_embedding") or name.endswith("rel_pos_bias.weight"):
            p.normal_(0.0, 1.0, generator=gen)
        elif name.endswith(".bias"):
            p.zero_()
        elif p.ndim == 1:  # LayerNorm scale
            p.fill_(1.0)
        elif p.ndim == 5 and name.endswith("transp_conv.conv.weight"):  # (Cin, Cout, k, k, k)
            p.normal_(0.0, math.sqrt(2.0 / (p.shape[0] * p[0, 0].numel())), generator=gen)
        elif p.ndim == 5:  # conv (Cout, Cin, k, k, k)
            p.normal_(0.0, math.sqrt(2.0 / (p[0].numel())), generator=gen)
        elif p.ndim == 2:  # Linear (out, in)
            p.normal_(0.0, math.sqrt(1.0 / p.shape[1]), generator=gen)
        else:
            raise ValueError(f"no init rule for {name} {tuple(p.shape)}")
    return model
