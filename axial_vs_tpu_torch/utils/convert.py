"""JAX package variables -> the port's ``state_dict``.

``convert_variables`` takes ``{"params", "batch_stats"}`` of
``axial_vs_tpu.models.kmax.build_segmenter`` as nested dicts of numpy arrays
and returns the ``state_dict`` of ``axial_vs_tpu_torch.models.kmax``'s
segmenter (the upstream torch layout). It is the inverse of
``axial_vs_tpu/utils/torch_convert.py::convert_maxtron_wc`` for a ConvNeXt
backbone. Layout changes:

- conv kernels HWIO (kh, kw, I, O) -> OIHW; 1-D (k, I, O) -> (O, I, k);
  a depthwise (7, 7, 1, C) -> (C, 1, 7, 7);
- Dense kernels (in, out) -> Linear weights (out, in);
- LayerNorm / GroupNorm / BatchNorm ``scale`` -> ``weight``; BatchNorm
  ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- the transformer decoder's cluster centers (N, 256) -> (256, N);
- a scan-stacked ConvNeXt stage (``stage{i}_blocks/block/...`` with a
  leading depth axis) is unstacked into one block per index.

The per-module functions below each return a flat dict with the module's
own keys, so a test can carry the weights of one submodule alone.
"""
from __future__ import annotations

import re

import numpy as np


def _prefix(prefix: str, d: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def _conv(p) -> dict:
    k = np.asarray(p["kernel"])
    w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.transpose(2, 1, 0)
    out = {"weight": w}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _linear(p) -> dict:
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _norm(p) -> dict:
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def _bn(p, s) -> dict:
    return {**_norm(p), "running_mean": np.asarray(s["mean"]),
            "running_var": np.asarray(s["var"])}


def _convbn(p, s) -> dict:
    out = _prefix("conv", _conv(p["conv"]))
    if "norm" in p:
        out.update(_prefix("norm", _bn(p["norm"], s["norm"])))
    return out


# ---- backbone -------------------------------------------------------------

def _unstack(tree, j):
    if isinstance(tree, dict):
        return {k: _unstack(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def convnext_block(p) -> dict:
    return {**_prefix("conv_dw", _conv(p["dwconv"])),
            **_prefix("norm", _norm(p["norm"])),
            **_prefix("mlp.fc1", _linear(p["pwconv1"])),
            **_prefix("mlp.fc2", _linear(p["pwconv2"])),
            "gamma": np.asarray(p["gamma"])}


def convnext(params) -> dict:
    """``params["backbone"]`` of a ConvNeXt (scan-stacked or not)."""
    sd = {**_prefix("stem.0", _conv(params["downsample0_conv"])),
          **_prefix("stem.1", _norm(params["downsample0_norm"]))}
    for key, p in params.items():
        m = re.fullmatch(r"downsample(\d)_(norm|conv)", key)
        if m and m.group(1) != "0":
            i, kind = m.groups()
            sub = "0" if kind == "norm" else "1"
            sd.update(_prefix(f"stages.{i}.downsample.{sub}",
                              _norm(p) if kind == "norm" else _conv(p)))
            continue
        m = re.fullmatch(r"stage(\d)_block(\d+)", key)
        if m:
            sd.update(_prefix(f"stages.{m.group(1)}.blocks.{m.group(2)}",
                              convnext_block(p)))
            continue
        m = re.fullmatch(r"stage(\d)_blocks", key)
        if m:
            stacked = p["block"]
            for j in range(_depth(stacked)):
                sd.update(_prefix(f"stages.{m.group(1)}.blocks.{j}",
                                  convnext_block(_unstack(stacked, j))))
            continue
        m = re.fullmatch(r"out_norm(\d)", key)
        if m:
            sd.update(_prefix(f"norm{m.group(1)}", _norm(p)))
    return sd


# ---- within-clip module ---------------------------------------------------

def msdeform_attn(p) -> dict:
    return {k: v for name in ("sampling_offsets", "attention_weights",
                              "value_proj", "output_proj")
            for k, v in _prefix(name, _linear(p[name])).items()}


def msda_encoder_layer(p) -> dict:
    sd = _prefix("self_attn", msdeform_attn(p["self_attn"]))
    for name in ("linear1", "linear2"):
        sd.update(_prefix(name, _linear(p[name])))
    for name in ("norm1", "norm2"):
        sd.update(_prefix(name, _norm(p[name])))
    return sd


def trajectory_attention(p) -> dict:
    return {k: v for name in ("q", "k", "v", "proj_q", "proj_kv", "proj")
            for k, v in _prefix(name, _linear(p[name])).items()}


def temporal_layer(p) -> dict:
    sd = {}
    for name in ("height_attn", "width_attn"):
        sd.update(_prefix(name, trajectory_attention(p[name])))
    for name in ("linear1", "linear2"):
        sd.update(_prefix(name, _linear(p[name])))
    for name in ("norm1", "norm2"):
        sd.update(_prefix(name, _norm(p[name])))
    return sd


def temporal_encoder(p) -> dict:
    sd = {}
    for key, lp in p.items():
        li = re.fullmatch(r"layer(\d+)", key).group(1)
        sd.update(_prefix(f"temporal_layers.{li}", temporal_layer(lp)))
    return sd


def wc_module(params) -> dict:
    """``params["wc_module"]`` (the module has no batch stats)."""
    sd = {}
    for key, p in params.items():
        m = re.fullmatch(r"(input|output)_proj(\d+)", key)
        if m:
            pre = f"{m.group(1)}_proj.{m.group(2)}"
            sd.update(_prefix(f"{pre}.0", _conv(p["conv"])))
            sd.update(_prefix(f"{pre}.1", _norm(p["norm"])))
        elif key in ("level_embed_2d", "level_embed_3d"):
            sd[f"transformer.{key}"] = np.asarray(p)
        elif key.startswith("spatial_layer"):
            sd.update(_prefix(
                f"transformer.encoder.spatial_layers.{key[13:]}",
                msda_encoder_layer(p)))
        elif key.startswith("temporal_encoder"):
            sd.update(_prefix(
                f"transformer.encoder.temporal_layers.{key[16:]}",
                temporal_encoder(p)))
        else:
            raise KeyError(f"unexpected wc_module entry {key!r}")
    return sd


# ---- pixel decoder --------------------------------------------------------

def axial_attention(p, s) -> dict:
    sd = {"qkv_transform.conv.weight": _conv(p["qkv_transform"]["conv"])["weight"]}
    for rpe in ("query_rpe", "key_rpe", "value_rpe"):
        sd[f"_{rpe}._embeddings.weight"] = np.asarray(p[rpe]["embeddings"])
    for bn in ("batch_norm_qkv", "batch_norm_similarity",
               "batch_norm_retrieved_output"):
        sd.update(_prefix(f"_{bn}", _bn(p[bn], s[bn])))
    return sd


def pixel_decoder(params, stats) -> dict:
    """``params/batch_stats["pixel_decoder"]``."""
    sd = {}
    for key, p in params.items():
        s = stats.get(key, {})
        if key.startswith("in_norm"):
            sd.update(_prefix(f"_in_norms.{key[7:]}", _norm(p)))
        elif key.startswith("resized_fuse"):
            for name, bp in p.items():
                sd.update(_prefix(f"_resized_fuses.{key[12:]}._{name}",
                                  _convbn(bp, s[name])))
        elif key.startswith("stage"):
            for bkey, bp in p.items():
                pre = f"_stages.{key[5:]}._blocks.{bkey[5:]}"
                bs = s[bkey]
                for name, cp in bp.items():
                    if name == "attention":
                        for axis in ("height_axis", "width_axis"):
                            sd.update(_prefix(
                                f"{pre}._attention._{axis}",
                                axial_attention(cp[axis], bs[name][axis])))
                    else:
                        sd.update(_prefix(f"{pre}._{name}",
                                          _convbn(cp, bs[name])))
        else:
            raise KeyError(f"unexpected pixel_decoder entry {key!r}")
    return sd


# ---- transformer decoder --------------------------------------------------

_PREDICTOR_NAMES = {
    "pixel_space_head_conv0": "_pixel_space_head_conv0bnact",
    "pixel_space_head_conv1": "_pixel_space_head_conv1bnact",
    "pixel_space_head_last_conv": "_pixel_space_head_last_convbn",
    "transformer_mask_head": "_transformer_mask_head",
    "transformer_class_head": "_transformer_class_head",
}
_LAYER_NAMES = {
    "query_conv1": "_query_conv1_bn_act",
    "pixel_conv1": "_pixel_conv1_bn_act",
    "query_qkv_conv": "_query_qkv_conv_bn",
    "pixel_v_conv": "_pixel_v_conv_bn",
    "kmeans_query_conv3": "_kmeans_query_conv3_bn",
    "query_conv3": "_query_conv3_bn",
    "query_ffn_conv1": "_query_ffn_conv1_bn_act",
    "query_ffn_conv2": "_query_ffn_conv2_bn",
}


def kmax_predictor(p, s) -> dict:
    sd = _prefix("_pixel_space_mask_batch_norm",
                 _bn(p["pixel_space_mask_batch_norm"],
                     s["pixel_space_mask_batch_norm"]))
    for jax_name, torch_name in _PREDICTOR_NAMES.items():
        sd.update(_prefix(torch_name, _convbn(p[jax_name], s.get(jax_name, {}))))
    return sd


def kmax_transformer_layer(p, s) -> dict:
    sd = _prefix("_predictor", kmax_predictor(p["predictor"], s["predictor"]))
    for jax_name, torch_name in _LAYER_NAMES.items():
        sd.update(_prefix(torch_name, _convbn(p[jax_name], s[jax_name])))
    for bn in ("batch_norm_similarity", "batch_norm_retrieved_value"):
        sd.update(_prefix(f"_query_self_attention._{bn}",
                          _bn(p["query_self_attention"][bn],
                              s["query_self_attention"][bn])))
    sd.update(_prefix("_kmeans_query_batch_norm_retrieved_value",
                      _bn(p["kmeans_query_batch_norm_retrieved_value"],
                          s["kmeans_query_batch_norm_retrieved_value"])))
    return sd


def transformer_decoder(params, stats) -> dict:
    """``params/batch_stats["transformer_decoder"]``."""
    sd = {"_cluster_centers.weight": np.asarray(params["cluster_centers"]).T}
    for name in ("class_embedding_projection", "mask_embedding_projection"):
        sd.update(_prefix(f"_{name}", _convbn(params[name], stats[name])))
    sd.update(_prefix("_predictor", kmax_predictor(params["predictor"],
                                                   stats["predictor"])))
    for key, p in params.items():
        m = re.fullmatch(r"layer(\d+)", key)
        if m:
            sd.update(_prefix(f"_kmax_transformer_layers.{m.group(1)}",
                              kmax_transformer_layer(p, stats[key])))
    return sd


def convert_variables(variables) -> dict:
    """Whole segmenter: {"params", "batch_stats"} -> port state_dict (numpy
    arrays; ``load_state_dict`` copies them into the model's dtypes)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = _prefix("backbone", convnext(params["backbone"]))
    if "wc_module" in params:
        sd.update(_prefix("sem_seg_head.wc_module",
                          wc_module(params["wc_module"])))
    sd.update(_prefix("sem_seg_head.pixel_decoder", pixel_decoder(
        params["pixel_decoder"], stats.get("pixel_decoder", {}))))
    sd.update(_prefix("sem_seg_head.predictor", transformer_decoder(
        params["transformer_decoder"], stats.get("transformer_decoder", {}))))
    return sd


def load_into(model, state_dict: dict):
    """Copy a numpy state_dict into ``model`` (strict: every key must match,
    and every shape)."""
    import torch

    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    extra = sorted(set(state_dict) - set(own))
    if missing or extra:
        raise KeyError(f"missing {missing[:5]} extra {extra[:5]}")
    with torch.no_grad():
        for k, v in state_dict.items():
            if tuple(own[k].shape) != tuple(np.shape(v)):
                raise ValueError(f"{k}: {tuple(np.shape(v))} != "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
    return model
