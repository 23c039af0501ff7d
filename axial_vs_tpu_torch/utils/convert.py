"""JAX package variables -> the port's ``state_dict``.

``convert_variables`` takes ``{"params", "batch_stats"}`` of
``axial_vs_tpu.models.kmax.build_segmenter`` as nested dicts of numpy arrays
and returns the ``state_dict`` of ``axial_vs_tpu_torch.models.kmax``'s
segmenter (the upstream torch layout). It is the inverse of
``axial_vs_tpu/utils/torch_convert.py::convert_maxtron_wc``; ``resnet``,
``swin`` and ``stdc`` are the inverses of its ``convert_torchvision_resnet``,
``convert_swin`` and ``convert_stdc``, and ``backbone`` picks one of them
(or ``convnext``) by the tree's keys. ``tube_link_vis`` maps
``axial_vs_tpu.models.tube_link.detector.TubeLinkVIS``'s variables, whose
names the port mirrors (``layer{i}_attn`` -> ``layers.{i}.attn``), and
``tube_link_vps``, ``tube_link_video_vis`` and ``image_mask2former`` those
of the other Tube-Link models, each under the JAX module's names;
``maxtron_cc`` maps ``axial_vs_tpu.models.maxtron_cc.MaXTronCCModel``'s
(the segmenter and the CC module, whose names follow the upstream module:
``trajectory_attn{i}`` -> ``transformer_trajectory_self_attention_layers.
{i}.self_attn``, ``aspp{i}`` -> ``conv_short_aggregate_layers.{i}``), and
``prepare_cc_weights`` is the WC -> CC surgery on a port state_dict, and
``wc_to_cc`` seeds a CC model with a trained WC segmenter. Layout
changes:

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
    """A ConvBN's conv and its norm: a BatchNorm where the batch stats hold
    its statistics, else a LayerNorm."""
    out = _prefix("conv", _conv(p["conv"]))
    if "norm" in p:
        out.update(_prefix("norm", _bn(p["norm"], s["norm"]) if "norm" in s
                           else _norm(p["norm"])))
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
    """A ConvNeXt block; a ConvNeXtV2 block (``grn`` in the tree) has the
    upstream ``grn.gamma`` / ``grn.beta`` and no layer scale ``gamma``."""
    sd = {**_prefix("conv_dw", _conv(p["dwconv"])),
          **_prefix("norm", _norm(p["norm"])),
          **_prefix("mlp.fc1", _linear(p["pwconv1"])),
          **_prefix("mlp.fc2", _linear(p["pwconv2"]))}
    if "grn" in p:
        sd.update({f"grn.{k}": np.asarray(p["grn"][k]).reshape(-1)
                   for k in ("gamma", "beta")})
    else:
        sd["gamma"] = np.asarray(p["gamma"])
    return sd


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


def resnet(params, stats) -> dict:
    """``params/batch_stats["backbone"]`` of a ResNet -> torchvision names."""
    def convbn(conv, bn, p, s):
        return {**_prefix(conv, _conv(p["conv"])),
                **_prefix(bn, _bn(p["norm"], s["norm"]))}

    sd = convbn("conv1", "bn1", params["stem"], stats["stem"])
    for key, bp in params.items():
        m = re.fullmatch(r"res(\d)_block(\d+)", key)
        if not m:
            continue
        pre = f"layer{int(m.group(1)) - 1}.{m.group(2)}"
        for name, cp in bp.items():
            i = name[4:]  # conv{i}
            sd.update(convbn(f"{pre}.downsample.0", f"{pre}.downsample.1",
                             cp, stats[key][name]) if name == "shortcut"
                      else convbn(f"{pre}.conv{i}", f"{pre}.bn{i}", cp,
                                  stats[key][name]))
    return sd


def swin_block(p) -> dict:
    """A Swin block: ``norm1``, ``attn`` (``qkv``, ``proj``, the bias
    table), ``norm2``, ``mlp_fc1`` / ``mlp_fc2`` -> ``mlp.fc1`` /
    ``mlp.fc2``."""
    attn = p["attn"]
    return {**_prefix("norm1", _norm(p["norm1"])),
            **_prefix("norm2", _norm(p["norm2"])),
            **_prefix("attn.qkv", _linear(attn["qkv"])),
            **_prefix("attn.proj", _linear(attn["proj"])),
            "attn.relative_position_bias_table": np.asarray(
                attn["relative_position_bias_table"]),
            **_prefix("mlp.fc1", _linear(p["mlp_fc1"])),
            **_prefix("mlp.fc2", _linear(p["mlp_fc2"]))}


def swin(params) -> dict:
    """``params["backbone"]`` of a Swin Transformer -> the upstream Swin
    names (the inverse of ``torch_convert.py::convert_swin``)."""
    sd = _prefix("patch_embed.proj", _conv(params["patch_embed"]))
    if "patch_norm" in params:
        sd.update(_prefix("patch_embed.norm", _norm(params["patch_norm"])))
    for key, p in params.items():
        m = re.fullmatch(r"stage(\d)_block(\d+)", key)
        if m:
            sd.update(_prefix(f"layers.{m.group(1)}.blocks.{m.group(2)}",
                              swin_block(p)))
            continue
        m = re.fullmatch(r"(merge_norm|merge_reduction|out_norm)(\d)", key)
        if m:
            kind, i = m.groups()
            sd.update(_prefix(
                f"norm{i}" if kind == "out_norm"
                else f"layers.{i}.downsample.norm" if kind == "merge_norm"
                else f"layers.{i}.downsample.reduction",
                _linear(p) if kind == "merge_reduction" else _norm(p)))
    return sd


def stdc(params, stats) -> dict:
    """``params/batch_stats["backbone"]`` of an STDC net -> the upstream
    names (the inverse of ``torch_convert.py::convert_stdc``): the stems
    ``x2.0.0`` / ``x4.0.1``, block j of stage i under ``x{8 << i}.0.{k}``
    with k counting the blocks from 2 across stages."""
    def convx(p, s):
        return {**_prefix("conv", _conv(p["conv"])),
                **_prefix("bn", _bn(p["bn"], s["bn"]))}

    def dw_norm(pre, p, s):
        return {**_prefix(f"{pre}.0", _conv(p["conv"])),
                **_prefix(f"{pre}.1", _bn(p["bn"], s["bn"]))}

    sd = {**_prefix("x2.0.0", convx(params["stem0"], stats["stem0"])),
          **_prefix("x4.0.1", convx(params["stem1"], stats["stem1"]))}
    blocks = sorted((tuple(map(int, m.groups())), key) for key in params
                    for m in [re.fullmatch(r"stage(\d)_block(\d+)", key)] if m)
    for k, ((i, _), key) in enumerate(blocks, 2):
        p, s = params[key], stats[key]
        pre = f"x{8 << i}.0.{k}"
        for name in p:
            if name.startswith("conv"):
                sd.update(_prefix(f"{pre}.conv_list.{name[4:]}",
                                  convx(p[name], s[name])))
        if "avd" in p:
            sd.update(_prefix(pre, dw_norm("avd_layer", p["avd"], s["avd"])))
        if "skip_dw" in p:
            sd.update(_prefix(pre, dw_norm("skip", p["skip_dw"], s["skip_dw"])))
            sd.update(_prefix(f"{pre}.skip.2", _conv(p["skip_pw"])))
            sd.update(_prefix(f"{pre}.skip.3", _bn(p["skip_bn"], s["skip_bn"])))
    return sd


def backbone(params, stats) -> dict:
    """Any ported backbone's ``params/batch_stats["backbone"]``: a ResNet
    (``stem``), an STDC net (``stem0``), a Swin (``patch_embed``) or a
    ConvNeXt."""
    if "stem" in params:
        return resnet(params, stats)
    if "stem0" in params:
        return stdc(params, stats)
    return swin(params) if "patch_embed" in params else convnext(params)


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
    """Either variant: separate ``q``, ``k``, ``v`` or one ``qkv``."""
    qkv = ("qkv",) if "qkv" in p else ("q", "k", "v")
    return {k: v for name in qkv + ("proj_q", "proj_kv", "proj")
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


_SEMANTIC_NAMES = {
    "low_level_projection_os8": "_low_level_projection_os8",
    "low_level_fusion_os8_conv0": "_low_level_fusion_os8_conv0_bn_act",
    "low_level_fusion_os8_conv1": "_low_level_fusion_os8_conv1_bn_act",
    "low_level_projection_os4": "_low_level_projection_os4",
    "low_level_fusion_os4_conv0": "_low_level_fusion_os4_conv0_bn_act",
    "low_level_fusion_os4_conv1": "_low_level_fusion_os4_conv1_bn_act",
    "conv_block_0": "conv_block_0",
    "conv_block_1": "conv_block_1",
    "final_conv": "final_conv",
}


def semantic_predictor(p, s) -> dict:
    """The auxiliary semantic head (``SemanticPredictor``, training only)."""
    a, sa = p["aspp"], s["aspp"]
    sd = {}
    for name in ("aspp_conv0", "aspp_conv1", "aspp_conv2", "aspp_conv3",
                 "aspp_pool"):
        sd.update(_prefix(f"_aspp._{name}", _convbn(a[name], sa[name])))
    sd.update(_prefix("_aspp._proj_conv_bn_act",
                      _convbn(a["proj_conv"], sa["proj_conv"])))
    for jax_name, torch_name in _SEMANTIC_NAMES.items():
        sd.update(_prefix(torch_name, _convbn(p[jax_name], s.get(jax_name, {}))))
    return sd


def transformer_decoder(params, stats) -> dict:
    """``params/batch_stats["transformer_decoder"]``, the semantic head's
    too where the tree has it (a training build)."""
    sd = {"_cluster_centers.weight": np.asarray(params["cluster_centers"]).T}
    if "auxiliary_semantic_predictor" in params:
        sd.update(_prefix("_auxiliary_semantic_predictor", semantic_predictor(
            params["auxiliary_semantic_predictor"],
            stats["auxiliary_semantic_predictor"])))
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
    sd = _prefix("backbone", backbone(params["backbone"],
                                      stats.get("backbone", {})))
    if "wc_module" in params:
        sd.update(_prefix("sem_seg_head.wc_module",
                          wc_module(params["wc_module"])))
    sd.update(_prefix("sem_seg_head.pixel_decoder", pixel_decoder(
        params["pixel_decoder"], stats.get("pixel_decoder", {}))))
    sd.update(_prefix("sem_seg_head.predictor", transformer_decoder(
        params["transformer_decoder"], stats.get("transformer_decoder", {}))))
    return sd


# ---- cross-clip model -------------------------------------------------------

def temporal_aspp(p) -> dict:
    """``TemporalASPP1D`` (no batch stats: its projection's norm is a
    LayerNorm)."""
    return {k: v for name, cp in p.items() for k, v in (
        _prefix("_proj_conv_bn_act", _convbn(cp, {})) if name == "proj_conv"
        else _prefix(f"_{name}", _conv(cp))).items()}


def cc_predictor(p, s) -> dict:
    """``MaXTronCCPredictor``."""
    sd = _prefix("_pixel_space_mask_batch_norm",
                 _bn(p["pixel_space_mask_batch_norm"],
                     s["pixel_space_mask_batch_norm"]))
    for name in ("transformer_class_activation_head", "transformer_class_head",
                 "transformer_mask_head"):
        sd.update(_prefix(f"_{name}", _convbn(p[name], s.get(name, {}))))
    return sd


def cc_module(params, stats) -> dict:
    """``params/batch_stats["cc_module"]`` of ``MaXTronCCModel``."""
    sd = {}
    for key, p in params.items():
        m = re.fullmatch(r"(trajectory_attn|attn_norm|aspp|conv_norm)(\d+)", key)
        if not m:
            if key not in ("class_embedding_projection",
                           "mask_embedding_projection", "predictor"):
                raise KeyError(f"unexpected cc_module entry {key!r}")
            continue
        kind, i = m.groups()
        layer = f"transformer_trajectory_self_attention_layers.{i}"
        if kind == "trajectory_attn":
            sd.update(_prefix(f"{layer}.self_attn", trajectory_attention(p)))
        elif kind == "attn_norm":
            sd.update(_prefix(f"{layer}.norm", _norm(p)))
        elif kind == "conv_norm":
            sd.update(_prefix(f"conv_norms.{i}", _norm(p)))
        else:
            sd.update(_prefix(f"conv_short_aggregate_layers.{i}",
                              temporal_aspp(p)))
    for name in ("class_embedding_projection", "mask_embedding_projection"):
        sd.update(_prefix(f"_{name}", _convbn(params[name], stats[name])))
    sd.update(_prefix("_predictor", cc_predictor(params["predictor"],
                                                 stats["predictor"])))
    return sd


def maxtron_cc(variables) -> dict:
    """``MaXTronCCModel`` variables {"params", "batch_stats"}, each with
    "segmenter" and "cc_module" -> the port's ``MaXTronCCModel``
    state_dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    seg = {"params": params["segmenter"],
           "batch_stats": stats.get("segmenter", {})}
    return {**_prefix("segmenter", convert_variables(seg)),
            **_prefix("cc_module", cc_module(params["cc_module"],
                                             stats.get("cc_module", {})))}


#: the transformer decoder's modules that the WC -> CC surgery clones into
#: the CC module, under the same names
CC_CLONED = ("_class_embedding_projection", "_mask_embedding_projection",
             "_predictor._transformer_mask_head",
             "_predictor._transformer_class_head",
             "_predictor._pixel_space_mask_batch_norm")


def prepare_cc_weights(state_dict: dict) -> dict:
    """WC -> CC init surgery on a port state_dict (counterpart of
    ``axial_vs_tpu/utils/torch_convert.py::prepare_cc_weights``): a copy of
    ``state_dict`` in which the final embedding projections and predictor
    heads of the segmenter's transformer decoder (``CC_CLONED``; parameters
    and running statistics) are also copied to ``cc_module.*``. The source
    is ``segmenter.sem_seg_head.predictor`` (a CC model's state_dict) or
    ``sem_seg_head.predictor`` (a WC segmenter's)."""
    src = ("segmenter.sem_seg_head.predictor."
           if any(k.startswith("segmenter.") for k in state_dict)
           else "sem_seg_head.predictor.")
    out = dict(state_dict)
    for key, value in state_dict.items():
        rest = key[len(src):]
        if key.startswith(src) and any(rest.startswith(name + ".")
                                       for name in CC_CLONED):
            out["cc_module." + rest] = (value.clone() if hasattr(value, "clone")
                                        else np.array(value, copy=True))
    return out


#: the WC training model's auxiliary semantic head: the frozen segmenter of
#: a CC model is built for inference and has none
_AUX_SEMANTIC = "._auxiliary_semantic_predictor."


def wc_to_cc(wc: dict, cc_state: dict) -> dict:
    """The state_dict of a CC model whose segmenter holds the weights of a
    trained WC segmenter, as the JAX CC tool seeds its run
    (``params["segmenter"] = wc["params"]``, ``tools/
    validate_overfit_cc.py:147-153``). ``wc``: a port WC segmenter's
    state_dict, or a JAX WC tree {"params", "batch_stats"} as numpy (what
    ``tools/validate_overfit.py --save-params`` writes). ``cc_state``: the
    CC model's own state_dict, whose ``cc_module.*`` entries are kept (its
    init); ``prepare_cc_weights`` of the result clones the segmenter's final
    projections and heads into them.

    Every key of ``wc`` must land in the segmenter, and every segmenter key
    must come from ``wc``, except the WC training model's auxiliary
    semantic head, which the frozen segmenter does not run (JAX's apply
    ignores those parameters); ``KeyError`` otherwise."""
    if "params" in wc:
        wc = convert_variables(wc)
    out = {f"segmenter.{k}": v for k, v in wc.items() if _AUX_SEMANTIC not in k}
    want = {k for k in cc_state if k.startswith("segmenter.")}
    missing, extra = sorted(want - set(out)), sorted(set(out) - want)
    if missing or extra:
        raise KeyError(f"not a WC segmenter of this CC model: missing "
                       f"{missing[:5]} extra {extra[:5]}")
    out.update({k: v for k, v in cc_state.items()
                if k.startswith("cc_module.")})
    return out


# ---- Tube-Link --------------------------------------------------------------

def tube_link_pixel_decoder(p) -> dict:
    """``params["head"]["pixel_decoder"]`` (no batch stats). A decoder
    without MaXTron's attention (``use_temporal`` false) has no
    ``level_3d_encoding`` and its layers no ``gamma`` or
    ``temporal_encoder``: its state_dict has none of those keys."""
    sd = {}
    for key, v in p.items():
        m = re.fullmatch(r"(input|lateral|output)_(conv|norm)(\d)", key)
        li = re.fullmatch(r"layer(\d+)_(\w+)", key)
        if m:
            kind, part, i = m.groups()
            name = (f"input_{part}s.{i}" if kind == "input"
                    else f"{kind}_{part}")
            sd.update(_prefix(name, _conv(v) if part == "conv" else _norm(v)))
        elif key in ("level_encoding", "level_3d_encoding"):
            sd[key] = np.asarray(v)
        elif key == "mask_feature":
            sd.update(_prefix(key, _conv(v)))
        elif li and li.group(2) == "attn":
            attn = msdeform_attn(v)
            if "temporal_encoder" in v:
                attn.update({"gamma": np.asarray(v["gamma"]), **_prefix(
                    "temporal_encoder", temporal_encoder(v["temporal_encoder"]))})
            sd.update(_prefix(f"layers.{li.group(1)}.attn", attn))
        elif li:
            i, name = li.groups()
            sd.update(_prefix(f"layers.{i}.{name}",
                              _norm(v) if name.startswith("norm")
                              else _linear(v)))
        else:
            raise KeyError(f"unexpected pixel_decoder entry {key!r}")
    return sd


def _attention(p) -> dict:
    return {k: v for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            for k, v in _prefix(name, _linear(p[name])).items()}


def tube_link_head(p) -> dict:
    """``params["head"]`` of ``Mask2FormerVideoHeadTube``."""
    sd = _prefix("pixel_decoder", tube_link_pixel_decoder(p["pixel_decoder"]))
    for key, v in p.items():
        li = re.fullmatch(r"layer(\d+)_(\w+)", key)
        if key in ("level_embed", "query_feat", "query_embed"):
            sd[key] = np.asarray(v)
        elif key == "post_norm":
            sd.update(_prefix(key, _norm(v)))
        elif key == "cls_embed" or key.startswith("mask_embed"):
            sd.update(_prefix(key, _linear(v)))
        elif li:
            i, name = li.groups()
            sd.update(_prefix(
                f"layers.{i}.{name}",
                _attention(v) if name.endswith("attn")
                else _norm(v) if name.startswith("norm") else _linear(v)))
        elif key != "pixel_decoder":
            raise KeyError(f"unexpected head entry {key!r}")
    return sd


def _tube_link_detector(variables, head: str = "head") -> tuple:
    """(params, the state_dict of the backbone and of the tube head under
    ``head``) of a Tube-Link model's variables."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    return params, {
        **_prefix("backbone", backbone(params["backbone"],
                                       stats.get("backbone", {}))),
        **_prefix(head, tube_link_head(params[head]))}


def _by_name(p, convert) -> dict:
    """Each entry of ``p`` through ``convert(name, entry)``, prefixed with
    its name."""
    return {k: v for name, sub in p.items()
            for k, v in _prefix(name, convert(name, sub)).items()}


def _norm_or_linear(name, p) -> dict:
    return _norm(p) if "scale" in p else _linear(p)


def tube_link_vis(variables) -> dict:
    """``TubeLinkVIS`` variables {"params", "batch_stats"} -> port
    state_dict."""
    return _tube_link_detector(variables)[1]


#: ``ImageMask2Former``'s variables: a backbone and a ``head``, as
#: ``TubeLinkVIS``'s
image_mask2former = tube_link_vis


def thing_query_link(p) -> dict:
    """``ThingQueryLink``: ``link_attn``, ``norm1``, ``ffn1``, ``ffn2``,
    ``norm2``."""
    return _by_name(p, lambda name, sub: _attention(sub)
                    if name == "link_attn" else _norm_or_linear(name, sub))


def tube_link_vps(variables) -> dict:
    """``TubeLinkVPS`` variables -> port state_dict: the
    detector's, ``thing_link`` (``link_attn``, ``norm1``, ``ffn1``,
    ``ffn2``, ``norm2``) and, unless ``mlp_only``, ``track_head`` (``fc0``,
    ``fc_out``)."""
    params, sd = _tube_link_detector(variables)
    sd.update(_prefix("thing_link", thing_query_link(params["thing_link"])))
    if "track_head" in params:
        sd.update(_prefix("track_head", _by_name(
            params["track_head"], _norm_or_linear)))
    return sd


def tube_link_video_vis(variables) -> dict:
    """``TubeLinkVideoVIS`` variables -> port state_dict: the frozen detector's (its head ``wc_head_wrapper``), ``cc_layers``
    (``trajectory_attn{i}``, ``attn_norm{i}``, ``aspp{i}``,
    ``conv_norm{i}``) and the heads ``activation_proj``, ``cls_embed``,
    ``mask_embed{1,2,3}``."""
    params, sd = _tube_link_detector(variables, "wc_head_wrapper")

    def cc_layer(name, p):
        if name.startswith("trajectory_attn"):
            return trajectory_attention(p)
        return temporal_aspp(p) if name.startswith("aspp") else _norm(p)

    sd.update(_prefix("cc_layers", _by_name(params["cc_layers"], cc_layer)))
    sd.update(_by_name({k: v for k, v in params.items() if k not in (
        "backbone", "wc_head_wrapper", "cc_layers")}, _norm_or_linear))
    return sd


def load_into(model, state_dict: dict):
    """Copy a state_dict of numpy arrays or tensors into ``model`` (strict:
    every key must match, and every shape)."""
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
            own[k].copy_(v if torch.is_tensor(v)
                         else torch.from_numpy(np.ascontiguousarray(v)))
    return model
