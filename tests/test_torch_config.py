"""The port's own config (``axial_vs_tpu_torch/config``) against the JAX
package's, which the port may not import: the defaults, the repo's VIPSeg
WC yamls merged in, dotted overrides; and chip_smoke.py's three config
builders, which give every value that their plain-object trees of earlier
versions gave."""
import importlib.util
from pathlib import Path

import pytest

from axial_vs_tpu.config import get_default_config as jax_defaults
from axial_vs_tpu_torch.config import (CONFIGS_DIR, ConfigNode,
                                       get_default_config, load_config)

ROOT = Path(__file__).resolve().parent.parent


def test_defaults_equal_jax():
    assert get_default_config().to_dict() == jax_defaults().to_dict()
    assert CONFIGS_DIR == ROOT / "configs"


@pytest.mark.parametrize("yaml", ["vipseg/maxtron_wc_r50.yaml",
                                  "vipseg/maxtron_wc_convnext_large.yaml"])
def test_merge_from_file_equals_jax(yaml):
    """Including the ConvNeXt-L yaml's ``_BASE_`` (the R50 yaml)."""
    want = jax_defaults()
    want.merge_from_file(str(ROOT / "configs" / yaml))
    got = load_config(yaml)
    assert got.to_dict() == want.to_dict()
    assert got.model.maxtron.wc.enable is True


def test_merge_from_list_parses_as_jax():
    """String overrides take the type of the value they replace (bool, int,
    float, list by YAML, str); non-strings are set as given; a frozen tree
    refuses, a clone does not."""
    opts = ["model.num_classes", "124", "solver.base_lr", "5e-5",
            "model.maxtron.wc.enable", "true", "input.image_size", "[713, 713]",
            "model.backbone.name", "resnet50", "model.dtype", "bfloat16",
            "solver.clip_gradients.enabled", "0", "seed", 3]
    want = jax_defaults().merge_from_list(list(opts))
    got = get_default_config().merge_from_list(list(opts))
    assert got.to_dict() == want.to_dict()
    assert (got.model.num_classes, got.input.image_size, got.seed) == (
        124, [713, 713], 3)
    assert got.model.maxtron.wc.enable is True
    assert got.solver.clip_gradients.enabled is False
    got.freeze()
    with pytest.raises(AttributeError):
        got.model.num_classes = 5
    clone = got.clone()
    clone.model.num_classes = 5
    assert isinstance(clone, ConfigNode) and got.model.num_classes == 124
    assert load_config(opts=opts).to_dict() == want.to_dict()


#: the leaves of chip_smoke.py's plain-object configs before the port had
#: its own config (``wc_convnext_large_config``, ``wc_r50_config``,
#: ``tube_link_r50_config``); the builders must still give each of them
_WC = {
    "input.num_clip_frames": 2, "input.image_size": [769, 1345],
    "model.num_classes": 124,
    "model.backbone.out_features": ["res2", "res3", "res4", "res5"],
    "model.maxtron.wc.enable": True, "model.maxtron.wc.nheads": 8,
    "model.maxtron.wc.dim_feedforward": 1024,
    "model.maxtron.wc.conv_dims": 256, "model.maxtron.wc.num_stages": 2,
    "model.maxtron.wc.spatial_layers": 2,
    "model.maxtron.wc.temporal_layers": 4,
    "model.maxtron.wc.temporal_attn_type": "axial_trajectory",
    "model.maxtron.wc.spatial_in_features": ["res3", "res4", "res5"],
    "model.maxtron.wc.temporal_in_features": ["res4", "res5"],
    "model.maxtron.wc.enc_n_points": 4,
    "model.maxtron.test.pixel_confidence_threshold": 0.3,
    "model.maxtron.test.class_threshold_stuff": 0.3,
    "model.maxtron.test.overlap_threshold": 0.8,
    "model.maxtron.test.reorder_class_weight": 1.0,
    "model.maxtron.test.reorder_mask_weight": 1.0,
    "model.maxtron.test.mem_weight": 0.0,
    "model.maxtron.test.cost_limit": 0.5,
    "model.kmax.pixel_dec.in_features": ["res2", "res3", "res4", "res5"],
    "model.kmax.pixel_dec.dec_layers": [1, 5, 1, 1],
    "model.kmax.pixel_dec.dec_channels": [512, 256, 128, 64],
    "model.kmax.pixel_dec.layer_types": ["axial", "axial", "bottleneck",
                                         "bottleneck"],
    "model.kmax.trans_dec.dec_layers": [2, 2, 2],
    "model.kmax.trans_dec.num_object_queries": 128,
}
OLD_TREES = {
    "wc_convnext_large_config": {
        **_WC, "input.pixel_mean": [123.675, 116.28, 103.53],
        "input.pixel_std": [58.395, 57.12, 57.375],
        "model.dtype": "bfloat16", "model.backbone.name": "convnext_large",
        "model.backbone.convnext.depths": [3, 3, 27, 3],
        "model.backbone.convnext.dims": [192, 384, 768, 1536],
        "model.backbone.convnext.layer_scale_init_value": 1e-06,
        "model.backbone.convnext.use_grn": False,
        "model.maxtron.test.class_threshold_thing": 0.1},
    "wc_r50_config": {
        **_WC, "input.pixel_mean": [127.5, 127.5, 127.5],
        "input.pixel_std": [127.5, 127.5, 127.5], "model.dtype": "float32",
        "model.backbone.name": "resnet50", "model.backbone.resnet.depth": 50,
        "model.maxtron.test.class_threshold_thing": 0.2},
    "tube_link_r50_config": {
        "input.num_clip_frames": 5, "model.meta_architecture": "TubeLinkVIS",
        "model.dtype": "bfloat16", "model.num_classes": 40,
        "model.backbone.name": "resnet50",
        "model.backbone.out_features": ["res2", "res3", "res4", "res5"],
        "model.backbone.resnet.depth": 50,
        "model.tube_link.num_queries": 100,
        "model.tube_link.feat_channels": 256,
        "model.tube_link.out_channels": 256,
        "model.tube_link.num_decoder_layers": 9,
        "model.tube_link.clip_len": 5, "model.tube_link.overlap": 0,
        "model.tube_link.use_temporal_attn": True,
        "model.tube_link.test_topk": 30},
}


@pytest.mark.parametrize("builder", list(OLD_TREES))
def test_smoke_builders_keep_the_old_fields(builder):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = getattr(smoke, builder)()
    assert isinstance(cfg, ConfigNode)
    old = OLD_TREES[builder]
    assert len(old) == {"wc_convnext_large_config": 37, "wc_r50_config": 34,
                        "tube_link_r50_config": 15}[builder]
    for path, value in old.items():
        node = cfg
        for key in path.split("."):
            node = node[key]
        assert node == value, path
