"""Default configuration tree (the port's own copy of
``axial_vs_tpu/config/defaults.py``; ``tests/test_torch_config.py`` holds
the two equal).

Mirrors the reference's programmatic defaults
(`MaXTron_Video-kMaX/kmax_deeplab/config.py:5-138` and
`MaXTron_Video-kMaX/maxtron_deeplab/config.py:5-70`) in one pythonic tree.
"""
from .node import ConfigNode


def get_default_config() -> ConfigNode:
    cfg = ConfigNode()

    # ----- input ------------------------------------------------------------
    cfg.input = ConfigNode(
        dict(
            image_size=[1281, 1281],  # INPUT.IMAGE_SIZE (h, w); padded fixed shape
            min_scale=0.2,
            max_scale=2.0,
            num_video_frames=24,  # INPUT.NUM_VIDEO_FRAMES (training clip length)
            num_clip_frames=2,  # INPUT.NUM_CLIP_FRAMES (inference clip window)
            random_reverse=False,
            # copy-paste augmentation (the reference's default COCO/VIPSeg
            # pretrain recipe; *_nocopypaste leafs set this False)
            copy_paste=True,
            augmentations=[],
            pixel_mean=[123.675, 116.28, 103.53],
            pixel_std=[58.395, 57.12, 57.375],
            # "auto": resolve from meta-arch + train dataset family
            # (data/build.py::resolve_mapper_name); explicit names override
            dataset_mapper_name="auto",
        )
    )

    # ----- model ------------------------------------------------------------
    model = ConfigNode()
    model.meta_architecture = "KMaXDeepLab"
    model.weights = ""
    model.num_classes = 133  # without void
    model.num_things = None  # VPS: thing-class count (None -> all things)
    model.dtype = "float32"  # compute dtype: float32 | bfloat16

    model.backbone = ConfigNode(
        dict(
            name="resnet50",
            out_features=["res2", "res3", "res4", "res5"],
            remat=False,  # checkpoint backbone blocks during training
            # resnet
            resnet=ConfigNode(dict(depth=50, norm="syncbn", stem_type="basic")),
            # convnext (kmax config: CONVNEXT.*)
            convnext=ConfigNode(
                dict(
                    depths=[3, 3, 27, 3],
                    dims=[192, 384, 768, 1536],
                    drop_path_rate=0.6,
                    layer_scale_init_value=1e-6,
                    use_grn=False,  # True -> ConvNeXtV2
                    use_scan=False,  # nn.scan blocks/stage (fast compile -L)
                    scan_unroll=3,  # blocks inlined per scan iteration
                )
            ),
            swin=ConfigNode(
                dict(
                    pretrain_img_size=224,
                    patch_size=4,
                    embed_dim=96,
                    depths=[2, 2, 6, 2],
                    num_heads=[3, 6, 12, 24],
                    window_size=7,
                    mlp_ratio=4.0,
                    qkv_bias=True,
                    drop_path_rate=0.3,
                    ape=False,
                    patch_norm=True,
                )
            ),
            # ViTAEv2 with Varied-Size-window Attention (vitaev2_vsa.py:62);
            # defaults = ViTAEv2-S
            vitae=ConfigNode(
                dict(
                    embed_dims=[64, 64, 64, 64],
                    token_dims=[64, 128, 256, 512],
                    nc_depths=[2, 2, 6, 2],
                    nc_heads=[4, 4, 4, 4],
                    nc_groups=[1, 32, 64, 64],
                    rc_heads=[1, 1, 1, 1],
                    window_size=7,
                    mlp_ratio=4.0,
                    wide_pcm=False,
                    drop_path_rate=0.1,
                )
            ),
        )
    )

    # kMaX-DeepLab head (KMAX_DEEPLAB.*)
    model.kmax = ConfigNode(
        dict(
            share_final_matching=True,
            channel_last_format=True,  # NHWC throughout
            deep_supervision=True,
            no_object_weight=1e-5,
            class_weight=3.0,
            dice_weight=3.0,
            mask_weight=0.3,
            insdis_weight=1.0,
            aux_semantic_weight=1.0,
            use_aux_semantic_decoder=True,
            pixel_insdis_temperature=1.5,
            pixel_insdis_sample_k=4096,
            aux_semantic_temperature=2.0,
            aux_semantic_sample_k=4096,
            masking_void_pixel=True,
            pixel_dec=ConfigNode(
                dict(
                    name="kMaXPixelDecoder",
                    in_features=["res2", "res3", "res4", "res5"],
                    dec_layers=[1, 5, 1, 1],
                    layer_types=["axial", "axial", "bottleneck", "bottleneck"],
                    dec_channels=[512, 256, 128, 64],
                    drop_path_prob=0.0,
                )
            ),
            trans_dec=ConfigNode(
                dict(
                    name="kMaXTransformerDecoder",
                    dec_layers=[2, 2, 2],
                    num_object_queries=128,
                    in_channels=[2048, 1024, 512],
                    drop_path_prob=0.0,
                )
            ),
            test=ConfigNode(
                dict(
                    semantic_on=False,
                    instance_on=False,
                    panoptic_on=True,
                    pixel_confidence_threshold=0.4,
                    class_threshold_thing=0.7,
                    class_threshold_stuff=0.5,
                    reorder_class_weight=1.0,
                    reorder_mask_weight=1.0,
                    overlap_threshold=0.8,
                    test_topk_per_image=100,
                )
            ),
        )
    )

    # MaXTron video modules (MAXTRON.*)
    model.maxtron = ConfigNode(
        dict(
            wc=ConfigNode(  # WITHIN_CLIP_TRACKING_MODULE
                dict(
                    enable=False,
                    nheads=8,
                    dim_feedforward=1024,
                    conv_dims=256,
                    dropout=0.0,
                    attn_drop=0.0,
                    spatial_in_features=["res3", "res4", "res5"],
                    temporal_in_features=["res4", "res5"],
                    num_stages=2,
                    spatial_layers=2,
                    temporal_layers=4,
                    temporal_attn_type="axial_trajectory",
                    enc_n_points=4,
                )
            ),
            cc=ConfigNode(  # CROSS_CLIP_TRACKING_MODULE
                dict(
                    enable=False,
                    num_layers=6,
                    attn_drop=0.0,
                    aspp_drop=0.0,
                    kernel_sizes=[3, 3, 3],
                    atrous_rates=[1, 2, 3],
                    norm_fn="ln",
                )
            ),
            test=ConfigNode(
                dict(
                    pixel_confidence_threshold=0.3,
                    class_threshold_thing=0.1,
                    class_threshold_stuff=0.3,
                    overlap_threshold=0.8,
                    reorder_class_weight=1.0,
                    reorder_mask_weight=1.0,
                    inference_type="clip-wise",  # clip-wise | video-wise
                    post_processing_type="mask-wise",
                    mem_weight=0.0,
                    cost_limit=0.5,
                )
            ),
        )
    )
    # Tube-Link (Mask2Former VIS/VPS) recipe
    model.tube_link = ConfigNode(
        dict(
            num_queries=100,
            feat_channels=256,
            out_channels=256,
            num_decoder_layers=9,
            clip_len=5,
            overlap=0,
            use_temporal_attn=True,
            test_topk=30,
            cls_weight=2.0,
            mask_weight=5.0,
            dice_weight=5.0,
            bg_cls_weight=0.1,
            num_points=12544,
        )
    )
    cfg.model = model

    # ----- solver -----------------------------------------------------------
    cfg.solver = ConfigNode(
        dict(
            optimizer="adamw",
            base_lr=1e-4,
            weight_decay=0.05,
            weight_decay_embed=0.05,
            backbone_multiplier=0.1,
            spatial_multiplier=1.0,
            temporal_multiplier=2.0,
            prediction_head_multiplier=0.1,
            max_iter=60000,
            warmup_iters=1500,
            poly_power=0.9,
            clip_gradients=ConfigNode(dict(enabled=True, clip_value=0.01)),
            # ConvNeXt layer-wise LR decay
            # (mmdet LearningRateDecayOptimizerConstructor, T16)
            layer_decay=ConfigNode(dict(
                enabled=False, decay_rate=0.9, num_layers=12,
                decay_type="layer_wise",
            )),
            ims_per_batch=8,
            checkpoint_period=10000,
        )
    )

    # ----- dataloader / datasets -------------------------------------------
    cfg.datasets = ConfigNode(dict(train=[], test=[]))
    cfg.dataloader = ConfigNode(dict(num_workers=4, prefetch=2, seed=0))

    # ----- test -------------------------------------------------------------
    cfg.test = ConfigNode(dict(eval_period=5000, dynamic_eval_intervals=[]))

    # ----- parallel / runtime ----------------------------------------------
    cfg.parallel = ConfigNode(
        dict(
            mesh_axes=["data"],
            mesh_shape=[-1],  # -1 -> all devices
        )
    )
    cfg.output_dir = "./output"
    cfg.seed = 0

    return cfg
