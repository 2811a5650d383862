"""The benchmark's configuration files in the program's terms.

The only module of the harness that names the port's configuration classes:
a configuration file (dust3r's keys) becomes a
thermal3d_torch.core.config.DustrModelConfig computing in the file's dtype.
"""

from __future__ import annotations


def _mode(mode):
    kind, lo, hi = mode
    return (kind, float(lo), float(hi))


def model_config(cfg):
    from thermal3d_torch.core.config import DustrModelConfig, HeadConfig

    head = dict(head_type=cfg["head_type"], depth_mode=_mode(cfg["depth_mode"]),
                conf_mode=_mode(cfg["conf_mode"]))
    if cfg["head_type"] != "linear":
        head.update(feature_dim=cfg["feature_dim"], last_dim=cfg["last_dim"],
                    dpt_layer_dims=tuple(cfg["dpt_layer_dims"]))
    if cfg["head_type"] == "catmlpdpt":
        head.update(local_feat_dim=cfg["local_feat_dim"], two_confs=cfg["two_confs"],
                    desc_conf_mode=_mode(cfg["desc_conf_mode"]),
                    desc_hidden_dim_factor=float(cfg["desc_hidden_dim_factor"]))
    rope_base = float(cfg.get("pos_embed", "RoPE100").removeprefix("RoPE"))
    return DustrModelConfig(
        img_size=tuple(cfg["img_size"]), patch_size=cfg["patch_size"],
        enc_embed_dim=cfg["enc_embed_dim"], enc_depth=cfg["enc_depth"],
        enc_num_heads=cfg["enc_num_heads"], dec_embed_dim=cfg["dec_embed_dim"],
        dec_depth=cfg["dec_depth"], dec_num_heads=cfg["dec_num_heads"],
        mlp_ratio=float(cfg["mlp_ratio"]), rope_base=rope_base,
        head=HeadConfig(**head), compute_dtype=cfg["dtype"])
