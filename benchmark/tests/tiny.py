"""A cell's files cut to the tiny model and a handful of small images, so
that a whole run (set-up, window, the reference's check) fits a CPU test."""

from __future__ import annotations


TINY_MODEL = dict(
    img_size=56, patch_size=14, vit_dim=32, vit_depth=4, vit_heads=2, vit_mlp_ratio=4.0,
    vit_window_size=2, vit_global_blocks=[1, 3], vit_pretrain_img_size=28, d_model=32,
    text_width=32, text_layers=2, text_heads=2, text_context_length=8, text_proj_dim=16,
    enc_layers=2, enc_heads=2, enc_ffn_dim=64, dec_layers=2, dec_heads=2, dec_ffn_dim=64,
    num_queries=12, geo_layers=1, score_mlp_hidden=64, mask_loss_resolution=16, max_targets=5,
    base_quant_min_dim=16, dtype="float32", param_dtype="float32",
)
SIZES = [[64, 48], [40, 72]]


def tiny(files, **model):
    """Cut ``files`` (``harness.cell_files``) in place; ``model`` overrides
    more fields of the model."""
    files["config"]["model"].update(TINY_MODEL, **model)
    t = files["traffic"]
    t["sizes"] = SIZES
    if t["entry"] == "train":
        t.update(batch_size=2, images=8)
    else:
        t.update(pool=6, check_among_first=4)
        t["check_requests" if t["entry"] == "predict" else "check_sessions"] = 2
        if t["entry"] == "processor":
            t.update(prompts_per_session=3, calibrate=2)
    return files
