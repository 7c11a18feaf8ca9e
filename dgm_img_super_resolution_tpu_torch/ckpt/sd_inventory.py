"""Key and shape inventory of the published ``stabilityai/stable-diffusion-x4-upscaler``
(a copy of the JAX package's ``ckpt/sd_inventory.py``).

The three model configs and the two scheduler configs are the published
``config.json`` files of the x4-upscaler, reconstructed field by field; the
``*_state_dict_shapes`` functions enumerate the diffusers/transformers state
dict of each component by walking those configs the way the upstream
constructors name their modules. The port's SD modules
(``models/sd/{unet,vae,clip}.py``) use exactly these key names, so a state
dict enumerated here loads into them with ``strict=True``, and a published
checkpoint is a plain ``load_state_dict``.
"""

from __future__ import annotations

# --------------------------------------------------------------------- configs

# unet/config.json — UNet2DConditionModel
X4_UNET_CONFIG: dict = {
    "in_channels": 7,            # 4 latent + 3 LR-image channels
    "out_channels": 4,
    "block_out_channels": [256, 512, 512, 1024],
    "layers_per_block": 2,
    "down_block_types": [
        "DownBlock2D",           # highest res level: no attention
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    ],
    "up_block_types": [
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    ],
    # SD-era semantics: this is the HEAD COUNT (8), not the per-head width
    "attention_head_dim": 8,
    "cross_attention_dim": 1024,  # OpenCLIP-H text width
    # attn1 cross-attends (instead of self) on the three attn levels
    "only_cross_attention": [True, True, True, False],
    "num_class_embeds": 1000,     # LR noise-level conditioning table
    "norm_num_groups": 32,
    "use_linear_projection": True,  # Transformer2D proj_in/out are Linear
    "sample_size": 128,
}

# vae/config.json — AutoencoderKL (f=4: three levels, two halvings)
X4_VAE_CONFIG: dict = {
    "in_channels": 3,
    "out_channels": 3,
    "block_out_channels": [128, 256, 512],
    "layers_per_block": 2,
    "latent_channels": 4,
    "norm_num_groups": 32,
    "scaling_factor": 0.08333,
    # the published .bin/.safetensors predate the diffusers attention
    # rename: mid-block attention keys use the LEGACY AttentionBlock names
    # (group_norm/query/key/value/proj_attn), which this inventory and the
    # port's VAE use.
    "legacy_attention_keys": True,
}

# text_encoder/config.json — transformers CLIPTextModel (SD2 OpenCLIP-H text
# tower, penultimate layer ⇒ 23 stored hidden layers). hidden_act is exact
# "gelu" in the SD2 family (the SD1 OpenAI ViT-L tower uses "quick_gelu").
X4_TEXT_CONFIG: dict = {
    "vocab_size": 49408,
    "hidden_size": 1024,
    "intermediate_size": 4096,
    "num_hidden_layers": 23,
    "num_attention_heads": 16,
    "max_position_embeddings": 77,
    "hidden_act": "gelu",
    "layer_norm_eps": 1e-5,
}

# scheduler/scheduler_config.json — DDIMScheduler: the DENOISING schedule.
# The x4-upscaler is a V-PREDICTION model on the SD-standard latent betas
# (0.00085→0.012 scaled-linear) — NOT ε-prediction, and NOT the 0.0001→0.02
# image-space betas used only for LR noise augmentation below. Either mix-up
# produces garbage under real weights, which no shape test can catch; a
# checkpoint's own scheduler_config.json, where one is on disk, overrides
# this copy (``StableDiffusionUpscalePipeline(scheduler_config=...)``).
X4_SCHEDULER_CONFIG: dict = {
    "num_train_timesteps": 1000,
    "beta_start": 0.00085,
    "beta_end": 0.012,
    "beta_schedule": "scaled_linear",
    "prediction_type": "v_prediction",
    "clip_sample": False,
    "set_alpha_to_one": False,   # terminal ᾱ_prev = ᾱ_0, not 1
    "steps_offset": 1,           # "leading" timestep spacing starts at 1
}

# low_res_scheduler/scheduler_config.json — DDPMScheduler used ONLY to
# noise-augment the LR conditioning image to the requested noise_level
X4_LOW_RES_SCHEDULER_CONFIG: dict = {
    "num_train_timesteps": 1000,
    "beta_start": 0.0001,
    "beta_end": 0.02,
    "beta_schedule": "scaled_linear",
}


# ------------------------------------------------------------------ enumerators

def _lin(sd, name, o, i, bias=True):
    sd[f"{name}.weight"] = (o, i)
    if bias:
        sd[f"{name}.bias"] = (o,)


def _conv(sd, name, o, i, k=3):
    sd[f"{name}.weight"] = (o, i, k, k)
    sd[f"{name}.bias"] = (o,)


def _norm(sd, name, c):
    sd[f"{name}.weight"] = (c,)
    sd[f"{name}.bias"] = (c,)


def unet_state_dict_shapes(cfg: dict = X4_UNET_CONFIG) -> dict[str, tuple]:
    """Enumerate the diffusers UNet2DConditionModel state dict."""
    chs = list(cfg["block_out_channels"])
    lpb = cfg["layers_per_block"]
    cross = cfg["cross_attention_dim"]
    tdim = chs[0] * 4
    down_attn = ["CrossAttn" in t for t in cfg["down_block_types"]]
    up_attn = ["CrossAttn" in t for t in cfg["up_block_types"]]
    only_cross = list(cfg.get("only_cross_attention") or [False] * len(chs))
    sd: dict[str, tuple] = {}

    def resnet(prefix, cin, cout):
        _norm(sd, f"{prefix}.norm1", cin)
        _conv(sd, f"{prefix}.conv1", cout, cin)
        _lin(sd, f"{prefix}.time_emb_proj", cout, tdim)
        _norm(sd, f"{prefix}.norm2", cout)
        _conv(sd, f"{prefix}.conv2", cout, cout)
        if cin != cout:
            _conv(sd, f"{prefix}.conv_shortcut", cout, cin, 1)

    def transformer(prefix, ch, oc):
        inner = ch  # heads * (ch // heads)
        _norm(sd, f"{prefix}.norm", ch)
        _lin(sd, f"{prefix}.proj_in", inner, ch)  # use_linear_projection
        p = f"{prefix}.transformer_blocks.0"
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{p}.{n}", inner)
        kv1 = cross if oc else inner
        sd[f"{p}.attn1.to_q.weight"] = (inner, inner)
        sd[f"{p}.attn1.to_k.weight"] = (inner, kv1)
        sd[f"{p}.attn1.to_v.weight"] = (inner, kv1)
        _lin(sd, f"{p}.attn1.to_out.0", inner, inner)
        sd[f"{p}.attn2.to_q.weight"] = (inner, inner)
        sd[f"{p}.attn2.to_k.weight"] = (inner, cross)
        sd[f"{p}.attn2.to_v.weight"] = (inner, cross)
        _lin(sd, f"{p}.attn2.to_out.0", inner, inner)
        _lin(sd, f"{p}.ff.net.0.proj", inner * 8, inner)  # GEGLU: 2×4×
        _lin(sd, f"{p}.ff.net.2", inner, inner * 4)
        _lin(sd, f"{prefix}.proj_out", ch, inner)

    _conv(sd, "conv_in", chs[0], cfg["in_channels"])
    _lin(sd, "time_embedding.linear_1", tdim, chs[0])
    _lin(sd, "time_embedding.linear_2", tdim, tdim)
    if cfg.get("num_class_embeds"):
        sd["class_embedding.weight"] = (cfg["num_class_embeds"], tdim)

    cin = chs[0]
    for i, ch in enumerate(chs):
        for j in range(lpb):
            resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else ch, ch)
            if down_attn[i]:
                transformer(f"down_blocks.{i}.attentions.{j}", ch, only_cross[i])
        if i < len(chs) - 1:
            _conv(sd, f"down_blocks.{i}.downsamplers.0.conv", ch, ch)
        cin = ch

    resnet("mid_block.resnets.0", chs[-1], chs[-1])
    transformer("mid_block.attentions.0", chs[-1], False)
    resnet("mid_block.resnets.1", chs[-1], chs[-1])

    # up blocks: diffusers channel bookkeeping (prev/output/input channel)
    rev = chs[::-1]
    prev = rev[0]
    for i in range(len(chs)):
        out_ch = rev[i]
        in_ch = rev[min(i + 1, len(chs) - 1)]
        level = len(chs) - 1 - i
        for j in range(lpb + 1):
            skip = in_ch if j == lpb else out_ch
            rin = prev if j == 0 else out_ch
            resnet(f"up_blocks.{i}.resnets.{j}", rin + skip, out_ch)
            if up_attn[i]:
                transformer(f"up_blocks.{i}.attentions.{j}", out_ch, only_cross[level])
        if i < len(chs) - 1:
            _conv(sd, f"up_blocks.{i}.upsamplers.0.conv", out_ch, out_ch)
        prev = out_ch

    _norm(sd, "conv_norm_out", chs[0])
    _conv(sd, "conv_out", cfg["out_channels"], chs[0])
    return sd


def vae_state_dict_shapes(cfg: dict = X4_VAE_CONFIG) -> dict[str, tuple]:
    """Enumerate the diffusers AutoencoderKL state dict (legacy attention
    key style, as published)."""
    chs = list(cfg["block_out_channels"])
    lpb = cfg["layers_per_block"]
    lat = cfg["latent_channels"]
    sd: dict[str, tuple] = {}

    def resnet(prefix, cin, cout):
        _norm(sd, f"{prefix}.norm1", cin)
        _conv(sd, f"{prefix}.conv1", cout, cin)
        _norm(sd, f"{prefix}.norm2", cout)
        _conv(sd, f"{prefix}.conv2", cout, cout)
        if cin != cout:
            _conv(sd, f"{prefix}.conv_shortcut", cout, cin, 1)

    def attention(prefix, ch):
        if cfg.get("legacy_attention_keys", True):
            _norm(sd, f"{prefix}.group_norm", ch)
            for n in ("query", "key", "value", "proj_attn"):
                _lin(sd, f"{prefix}.{n}", ch, ch)
        else:
            _norm(sd, f"{prefix}.group_norm", ch)
            for n in ("to_q", "to_k", "to_v"):
                _lin(sd, f"{prefix}.{n}", ch, ch)
            _lin(sd, f"{prefix}.to_out.0", ch, ch)

    # encoder
    _conv(sd, "encoder.conv_in", chs[0], cfg["in_channels"])
    cin = chs[0]
    for i, ch in enumerate(chs):
        for j in range(lpb):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else ch, ch)
        if i < len(chs) - 1:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch)
        cin = ch
    resnet("encoder.mid_block.resnets.0", chs[-1], chs[-1])
    attention("encoder.mid_block.attentions.0", chs[-1])
    resnet("encoder.mid_block.resnets.1", chs[-1], chs[-1])
    _norm(sd, "encoder.conv_norm_out", chs[-1])
    _conv(sd, "encoder.conv_out", 2 * lat, chs[-1])

    # decoder (up_blocks.0 is the deepest level)
    rev = chs[::-1]
    _conv(sd, "decoder.conv_in", rev[0], lat)
    resnet("decoder.mid_block.resnets.0", rev[0], rev[0])
    attention("decoder.mid_block.attentions.0", rev[0])
    resnet("decoder.mid_block.resnets.1", rev[0], rev[0])
    prev = rev[0]
    for i, ch in enumerate(rev):
        for j in range(lpb + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", prev if j == 0 else ch, ch)
        if i < len(chs) - 1:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch)
        prev = ch
    _norm(sd, "decoder.conv_norm_out", chs[0])
    _conv(sd, "decoder.conv_out", cfg["out_channels"], chs[0])

    sd["quant_conv.weight"] = (2 * lat, 2 * lat, 1, 1)
    sd["quant_conv.bias"] = (2 * lat,)
    sd["post_quant_conv.weight"] = (lat, lat, 1, 1)
    sd["post_quant_conv.bias"] = (lat,)
    return sd


def text_encoder_state_dict_shapes(cfg: dict = X4_TEXT_CONFIG) -> dict[str, tuple]:
    """Enumerate the transformers CLIPTextModel state dict."""
    d, inter = cfg["hidden_size"], cfg["intermediate_size"]
    sd: dict[str, tuple] = {
        "text_model.embeddings.token_embedding.weight": (cfg["vocab_size"], d),
        "text_model.embeddings.position_embedding.weight": (
            cfg["max_position_embeddings"], d,
        ),
    }
    for i in range(cfg["num_hidden_layers"]):
        p = f"text_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, f"{p}.self_attn.{proj}", d, d)
        _norm(sd, f"{p}.layer_norm1", d)
        _norm(sd, f"{p}.layer_norm2", d)
        _lin(sd, f"{p}.mlp.fc1", inter, d)
        _lin(sd, f"{p}.mlp.fc2", d, inter)
    _norm(sd, "text_model.final_layer_norm", d)
    return sd


# keys that may appear in published files but carry no parameters
IGNORABLE_KEYS = {
    "text_model.embeddings.position_ids",  # buffer saved by old transformers
}
