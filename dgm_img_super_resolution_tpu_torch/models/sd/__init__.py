"""The SD x4-upscaler: text-conditioned UNet, f=4 VAE, CLIP text tower and
their serving pipeline, under the published diffusers/transformers names."""
