"""The tiny preset of `mplug-base` for the CPU tests, registered in
`tiny.CONFIGS` when a test module imports this one (the harness's shared
tests look presets up there by configuration name): a few units of width
and depth in float32, 128 px images in 8 px patches (257 visual tokens),
so that every attention path of the program runs, the mid-length
kernel's plain version included (4 heads x 257 keys > 1024), with one
stride layer in the fusion encoder."""
from portbench.tests import tiny

CONFIG = dict(image_res=128, patch_size=8, vision_width=32, vision_layers=2,
              vision_heads=4, vocab_size=128, hidden_size=32,
              num_attention_heads=4, intermediate_size=64,
              text_encoder_layers=2, fusion_layers=4, text_decode_layers=2,
              stride_layer=3, max_position_embeddings=64, dtype="float32")

tiny.CONFIGS.setdefault("mplug-base", CONFIG)
