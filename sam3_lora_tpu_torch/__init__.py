"""sam3_lora_tpu_torch: the PyTorch/CUDA port of ``sam3_lora_tpu``.

The serving path (text-prompted inference) runs in PyTorch; the attention of
the ViT and the fusion encoder runs a hand-written CUDA kernel
(``csrc/attention_fwd.cu``). The package never imports JAX; it reuses the
JAX package's jax-free ``config`` module and BPE tokenizer.
"""

__version__ = "0.1.0"
