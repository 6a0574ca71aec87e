"""sam3_lora_tpu_torch: the PyTorch/CUDA port of ``sam3_lora_tpu``.

The serving path (text-prompted inference) and the LoRA training step run in
PyTorch, with the bf16 or the int8 frozen base; the attention of the ViT and
the fusion encoder and the int8 GEMMs run hand-written CUDA kernels
(``csrc/``). The package imports neither JAX nor anything of the JAX
package: it keeps its own copies of the config dataclasses, the BPE
tokenizer and the host codecs it needs.
"""

__version__ = "0.1.0"
